"""The port's bf16 ``v2_fork`` + ``pitch`` and from-scratch ``v2_fork``
train steps against rave_tpu's bf16 step
(``tests/test_torch_bf16_step_pairs.py``: one D step and one G step from
one converted state, the float32 port as the control; the fork draws
nothing).

``v2_fork_pitch``: the f0-conditioned decoder, the batch carrying each
row's speaker statistics (``f0_median``, ``f0_std``).
``v2_fork_scratch``: ``train_speaker_encoder`` with the AAM speaker CE
and the latent adversary (``speaker_classes=4``,
``latent_adversary_weight=0.5``) at four rows of four speakers (at two
rows the cohort norm maps every embedding to +-1), its SPK group at
``speaker_learning_rate=1e-6``.  Both judged by the small multi-scale
discriminator: the fork's own ``univnet`` + ``melgan_stack`` bf16 step is
``tests/test_torch_bf16_train.py``'s.

Tolerances: relative L2 distances from the JAX bf16 step, the largest
over both steps (measured: bf16 port / float32 port).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_bf16_step_pairs as P  # noqa: E402

CASES = {
    "v2_fork_pitch": (["v2_fork", "pitch"], P.TINY + P.SMALL_DIS),
    "v2_fork_scratch": (["v2_fork"], P.TINY + P.SMALL_DIS + [
        "batch_size=4", "train_speaker_encoder=true", "speaker_classes=4",
        "latent_adversary_weight=0.5", "speaker_learning_rate=1e-6"]),
}
TOL = {
    "v2_fork_pitch": {"losses": 1e-3,      # 7.9e-7 / 8.0e-2
                      "grad_dis": 5e-4,    # 2.0e-5 / 5.1e-3
                      "grad_enc": 1e-2,    # 1.7e-3 / 5.1e-2
                      "grad_dec": 3e-2},   # 7.4e-3 / 0.14
    "v2_fork_scratch": {"losses": 3e-3,      # 2.2e-4 / 5.6e-2
                        "grad_dis": 1e-3,    # 2.3e-4 / 3.6e-3
                        "grad_enc": 1e-2,    # 1.5e-3 / 0.11
                        "grad_dec": 2.3e-2,  # 9.2e-3 / 5.6e-2
                        "grad_spk": 5e-3},   # 6.5e-4 / 5.1e-2
}

(_one_thread, pairs, test_bf16_steps_are_d_g_and_finite,
 test_bf16_step_matches_jax_bf16) = P.make_tests(CASES, TOL)
