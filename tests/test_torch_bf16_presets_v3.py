"""The port's bf16 ``v3``, ``discrete`` and ``discrete_v3`` train steps
against rave_tpu's bf16 step (``tests/test_torch_bf16_step_pairs.py``:
one D step and one G step from one converted state, the JAX draws handed
over, the float32 port as the control).

``v3``: AdaIN and Snake in the generator; ``discrete``: the RVQ head, its
codebooks seeded by k-means on the step's rows (the JAX package's row
draw patched to the port's sampler) and moved by their EMA in D and G
steps alike; ``discrete_v3``: both.  Each judged by the small
multi-scale discriminator: the Descript discriminator of ``v3`` is held
member by member in bf16 by ``tests/test_torch_bf16_disc.py``, and in a
whole step here it would lengthen the JAX compile by minutes.  The RVQ's
ENC gradient is the least stable of these: where a latent frame sits
near two codes, a rounding picks either (1.7e-1 from the JAX run in bf16
against 0.84 for the float32 port).

Tolerances: relative L2 distances from the JAX bf16 step, the largest
over both steps (measured: bf16 port / float32 port).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_bf16_step_pairs as P  # noqa: E402

DISC = ["latent_size=8", "num_quantizers=2", "codebook_size=32",
        "valid_signal_crop=false", "stft_scales=[512,256,128]"]
CASES = {
    "v3": (["v3"], P.TINY + ["latent_size=8"] + P.SMALL_DIS),
    "discrete": (["discrete"], P.TINY + DISC + P.SMALL_DIS),
    "discrete_v3": (["discrete_v3"], P.TINY + DISC + P.SMALL_DIS),
}
TOL = {
    "v3": {"losses": 2e-4,          # 6.4e-6 / 1.7e-3
           "grad_dis": 2e-3,        # 3.7e-4 / 1.2e-2
           "grad_enc": 5e-3,        # 2.0e-3 / 1.1e-2
           "grad_dec": 4.5e-3},     # 2.3e-3 / 8.8e-3
    "discrete": {"losses": 2e-2,    # 2.6e-3 / 0.12
                 "grad_dis": 2.5e-3,  # 8.4e-4 / 5.3e-3
                 "grad_enc": 0.4,   # 0.17 / 0.84
                 "grad_dec": 3.2e-2},  # 2.2e-2 / 4.4e-2
    "discrete_v3": {"losses": 1e-3,       # 1.1e-5 / 2.8e-2
                    "grad_dis": 1.5e-3,   # 2.1e-4 / 6.0e-3
                    "grad_enc": 2e-2,     # 2.3e-3 / 0.17
                    "grad_dec": 5e-3},    # 2.9e-3 / 7.9e-3
}

(_one_thread, pairs, test_bf16_steps_are_d_g_and_finite,
 test_bf16_step_matches_jax_bf16) = P.make_tests(CASES, TOL)
