"""The port's bf16 ``v2`` and ``v2`` + ``noise`` + ``wasserstein`` train
steps against rave_tpu's bf16 step
(``tests/test_torch_bf16_step_pairs.py``: one D step and one G step from
one converted state, the JAX draws handed over, the float32 port as the
control).

``v2`` runs its own discriminator (periods, scales and the spectral
member at scales 512 and 256); the Wasserstein head runs the small
multi-scale discriminator, as its difference from ``v2`` lies in the
generator.  It takes the JAX step's reference and augmentation draws,
the noise branch its uniform draw.

Tolerances: relative L2 distances from the JAX bf16 step, the largest
over both steps (measured: bf16 port / float32 port).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_bf16_step_pairs as P  # noqa: E402

TINY = P.TINY
CASES = {
    "v2": (["v2"], TINY + ["discriminator.spectral_scales=[512,256]"]),
    "v2_noise_wasserstein": (["v2", "noise", "wasserstein"],
                             TINY + ["noise_augmentation=8"] + P.SMALL_DIS),
}
TOL = {
    "v2": {"losses": 7e-4,          # 2.4e-4 / 1.4e-3
           "grad_dis": 1.6e-2,      # 9.1e-3 / 3.0e-2
           "grad_enc": 1e-2,        # 3.5e-3 / 3.1e-2
           "grad_dec": 5e-3},       # 2.3e-3 / 1.1e-2
    "v2_noise_wasserstein": {"losses": 5e-4,       # 6.4e-5 / 2.0e-3
                             "grad_dis": 3e-3,     # 6.2e-4 / 1.1e-2
                             "grad_enc": 8e-3,     # 1.9e-3 / 3.8e-2
                             "grad_dec": 3e-3},    # 6.4e-4 / 1.1e-2
}

(_one_thread, pairs, test_bf16_steps_are_d_g_and_finite,
 test_bf16_step_matches_jax_bf16) = P.make_tests(CASES, TOL)
