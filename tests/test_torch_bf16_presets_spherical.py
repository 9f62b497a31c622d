"""The port's bf16 ``v2`` + ``spherical`` train step, without and with
``causal``, against rave_tpu's bf16 step
(``tests/test_torch_bf16_step_pairs.py``: one D step and one G step from
one converted state, the float32 port as the control; the spherical head
draws nothing).

Both judged by the small multi-scale discriminator, as the head's
difference from ``v2`` lies in the generator.  The spherical head's ENC
gradient is the least stable of the presets: a unit-norm latent divides
by small norms (1.8e-1 from the JAX run in bf16 against 1.6 for the
float32 port); with ``causal`` padding it holds to 4.4e-3.

Tolerances: relative L2 distances from the JAX bf16 step, the largest
over both steps (measured: bf16 port / float32 port).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_bf16_step_pairs as P  # noqa: E402

TINY = P.TINY
CASES = {
    "v2_spherical": (["v2", "spherical"], TINY + P.SMALL_DIS),
    "v2_spherical_causal": (["v2", "spherical", "causal"],
                            TINY + P.SMALL_DIS),
}
TOL = {
    "v2_spherical": {"losses": 1e-3,       # 3.9e-6 / 6.2e-2
                     "grad_dis": 1e-3,     # 1.1e-6 / 1.5e-2
                     "grad_enc": 0.5,      # 0.18 / 1.6
                     "grad_dec": 5e-2},    # 2.7e-2 / 8.6e-2
    "v2_spherical_causal": {"losses": 1e-3,       # 6.7e-7 / 8.5e-2
                            "grad_dis": 1e-3,     # 4.9e-6 / 4.3e-2
                            "grad_enc": 5e-2,     # 4.4e-3 / 0.85
                            "grad_dec": 1.5e-2},  # 4.9e-3 / 4.6e-2
}

(_one_thread, pairs, test_bf16_steps_are_d_g_and_finite,
 test_bf16_step_matches_jax_bf16) = P.make_tests(CASES, TOL)
