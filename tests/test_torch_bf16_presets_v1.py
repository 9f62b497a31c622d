"""The port's bf16 ``v1`` and ``onnx`` train steps against rave_tpu's bf16
step (``tests/test_torch_bf16_step_pairs.py``: one D step and one G step
from one converted state, the JAX draws handed over, the float32 port as
the control).

``v1``: EncoderV1's BatchNorms in train mode, GeneratorV1's noise
branch, the multi-scale discriminator and the hinge loss.  ``onnx``: the
same without the noise branch.  Both at capacity 4, as every case of
these files: ``raspberry`` is ``onnx`` at capacity 16, so at this width
the two presets are one configuration.  From capacity 16 on, the v1
family's bf16 gradients are chaotic: two bf16 runs of the JAX package
itself, with XLA's excess precision off and on, differ by 38 % in the
ENC gradient at capacity 32 (ROADMAP C), so a wider case would hold
nothing.

Tolerances: relative L2 distances from the JAX bf16 step, the largest
over both steps (measured: bf16 port / float32 port).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_bf16_step_pairs as P  # noqa: E402

V1 = ["capacity=4", "n_signal=8192", "batch_size=2", "ratios=[2,2]",
      "latent_size=8", "learning_rate=1e-6", "log_epsilon=1e-3",
      "phase_1_duration=0"]
CASES = {"v1": (["v1"], V1), "onnx": (["onnx"], V1)}
TOL = {
    "v1": {"losses": 1e-3,        # 4.0e-5 / 5.1e-3
           "grad_dis": 1e-2,      # 2.8e-3 / 2.8e-2
           "grad_enc": 5e-2,      # 5.8e-3 / 0.35
           "grad_dec": 7e-3},     # 1.7e-3 / 2.0e-2
    "onnx": {"losses": 1e-3,      # 4.3e-6 / 5.1e-3
             "grad_dis": 1e-2,    # 2.4e-3 / 2.7e-2
             "grad_enc": 5e-2,    # 3.9e-3 / 0.61
             "grad_dec": 7e-3},   # 1.6e-3 / 2.0e-2
}

(_one_thread, pairs, test_bf16_steps_are_d_g_and_finite,
 test_bf16_step_matches_jax_bf16) = P.make_tests(CASES, TOL)
