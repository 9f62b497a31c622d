"""The port's from-scratch speaker training with ``speaker_norm=batch``
against rave_tpu's train step: the BatchNorms run on batch statistics
and advance their running ones in D and G steps alike (flax's momentum
0.99 and fast variance), and those statistics equal JAX's after each of
the four steps.  The runner and the tolerances are
``tests/test_torch_speaker_train.py``'s; this file stands alone so that
its JAX compile lands on another worker.
"""
import torch

from rave_tpu_torch.config import build_config
from rave_tpu_torch.train import loop
from test_torch_speaker_train import (SPK, TINY, check_updates,  # noqa: F401
                                      one_thread, run_speaker_parity)


def test_batchnorm_speaker_train_steps_match():
    cfg, state, before, want = run_speaker_parity(["speaker_norm=batch"])
    check_updates(cfg, state, before, want)


def test_eval_step_uses_the_running_statistics():
    """The eval step runs the model with ``train_mode`` off: stored
    statistics, which it leaves as they were, and the train mode back on
    after it."""
    cfg = build_config(["v2_fork"], TINY + SPK + ["speaker_norm=batch"])
    torch.manual_seed(0)
    state = loop.TrainState(cfg, device="cpu")
    spk = state.model.speaker_encoder
    assert spk.train_bn
    stats = {k: v.clone() for k, v in spk.state_dict().items()
             if ".running_" in k}
    x = 0.1 * torch.randn(4, cfg.n_signal, 1)
    metrics, y, _ = loop.make_eval_step(cfg)(state, {"x": x})
    assert torch.isfinite(metrics["validation"]) and y.shape == x.shape
    assert all(torch.equal(spk.state_dict()[k], v) for k, v in stats.items())
    assert spk.train_bn
