"""The port's ``v2_fork`` train step against rave_tpu's.

Four steps from one converted initial state, with the step counter at
``phase_1_duration`` (D, G, G, G), at a tiny width with the real
``univnet`` + ``melgan_stack`` discriminators, the frozen speaker encoder,
unit CE and the valid-signal crop.

Tolerances: metrics rtol 1e-4 each step (float32 through ~80 convs and
three STFTs, sums in another order).  Parameters after the four steps:
Adam's normalised update moves an element by about ``lr`` whatever the
size of its gradient, so gradient rounding reaches the parameters at
full scale where a gradient is small.  The MR-STFT log-magnitude
gradient divides by ``|s|``, which leaves a relative error of about 1e-3
in float32 in both frameworks (against float64,
``tests/test_torch_stft_losses.py``).  So every tensor's update
(after - before) is held to 10% of the JAX update's 2-norm (the largest
seen is 4%), and every element to 3 ``lr`` per step taken.  The
encoder's last bias is exempt from the relative check: the CE
projection's LayerNorm over time removes any per-channel constant, so no
loss sees it, its gradient is rounding noise in both frameworks, and
Adam moves it by about ``lr`` either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.train import loop, schedules

TINY = ["capacity=4", "n_signal=8192", "batch_size=2", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("stack", [["v2"], ["v2_fork"], ["v2_fork", "causal"]])
def test_receptive_field_frames_match(stack):
    assert (loop.receptive_field_frames(build_config(stack))
            == jloop.receptive_field_frames(jbuild(stack)))


def test_metric_names_and_schedules_match():
    for stack in (["v2"], ["v2_fork"]):
        assert (loop._metric_names(build_config(stack))
                == jloop._metric_names(jbuild(stack)))
    cfg = build_config(["v2_fork"])
    from rave_tpu.train import schedules as jsched
    for step in (0, 99_999, 100_000, 100_001, 100_004):
        assert schedules.is_discriminator_step(step, cfg) == bool(
            jsched.is_discriminator_step(step, jbuild(["v2_fork"])))
        assert schedules.beta_factor(step, cfg) == pytest.approx(
            float(jsched.beta_factor(step, jbuild(["v2_fork"]))), rel=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, jstate, step):
    state = loop.TrainState(cfg, device="cpu", step=step)
    load_flax_params(state.model, _np(jstate.gen_params),
                     _np(jstate.model_state["batch_stats"]))
    load_discriminator_params(state.disc, _np(jstate.dis_params))
    return state


def _named(state):
    return {**{"gen/" + k: v for k, v in state.model.state_dict().items()},
            **{"dis/" + k: v for k, v in state.disc.state_dict().items()}}


def test_fork_train_steps_match():
    jcfg, cfg = jbuild(["v2_fork"], TINY), build_config(["v2_fork"], TINY)
    assert cfg.valid_signal_crop
    start = cfg.phase_1_duration
    jstate = jloop.init_state(jcfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(step=jnp.asarray(start, jnp.int32))
    state = _port_state(cfg, jstate, start)
    before = {k: v.clone() for k, v in _named(state).items()}

    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((2, cfg.n_signal, 1))).astype(np.float32)
    units = rng.integers(0, cfg.hubert_units, (2, 148))
    jstep = jax.jit(jloop.make_train_step(jcfg))
    step = loop.make_train_step(cfg)
    batch = {"x": torch.from_numpy(x), "units": torch.from_numpy(units)}
    kinds = []
    for i in range(4):
        kinds.append("D" if schedules.is_discriminator_step(state.step, cfg)
                     else "G")
        jstate, mj = jstep(jstate, {"x": jnp.asarray(x),
                                    "units": jnp.asarray(units)},
                           jax.random.PRNGKey(1))
        mt = step(state, batch)
        mj = {k: float(v) for k, v in mj.items()}
        assert sorted(mt) == sorted(mj)
        for k in mj:
            assert float(mt[k]) == pytest.approx(mj[k], rel=1e-4, abs=1e-7), (
                i, k, float(mt[k]), mj[k])
        assert all(np.isfinite(float(v)) for v in mt.values())
    assert kinds == ["D", "G", "G", "G"] and state.step == start + 4

    # parameters after the four steps, held against the JAX ones
    want = _named(_port_state(cfg, jstate, start))
    got = _named(state)
    lr = cfg.learning_rate
    last = len(state.model.encoder.layers) - 1
    invisible = f"gen/encoder.layers.{last}.1.bias"
    worst = []
    for k in got:
        if not got[k].is_floating_point():
            continue
        steps = 1 if k.startswith("dis/") else 3
        d_got, d_want = got[k] - before[k], want[k] - before[k]
        err = float((d_got - d_want).abs().max())
        assert err <= 3 * lr * steps, (k, err / lr)
        scale = float(d_want.norm())
        if scale == 0:
            assert float(d_got.norm()) == 0, k
            continue
        rel = float((d_got - d_want).norm()) / scale
        worst.append((rel, err / lr, k))
        assert k == invisible or rel <= 0.1, (k, rel, err / lr)
    worst.sort(reverse=True)
    print("largest update differences (relative 2-norm, max / lr, tensor):",
          worst[:4])
    # each group moved, and the frozen speaker encoder did not
    moved = lambda pre: any(not torch.equal(got[k], before[k])  # noqa: E731
                            for k in got if k.startswith(pre))
    assert moved("gen/encoder.") and moved("gen/decoder.")
    assert moved("gen/ce_projection.") and moved("dis/")
    assert not moved("gen/speaker_encoder.")
