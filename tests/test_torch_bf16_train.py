"""The port's bf16 ``v2_fork`` train step against rave_tpu's bf16 step.

Four steps from one converted initial state, with the step counter at
``phase_1_duration`` (D, G, G, G), at a tiny width with the real
``univnet`` + ``melgan_stack`` discriminators, the frozen speaker
encoder, unit CE and the valid-signal crop, ``compute_dtype=bfloat16``,
``learning_rate`` 1e-6 and ``log_epsilon`` 1e-3.  The JAX step is
compiled once, with XLA's excess precision off (on the CPU, XLA
otherwise drops a bf16 rounding where a value is widened again, as the
float32 STFT cast to bf16 before the discriminators' first convs, so
that the bf16 program is not what it says; ROADMAP C).  Its gradients are read back from its Adam first moments
(``mu_t = b1 mu_{t-1} + (1 - b1) g_t``) and converted into the port's
layout; the port's are the ones it hands its optimizers.

Compared, each against the JAX bf16 step: the losses of every step; the
gradient of every group that steps (DIS on the D step, ENC and DEC on
the G steps), as the relative L2 distance of the whole vector, which
bounds the distance of its norm; and each group's update over the four
steps (the parameters after less those before); and the eval step of
the initial state against the JAX bf16 eval step.  Each tolerance sits
between the bf16 port's distance and the float32 port's (same
parameters, same batch): the bf16 port within it, the float32 port
beyond it.

The biases are left out of the gradients and the updates: XLA on the
CPU sums a bf16 bias gradient (the transpose of ``y + bias``'s
broadcast) in bf16, so a bias that sees many outputs loses most of its
gradient (the score bias of ``mrd2``: 1.25 against 2.39 summed in
float32; the port's ``sum_to_size``, on the CPU and on the card, sums in
float32; ROADMAP C).  ``tests/test_torch_bf16_disc.py`` holds every
discriminator member's bias gradients, and
``tests/test_torch_residual_unit.py`` B1's, against the float32 sum of
the JAX bf16 cotangent instead.  What else keeps the bf16 port off the JAX run:
bf16 rounds where the two frameworks sum in another order (a flip of
one rounding now and then, which the discriminator's ~40 bf16 convs
carry on), and Adam's first updates move each element by about the
learning rate whatever the size of its gradient, so an element whose
gradient is near zero may move either way.
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
        "dilations=[[1,3],[1,3]]", "learning_rate=1e-6", "log_epsilon=1e-3"]
BF16 = TINY + ["compute_dtype=bfloat16"]
# relative distance from the JAX bf16 step, the bf16 port within and the
# float32 port beyond (PyTorch on one thread; the largest over the steps;
# measured: bf16 port / float32 port)
TOL = {"losses": 5e-3,       # 4.1e-4 / 8.0e-2
       "grad_enc": 2e-2,     # 7.5e-3 / 6.5e-2
       "grad_dec": 2e-2,     # 4.7e-3 / 9.9e-2
       "grad_dis": 2.5e-3,   # 1.4e-3 / 4.4e-3
       "update_enc": 8e-2,   # 1.8e-2 / 0.39
       "update_dec": 0.15,   # 1.9e-2 / 1.34
       "update_dis": 3.4e-2}  # 1.8e-2 / 6.2e-2


# the eval step: validation, audio, latent (measured: bf16 port / float32
# port 7.8e-8 / 6.0e-2, 4.0e-7 / 5.2e-3, 0 / 4.8e-3)
EVAL_TOL = (1e-3, 1e-4, 1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, jstate, step):
    state = loop.TrainState(cfg, device="cpu", step=step)
    load_flax_params(state.model, _np(jstate.gen_params),
                     _np(jstate.model_state["batch_stats"]))
    load_discriminator_params(state.disc, _np(jstate.dis_params))
    return state


def _groups(state, grad: bool = False) -> dict:
    """Every group's parameters (or their gradients), biases left out,
    flat, in the port's order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    names.update({id(p): n for n, p in state.disc.named_parameters()})
    out = {}
    for g, params in (("enc", state.enc_params), ("dec", state.dec_params),
                      ("dis", list(state.disc.parameters()))):
        out[g] = np.concatenate([
            (p.grad if grad else p).detach().double().numpy().ravel()
            for p in params if not names[id(p)].endswith("bias")])
    return out


def _jax_grads(cfg, jstate, mu, mu_prev, b1) -> dict:
    """The gradients of the groups whose first moments moved from
    ``mu_prev`` to ``mu``, loaded into a port state (the other
    parameters zero), as :func:`_groups` flattens them."""
    grads = {g: jax.tree.map(lambda m, q: (m - b1 * q) / (1 - b1),
                             mu[g], mu_prev[g]) for g in mu}
    gen = {k: grads["enc"].get(k, grads["dec"].get(k))
           for k in jstate.gen_params}
    gen = {k: v if v is not None else jax.tree.map(np.zeros_like,
                                                   _np(jstate.gen_params[k]))
           for k, v in gen.items()}
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, gen, _np(jstate.model_state["batch_stats"]))
    load_discriminator_params(state.disc, grads["dis"])
    return _groups(state)


@pytest.fixture(scope="module")
def runs():
    """The four steps of the JAX bf16 step and of the port in bf16 and in
    float32, from one converted state: per step the metrics and the
    gradients of the groups that stepped; each group's update."""
    jcfg = jbuild(["v2_fork"], BF16)
    start = jcfg.phase_1_duration
    jstate = jloop.init_state(jcfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(step=jnp.asarray(start, jnp.int32))
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((2, jcfg.n_signal, 1))).astype(np.float32)
    units = rng.integers(0, jcfg.hubert_units, (2, 148))
    cfgs = {"bfloat16": build_config(["v2_fork"], BF16),
            "float32": build_config(["v2_fork"], TINY)}
    ports = {dt: _port_state(cfg, jstate, start) for dt, cfg in cfgs.items()}
    before = _groups(ports["float32"])
    jstate0 = jstate

    def moments(st):
        return {g: _np(getattr(st, f"{g}_opt")[0].mu)
                for g in ("enc", "dec", "dis")}

    jbatch = {"x": jnp.asarray(x), "units": jnp.asarray(units)}
    # XLA's excess precision off: on the CPU it otherwise drops a bf16
    # rounding where a value is widened again (ROADMAP C)
    jstep = jax.jit(jloop.make_train_step(jcfg)).lower(
        jstate, jbatch, jax.random.PRNGKey(1)).compile(
            compiler_options={"xla_allow_excess_precision": False})
    out = {"jax": [], "bfloat16": [], "float32": []}
    kinds = []
    mu_prev = moments(jstate)
    for _ in range(4):
        kinds.append("D" if schedules.is_discriminator_step(
            int(jstate.step), cfgs["bfloat16"]) else "G")
        jstate, mj = jstep(jstate, jbatch, jax.random.PRNGKey(1))
        mu = moments(jstate)
        grads = _jax_grads(cfgs["float32"], jstate, mu, mu_prev,
                           jcfg.adam_b1)
        mu_prev = mu
        out["jax"].append(({k: float(v) for k, v in mj.items()}, grads))
    after = {"jax": _groups(_port_state(cfgs["float32"], jstate, start))}

    batch = {"x": torch.from_numpy(x), "units": torch.from_numpy(units)}
    for dt, state in ports.items():
        step = loop.make_train_step(state.cfg)
        for p in state.enc_params + state.dec_params + list(
                state.disc.parameters()):
            p.grad = torch.zeros_like(p)
        for _ in kinds:
            m = step(state, batch)
            out[dt].append(({k: float(v) for k, v in m.items()},
                            _groups(state, grad=True)))
        after[dt] = _groups(state)
    return {"steps": out, "before": before, "after": after, "kinds": kinds,
            "jstate0": jstate0, "cfgs": cfgs, "x": x, "units": units}


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))


def _distances(runs, dt) -> dict:
    """The largest relative distance of the port in ``dt`` from the JAX
    bf16 step, per quantity of :data:`TOL`."""
    d = dict.fromkeys(TOL, 0.0)
    for kind, (mj, gj), (mp, gp) in zip(runs["kinds"], runs["steps"]["jax"],
                                        runs["steps"][dt]):
        assert sorted(mj) == sorted(mp)
        for k in mj:
            if k.startswith("loss_") and mj[k] != 0:
                d["losses"] = max(d["losses"], _rel(mp[k], mj[k]))
        for g in (("dis",) if kind == "D" else ("enc", "dec")):
            d[f"grad_{g}"] = max(d[f"grad_{g}"], _rel(gp[g], gj[g]))
    for g, b in runs["before"].items():
        d[f"update_{g}"] = _rel(runs["after"][dt][g] - b,
                                runs["after"]["jax"][g] - b)
    return d


def test_bf16_steps_are_d_g_g_g_and_finite(runs):
    assert runs["kinds"] == ["D", "G", "G", "G"]
    for dt in ("jax", "bfloat16"):
        for (m, _), kind in zip(runs["steps"][dt], runs["kinds"]):
            assert all(np.isfinite(v) for v in m.values()), (dt, m)
            assert (m["loss_dis"] != 0) == (kind == "D"), (dt, kind, m)
            assert (m["loss_adversarial"] != 0) == (kind == "G"), (dt, m)


@pytest.mark.parametrize("what", sorted(TOL))
def test_bf16_step_matches_jax_bf16(runs, what):
    """The bf16 port within the tolerance of the JAX bf16 step; the
    float32 port, which misses the bf16 roundings, beyond it."""
    got, ctrl = _distances(runs, "bfloat16"), _distances(runs, "float32")
    print(what, "bf16 port", got[what], "float32 port", ctrl[what])
    assert got[what] <= TOL[what], (what, got[what], TOL[what])
    assert ctrl[what] > TOL[what], (
        f"the float32 port ({ctrl[what]:.3g}) passes the bf16 tolerance "
        f"on {what}")


def test_bf16_eval_step_matches_jax_bf16(runs):
    """The eval step of the initial state: its ``validation``, its audio
    and its latent against the JAX bf16 eval step (tolerances between
    the bf16 port's relative distances and the float32 port's)."""
    jcfg = jbuild(["v2_fork"], BF16)
    jstate, x, units = runs["jstate0"], runs["x"], runs["units"]
    jbatch = {"x": jnp.asarray(x), "units": jnp.asarray(units)}
    key = jax.random.PRNGKey(2)
    m_j, y_j, z_j = jax.jit(jloop.make_eval_step(jcfg)).lower(
        jstate, jbatch, key).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                jstate, jbatch, key)
    want = (float(m_j["validation"]), np.asarray(y_j), np.asarray(z_j))
    batch = {"x": torch.from_numpy(x), "units": torch.from_numpy(units)}
    got = {}
    for dt, cfg in runs["cfgs"].items():
        state = _port_state(cfg, jstate, cfg.phase_1_duration)
        m, y, z = loop.make_eval_step(cfg)(state, batch)
        assert y.dtype == z.dtype == torch.float32
        got[dt] = (_rel(float(m["validation"]), want[0]),
                   _rel(y.numpy(), want[1]), _rel(z.numpy(), want[2]))
    print("eval: bf16 port", got["bfloat16"], "float32 port", got["float32"])
    for what, g, c, tol in zip(("validation", "audio", "latent"),
                               got["bfloat16"], got["float32"], EVAL_TOL):
        assert g <= tol < c, (what, g, c, tol)
