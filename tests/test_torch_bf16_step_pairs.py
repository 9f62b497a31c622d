"""One bf16 D step and one bf16 G step of a preset in both packages.

The helper of ``tests/test_torch_bf16_presets_*.py``: the JAX package's
bf16 train step, compiled once with XLA's excess precision off (ROADMAP
C), takes a D step and then a G step from its initial state; the port's
step takes the same two steps from that state converted, once in bf16
and once in float32 (the control), with the JAX step's random draws
handed over: the latent noise of a variational head, the Wasserstein
head's reference and augmentation, the noise branch's uniform draw, and
the discrete head's k-means rows (``rave_tpu.models.quantization.
_sample_vectors`` patched to the rows of :func:`rows`, which the port's
step takes as its sampler).  The JAX step's gradients are read back from
its Adam first moments, as ``tests/test_torch_bf16_train.py`` reads them.

:func:`distances` gives the relative L2 distance of a port run from the
JAX run: the losses of both steps, and each stepped group's gradient as
one vector, biases left out (XLA on the CPU sums a bf16 bias gradient in
bf16; ``tests/test_torch_bf16_disc.py`` holds the discriminator's bias
gradients against a float32 sum instead).
"""
import math
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rave_tpu.models.quantization as jq
from rave_tpu.config import build_config as jbuild
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.train import loop, schedules

TINY = ["capacity=4", "n_signal=8192", "batch_size=2", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]", "learning_rate=1e-6", "log_epsilon=1e-3",
        "phase_1_duration=0"]
# a small multi-scale discriminator where a preset's own one only
# lengthens the JAX compile: every discriminator member is held in bf16
# on its own by tests/test_torch_bf16_disc.py
SMALL_DIS = ["discriminator.kind=multi_scale", "discriminator.capacity=4",
             "discriminator.n_layers=2"]
STEP_KEY = 1
GROUPS = ("enc", "dec", "dis", "spk")


def rows_idx(n: int, num: int) -> np.ndarray:
    return np.random.RandomState(1000 * n + num).randint(0, n, num)


def rows(samples, num):
    """The port's sampler: the rows the patched JAX draw takes."""
    return samples[torch.from_numpy(rows_idx(samples.shape[0], num))
                   .to(samples.device)]


@contextmanager
def same_rows():
    """The JAX package's k-means rows drawn as :func:`rows` draws them."""
    saved = jq._sample_vectors
    jq._sample_vectors = lambda rng, s, num: s[jnp.asarray(
        rows_idx(s.shape[0], num))]
    try:
        yield
    finally:
        jq._sample_vectors = saved


def tones(B: int, T: int, seed: int = 0) -> np.ndarray:
    """``B`` gliding harmonic tones ``(B, T, 1)`` with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    out = []
    for i in range(B):
        phase = 2 * np.pi * (100 + 70 * i) * (t + 0.8 * t * t)
        x = sum(np.sin(h * phase) / h for h in range(1, 5))
        out.append(0.2 * x + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)[..., None]


def _cf(a) -> torch.Tensor:
    """``(B, T, C)`` -> ``(B, C, T)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 2, 1)))


def port_draws(cfg, step: int) -> tuple:
    """``(eps, draws)``: the JAX step's draws at ``step`` in the port's
    layouts (``split(fold_in(key, step), 4)``: the latent's from the
    first key, the noise branch's from the second)."""
    r = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(STEP_KEY), step), 4)
    B, T = cfg.batch_size, cfg.n_signal
    T_z = T // cfg.total_ratio()
    eps, draws = None, {}
    if cfg.latent_head == "variational" and not cfg.speaker_embedding_size:
        eps = _cf(jax.random.normal(r[0], (B, T_z, cfg.latent_size),
                                    jnp.float32))
    if cfg.latent_head == "wasserstein":
        r1, r2 = jax.random.split(r[0])
        ref = jax.random.normal(r1, (B * T_z, cfg.latent_size), jnp.float32)
        draws["ref"] = _cf(np.asarray(ref).reshape(B, T_z, -1))
        draws["aug"] = _cf(jax.random.normal(
            r2, (B, T_z, cfg.noise_augmentation), jnp.float32))
    n = None
    if cfg.generator_version == "v1" and cfg.v1_use_noise:
        n = 64
    elif cfg.use_noise:
        n = math.prod(cfg.noise_ratios)
    if n is not None:
        draws["noise"] = torch.from_numpy(np.array(jax.random.uniform(
            r[1], (B, T // cfg.n_band // n, cfg.n_band, n), jnp.float32,
            -1.0, 1.0)))
    return eps, draws


def batch_for(cfg) -> dict:
    """A seeded batch of numpy arrays: tones, plus the fork's HuBERT
    units, distinct speaker ids with ``speaker_classes`` and the pitch
    route's speaker statistics."""
    B = cfg.batch_size
    rng = np.random.default_rng(1)
    batch = {"x": tones(B, cfg.n_signal)}
    if cfg.hubert_units:
        batch["units"] = rng.integers(0, cfg.hubert_units, (B, 148))
    if cfg.speaker_classes:
        batch["speaker"] = np.arange(B)
    if cfg.pitch_embedding_size:
        batch["f0_median"] = np.log(rng.uniform(100, 250, B)).astype(
            np.float32)
        batch["f0_std"] = rng.uniform(0.2, 0.4, B).astype(np.float32)
    return batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, params, model_state, dis_params):
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, params, model_state.get("batch_stats"),
                     model_state={k: v for k, v in model_state.items()
                                  if k != "batch_stats"})
    load_discriminator_params(state.disc, dis_params)
    return state


def _flat(state, grad: bool) -> dict:
    """Every group's parameters (or their gradients, zero where a
    parameter has none), biases left out, flat, in the port's order."""
    named = {id(p): n for n, p in state.model.named_parameters()}
    named.update({id(p): n for n, p in state.disc.named_parameters()})
    params = {"enc": state.enc_params, "dec": state.dec_params,
              "dis": list(state.disc.parameters()),
              "spk": state.spk_params}
    out = {}
    for g, ps in params.items():
        ps = [p for p in ps if not named[id(p)].endswith("bias")]
        if ps:
            out[g] = np.concatenate([
                np.zeros(p.numel()) if grad and p.grad is None else
                (p.grad if grad else p).detach().double().numpy().ravel()
                for p in ps])
    return out


def run_pair(stack, over) -> dict:
    """Both packages' D and G steps (see the module docstring); per run
    (``jax``, ``bfloat16``, ``float32``) and step, the metrics and the
    gradients of the groups that stepped."""
    jcfg = jbuild(stack, over + ["compute_dtype=bfloat16"])
    cfgs = {"bfloat16": build_config(stack, over + [
        "compute_dtype=bfloat16"]), "float32": build_config(stack, over)}
    batch = batch_for(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with same_rows():
        jstate = jloop.init_state(jcfg, jax.random.PRNGKey(0))
        key = jax.random.PRNGKey(STEP_KEY)
        jstep = jax.jit(jloop.make_train_step(jcfg)).lower(
            jstate, jbatch, key).compile(
                compiler_options={"xla_allow_excess_precision": False})
    start = (_np(jstate.gen_params), _np(jstate.model_state),
             _np(jstate.dis_params))

    def moments(st):
        return {g: _np(getattr(st, f"{g}_opt")[0].mu) if getattr(
            st, f"{g}_opt") is not None else {} for g in GROUPS}

    out = {"jax": [], "bfloat16": [], "float32": []}
    kinds, mu_prev = [], moments(jstate)
    for _ in range(2):
        kinds.append("D" if schedules.is_discriminator_step(
            int(jstate.step), cfgs["float32"]) else "G")
        jstate, mj = jstep(jstate, jbatch, key)
        mu = moments(jstate)
        grads = {g: jax.tree.map(lambda m, q: (m - jcfg.adam_b1 * q)
                                 / (1 - jcfg.adam_b1), mu[g], mu_prev[g])
                 for g in mu}
        mu_prev = mu
        gen = jax.tree.map(np.zeros_like, start[0])
        for g in ("enc", "dec", "spk"):
            gen.update(grads[g])
        gstate = _port_state(cfgs["float32"], gen, start[1], grads["dis"])
        want = _flat(gstate, grad=False)
        stepped = ("dis",) if kinds[-1] == "D" else ("enc", "dec", "spk")
        out["jax"].append(({k: float(v) for k, v in mj.items()},
                           {g: v for g, v in want.items() if g in stepped
                            and np.any(v)}))
    for dt, cfg in cfgs.items():
        state = _port_state(cfg, *start)
        step = loop.make_train_step(cfg)
        for i, kind in enumerate(kinds):
            for p in state.model.parameters():
                p.grad = None
            for p in state.disc.parameters():
                p.grad = None
            eps, draws = port_draws(cfg, i)
            m = step(state, tbatch, eps, sampler=rows, draws=draws)
            got = _flat(state, grad=True)
            out[dt].append(({k: float(v) for k, v in m.items()},
                            {g: got[g] for g in out["jax"][i][1]}))
    return {"kinds": kinds, "steps": out}


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - b)
                 / max(np.linalg.norm(b), 1e-30))


def distances(pair, dt) -> dict:
    """The largest relative distance of the port in ``dt`` from the JAX
    run over both steps: ``losses`` (every nonzero ``loss_*``) and
    ``grad_<group>`` per group that stepped."""
    d = {"losses": 0.0}
    for (mj, gj), (mp, gp) in zip(pair["steps"]["jax"], pair["steps"][dt]):
        assert sorted(mj) == sorted(mp), (sorted(mj), sorted(mp))
        for k in mj:
            if k.startswith("loss_") and mj[k] != 0:
                d["losses"] = max(d["losses"], _rel(mp[k], mj[k]))
        for g in gj:
            d[f"grad_{g}"] = max(d.get(f"grad_{g}", 0.0), _rel(gp[g], gj[g]))
    return d


def check_kinds(pair) -> None:
    """A D step, then a G step; every metric finite in every run; the
    D step's loss is the discriminator's, the G step's the generator's."""
    assert pair["kinds"] == ["D", "G"]
    for dt, steps in pair["steps"].items():
        for (m, _), kind in zip(steps, pair["kinds"]):
            assert all(np.isfinite(v) for v in m.values()), (dt, kind, m)
            assert (m["loss_dis"] != 0) == (kind == "D"), (dt, kind, m)
            assert (m["loss_gen_total"] != 0) == (kind == "G"), (dt, m)


def check_between(pair, what: str, tol: float) -> None:
    """The bf16 port within ``tol`` of the JAX bf16 step on ``what``; the
    float32 port, which misses the bf16 roundings, beyond it."""
    got = distances(pair, "bfloat16")[what]
    ctrl = distances(pair, "float32")[what]
    print(what, "bf16 port", got, "float32 port", ctrl)
    assert got <= tol, (what, got, tol)
    assert ctrl > tol, (f"the float32 port ({ctrl:.3g}) passes the bf16 "
                        f"tolerance {tol:.3g} on {what}")


def make_tests(cases: dict, tol: dict) -> tuple:
    """The fixtures and tests of one test module over ``cases`` (name ->
    ``(stack, overrides)``) with the tolerances ``tol`` (name -> quantity
    of :func:`distances` -> bound); the module binds them at its top
    level, one module per few cases so that the JAX compiles spread over
    the suite's workers."""

    @pytest.fixture(scope="module", autouse=True)
    def _one_thread():
        """One PyTorch thread: beside the suite's other workers, more
        oversubscribe the cores (ROADMAP A, Tier-1 room)."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)

    @pytest.fixture(scope="module")
    def pairs():
        """Each case's pair of runs, made on first use."""
        made = {}

        def get(case):
            if case not in made:
                made[case] = run_pair(*cases[case])
            return made[case]

        return get

    @pytest.mark.parametrize("case", sorted(cases))
    def test_bf16_steps_are_d_g_and_finite(pairs, case):
        check_kinds(pairs(case))

    @pytest.mark.parametrize("case,what", [(c, w) for c in sorted(tol)
                                           for w in sorted(tol[c])])
    def test_bf16_step_matches_jax_bf16(pairs, case, what):
        check_between(pairs(case), what, tol[case][what])

    return (_one_thread, pairs, test_bf16_steps_are_d_g_and_finite,
            test_bf16_step_matches_jax_bf16)
