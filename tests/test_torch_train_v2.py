"""The port's upstream v2 train step, EMA, eval step and latent PCA
against rave_tpu's.

Three configurations, each from one converted initial state, with the
JAX package's latent noise fed to the port (``eps = normal(split(
fold_in(rng, step), 4)[0], (B, T_z, latent))``, transposed):

* ``dry``: the dry-run overrides of ``__graft_entry__.py`` (capacity 4,
  4096 samples, no crop, no phase 1, D every second step, three STFT
  scales, discriminator capacity 4) and ``ema_decay=0.99``: D, G, D;
  then the EMA against the JAX ``ema_params``.  The 512 scale pads its
  256-frame bands by 256: numpy's repeated reflection;
* ``phase1``: the same with ``phase_1_duration=2``: two pure-VAE G steps
  (no GAN term);
* ``crop``: ``v2`` at ratios [2, 2] and 8192 samples with the
  valid-signal crop on (the crop at full ratios would not fit a short
  input), spectral discriminator scales [512, 256] and STFT scales
  [1024, 512, 256, 128]: D, G; and the gradient of one warmed-up G step.
  The default 2048 scale is left out here: over the 268 band frames the
  crop leaves, its one frame holds a reflected, nearly periodic signal
  whose Hann spectrum has near-empty bins, where ``log(|S| + 1e-7)``
  turns float32 rounding into the whole gradient (against a float64
  evaluation of the port, the JAX package's float32 gradient of that
  scale errs by 100 %, the port's by 4 %).

After the steps of each case, the eval step of both frameworks on the
final state.

The oneDNN CPU convolution of the PyTorch build these tests run on
returns a wrong data gradient for some strided conv1d shapes when it
runs on several threads (at ``(2, 256, 17)`` into 512 channels, k 15,
stride 4, as in the MSD's last ladder layer: 40 % off a float64
evaluation, different from run to run; right on one thread), so this
module runs PyTorch on one CPU thread.  (Without oneDNN the results are
right too, but the fallback's float32 gradients are four times as far
from float64.)

Tolerances.  Metrics: rtol 1e-4 on each step up to the first D step, as
``tests/test_torch_train.py`` (float32 through the ladders and STFTs,
sums in another order).  After a D step the port's metric must be
within 1e-4 of the JAX one or no farther from a float64 run of the port
than twice the JAX one is (plus 1e-4 of it): the hinge gradient of each
score conv's bias is exactly 0 while every score lies inside the margin
(the real and fake halves' +-1/N cancel), so Adam moves those biases by
up to ``lr`` on rounding noise, differently in each framework, and the
GAN terms of the next step differ by up to 2e-3 of their value.  The
gradient of one G step: each tensor's within 5 % of the JAX gradient's
2-norm (each framework's float32 gradient lies within 1.2 % of a
float64 evaluation of the port at that step; the largest gap between
them is 1.8 %).  Parameters after the steps: every element within
3 ``lr`` per step taken, as ``tests/test_torch_train.py``; the update of
the generator and of the discriminator, each as one vector, within 35 %
of the JAX update's 2-norm.  Adam moves an element by about ``lr``
whatever its gradient's size, so gradient elements near the float32
floor (about 1 % of a tensor's norm against float64 in both frameworks,
from the log magnitudes of the multiband distance over 256-frame bands)
decide their step by rounding: after the two G steps of ``phase1`` the
generator's update differs from the JAX one by 24 % (the port's first
step is 2.1 times as far as the JAX one from a float64 run of the port,
mostly in the largest weight-normed kernels; after a third G step both
are 40-50 % of the update away from it).  The EMA: every element within
``(1 - decay)`` times the element bound, plus 1e-6 for the rounding of
the average itself.  The eval step's ``validation`` rtol 1e-4, its
``y`` and ``z_mean`` atol 1e-5.  ``fit_latent_pca`` is numpy in both
packages: fidelity rtol 1e-6, each component equal up to sign at atol
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.train import latent_stats as jstats
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.train import latent_stats, loop, schedules

DRY = ["capacity=4", "n_signal=4096", "batch_size=2",
       "valid_signal_crop=false", "phase_1_duration=0",
       "update_discriminator_every=2", "stft_scales=[512,256,128]",
       "discriminator.capacity=4"]
CASES = {
    "dry": (DRY + ["ema_decay=0.99"], 0, "DGD"),
    "phase1": (DRY + ["phase_1_duration=2"], 0, "GG"),
    "crop": (["capacity=4", "n_signal=8192", "batch_size=2", "ratios=[2,2]",
              "dilations=[[1,3],[1,3]]", "stft_scales=[1024,512,256,128]",
              "discriminator.spectral_scales=[512,256]"], None, "DG"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """See the module docstring: oneDNN's threaded conv1d data gradient."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_INIT = {}


def _init_state(over):
    """The JAX package's initial train state of ``v2`` with ``over``,
    built once per configuration in this module: the ``crop`` case's run
    and :func:`test_generator_gradient_matches` start from the same one
    (its arrays are immutable; each user replaces the step)."""
    key = tuple(over)
    if key not in _INIT:
        _INIT[key] = jloop.init_state(jbuild(["v2"], over),
                                      jax.random.PRNGKey(0))
    return _INIT[key]


def _port_state(cfg, jstate, step):
    state = loop.TrainState(cfg, device="cpu", step=step)
    load_flax_params(state.model, _np(jstate.gen_params))
    load_discriminator_params(state.disc, _np(jstate.dis_params))
    state.reset_ema()
    return state


def _named(state):
    return {**{"gen/" + k: v for k, v in state.model.state_dict().items()},
            **{"dis/" + k: v for k, v in state.disc.state_dict().items()}}


def _jax_eps(rng, step, cfg):
    """The noise the JAX step draws for the latent at ``step``."""
    r = jax.random.split(jax.random.fold_in(rng, step), 4)
    shape = (cfg.batch_size, cfg.n_signal // cfg.total_ratio(),
             cfg.latent_size)
    return np.asarray(jax.random.normal(r[0], shape, jnp.float32))


def _no_farther(got, want, exact, rel):
    """``got`` is within ``rel`` of ``want``, or no farther from the
    float64 ``exact`` than twice the distance of ``want`` from it, plus
    ``rel`` of its size."""
    dist = lambda a, b: float((a - b).norm())  # noqa: E731
    return (dist(got, want) <= rel * float(want.norm())
            or dist(got, exact) <= 2 * dist(want, exact)
            + rel * float(exact.norm()))


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """Both frameworks through the case's steps from one converted
    state; metrics, states and the batch."""
    over, start, kinds = CASES[request.param]
    jcfg, cfg = jbuild(["v2"], over), build_config(["v2"], over)
    start = cfg.phase_1_duration if start is None else start
    jstate = _init_state(over).replace(step=jnp.asarray(start, jnp.int32))
    state = _port_state(cfg, jstate, start)
    before = {k: v.clone() for k, v in _named(state).items()}
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    # the port again in float64, from the same state: the exact update
    exact = _port_state(cfg, jstate, start)
    exact.model.double()
    exact.disc.double()
    jstep = jax.jit(jloop.make_train_step(jcfg))
    step = loop.make_train_step(cfg)
    rng = jax.random.PRNGKey(1)
    metrics = []
    for i, kind in enumerate(kinds):
        assert schedules.is_discriminator_step(state.step, cfg) == (
            kind == "D"), (i, state.step)
        eps = torch.from_numpy(_jax_eps(rng, start + i, jcfg).transpose(0, 2, 1)
                               .copy())
        jstate, mj = jstep(jstate, {"x": jnp.asarray(x)}, rng)
        mt = step(state, {"x": torch.from_numpy(x)}, eps)
        m64 = step(exact, {"x": torch.from_numpy(x).double()}, eps.double())
        metrics.append(tuple({k: float(v) for k, v in m.items()}
                             for m in (mt, mj, m64)))
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, start=start,
                kinds=kinds, state=state, jstate=jstate, exact=exact,
                before=before, metrics=metrics, x=x)


def test_metrics_match(run):
    assert run["state"].step == run["start"] + len(run["kinds"])
    for i, (mt, mj, m64) in enumerate(run["metrics"]):
        assert sorted(mt) == sorted(mj) == sorted(m64)
        after_d = "D" in run["kinds"][:i]
        for k in mj:
            t, j, e = (torch.tensor(m[k], dtype=torch.float64)
                       for m in (mt, mj, m64))
            ok = (_no_farther(t, j, e, 1e-4) if after_d else
                  float((t - j).abs()) <= 1e-4 * float(j.abs()) + 1e-7)
            assert ok, (i, k, mt[k], mj[k], m64[k])
        assert all(np.isfinite(v) for v in mt.values())
        kind = run["kinds"][i]
        warm = schedules.warmed_up(run["start"] + i, run["cfg"])
        if kind == "G":
            assert mt["loss_regularization"] > 0
            assert (mt["loss_feature_matching"] > 0) == warm
            assert (mt["loss_adversarial"] != 0) == warm
        else:
            assert mt["loss_dis"] > 0 and mt["loss_gen_total"] == 0


def test_parameters_match(run):
    state, cfg, before = run["state"], run["cfg"], run["before"]
    got = _named(state)
    want = _named(_port_state(cfg, run["jstate"], run["start"]))
    n_gen, n_dis = run["kinds"].count("G"), run["kinds"].count("D")
    lr = cfg.learning_rate
    for k in got:
        steps = n_dis if k.startswith("dis/") else n_gen
        d_got, d_want = got[k] - before[k], want[k] - before[k]
        err = float((d_got - d_want).abs().max())
        assert err <= 3 * lr * max(steps, 1), (k, err / lr)
    for group in ("gen/", "dis/"):
        keys = [k for k in got if k.startswith(group)]
        d_got, d_want = (torch.cat([(t[k] - before[k]).flatten()
                                    for k in keys]) for t in (got, want))
        scale = float(d_want.norm())
        if scale == 0:
            assert float(d_got.norm()) == 0, group
            continue
        rel = float((d_got - d_want).norm()) / scale
        assert rel <= 0.35, (group, rel)
    moved = lambda pre: any(not torch.equal(got[k], run["before"][k])  # noqa: E731
                            for k in got if k.startswith(pre))
    assert moved("gen/encoder.") == moved("gen/decoder.") == (n_gen > 0)
    assert moved("dis/") == (n_dis > 0)


def test_generator_gradient_matches():
    """One warmed-up G step of the crop case from the converted initial
    state: the gradient the port's step leaves on each generator
    parameter against ``jax.grad`` of the JAX package's G loss."""
    over = CASES["crop"][0]
    jcfg, cfg = jbuild(["v2"], over), build_config(["v2"], over)
    step = cfg.phase_1_duration + 1
    jstate = _init_state(over).replace(step=jnp.asarray(step, jnp.int32))
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    jmodel, jdisc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)

    def jloss(gen_params, dis_params, model_state, x, step):
        out = jloop._forward_losses(
            jcfg, jmodel, jdisc, gen_params, dis_params, model_state,
            {"x": x}, jax.random.fold_in(rng, step), step)
        _, adv, fm = jloop._gan_terms(jcfg, jdisc, dis_params,
                                      out["x"], out["y"])
        terms = {**out["dists"], "adversarial": adv, "feature_matching": fm,
                 "regularization": out["reg"] * jcfg.beta_target}
        return sum(v * jcfg.weights.get(k, 1.0) for k, v in terms.items())

    # the state and the batch are arguments, not constants of the program
    want = RAVE(cfg, device="cpu")
    load_flax_params(want, _np(jax.jit(jax.grad(jloss))(
        jstate.gen_params, jstate.dis_params, jstate.model_state,
        jnp.asarray(x), jstate.step)))
    want = dict(want.named_parameters())
    state = _port_state(cfg, jstate, step)
    eps = _jax_eps(rng, step, jcfg).transpose(0, 2, 1).copy()
    loop.make_train_step(cfg)(state, {"x": torch.from_numpy(x)},
                              torch.from_numpy(eps))
    n = 0
    for k, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        g, w = p.grad, want[k].detach()
        assert float((g - w).norm()) <= 0.05 * float(w.norm()), (
            k, float((g - w).norm() / w.norm()))
        n += 1
    assert n == len(state.enc_params) + len(state.dec_params)


def test_ema_matches(run):
    if run["name"] != "dry":
        assert run["state"].ema is None and run["jstate"].ema_params is None
        return
    cfg, state = run["cfg"], run["state"]
    want = RAVE(cfg, device="cpu")
    load_flax_params(want, _np(run["jstate"].ema_params))
    want = dict(want.named_parameters())
    before = {k[4:]: v for k, v in run["before"].items()
              if k.startswith("gen/")}
    d = cfg.ema_decay
    n_gen = run["kinds"].count("G")
    assert sorted(state.ema) == sorted(want)
    moved = False
    for k, e in state.ema.items():
        err = float((e - want[k].detach()).abs().max())
        assert err <= (1 - d) * 3 * cfg.learning_rate * n_gen + 1e-6, (k, err)
        moved |= not torch.equal(e, before[k])
    assert moved


def test_eval_step_matches(run):
    jm, jy, jz = jax.jit(jloop.make_eval_step(run["jcfg"]))(
        run["jstate"], {"x": jnp.asarray(run["x"])}, jax.random.PRNGKey(2))
    state = _port_state(run["cfg"], run["jstate"], run["start"])
    m, y, z = loop.make_eval_step(run["cfg"])(state,
                                               {"x": torch.from_numpy(run["x"])})
    assert sorted(m) == sorted(jm) == ["validation"]
    assert float(m["validation"]) == pytest.approx(float(jm["validation"]),
                                                   rel=1e-4)
    assert y.shape == jy.shape and z.shape == jz.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)


def test_fit_latent_pca_matches():
    rng = np.random.default_rng(3)
    zs = (rng.standard_normal((400, 8)) * np.linspace(3, 0.1, 8)
          @ np.linalg.qr(rng.standard_normal((8, 8)))[0]).astype(np.float32)
    got, want = latent_stats.fit_latent_pca(zs), jstats.fit_latent_pca(zs)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["fidelity"], want["fidelity"], rtol=1e-6)
    np.testing.assert_allclose(got["latent_mean"], want["latent_mean"],
                               rtol=1e-6)
    for a, b in zip(got["latent_pca"], want["latent_pca"]):
        assert np.allclose(a, b, atol=1e-5) or np.allclose(a, -b, atol=1e-5)
    for target in (0.5, 0.9, 0.99):
        assert (latent_stats.n_dims_for_fidelity(got["fidelity"], target)
                == jstats.n_dims_for_fidelity(want["fidelity"], target))


def test_latent_stats_round_trip(tmp_path):
    stats = latent_stats.fit_latent_pca(
        np.random.default_rng(4).standard_normal((50, 4)).astype(np.float32))
    assert latent_stats.load_latent_stats(str(tmp_path)) is None
    latent_stats.save_latent_stats(str(tmp_path), stats)
    back = latent_stats.load_latent_stats(str(tmp_path))
    assert back is not None and sorted(back) == sorted(stats)
    for k in stats:
        np.testing.assert_array_equal(back[k], stats[k])
    jback = jstats.load_latent_stats(str(tmp_path))
    assert sorted(jback) == sorted(back)
    for k in back:
        np.testing.assert_array_equal(back[k], jback[k])
