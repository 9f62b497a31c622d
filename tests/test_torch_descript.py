"""The port's Descript discriminator against ``rave_tpu``'s: each
sub-discriminator's features (the MRD against both of the JAX package's
formulations, the packed-resident default and ``packed=False``), the
whole discriminator with its float32 preprocess, its gradient, and one
``v3`` G step.

Layouts: JAX features are channels-last; the MPD's ``(B, T/p, p, C)``
is the port's ``(B, C, T/p, p)``, the MRD's ``(B, frames, bins, C)`` the
port's ``(B, C, frames, bins)``.  The packed MRD gives its chain
features frequency-major (``PackedFeature.unpack()`` or, unpacked, as
``(B, bins, frames, C)``).

Tolerances: features 1e-4 of the largest magnitude of each (float32
through up to six convs and an FFT); the G step's metrics rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models import discriminators as jd
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.models import discriminators as td
from rave_tpu_torch.train import loop, schedules


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """PyTorch on one CPU thread: its threaded oneDNN conv1d data
    gradient is wrong at some strided shapes (ROADMAP C), and beside the
    suite's other workers more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wn_params(shapes, seed=2):
    """Weight-normed conv parameters of the given shapes, as the JAX
    package's ``WNConv`` initialises them: ``v`` and ``bias`` uniform in
    +-1/sqrt(fan in), ``g`` the norm of ``v`` over all but its last
    axis."""
    rng = np.random.default_rng(seed)

    def conv(leaves):
        v_shape = leaves["v"].shape
        bound = 1.0 / np.sqrt(np.prod(v_shape[:-1]))
        v = rng.uniform(-bound, bound, v_shape).astype(np.float32)
        axes = tuple(range(len(v_shape) - 1))
        return {"v": v,
                "g": np.sqrt((v * v).sum(axes, keepdims=True)),
                "bias": rng.uniform(-bound, bound, leaves["bias"].shape)
                .astype(np.float32)}

    def walk(tree):
        return conv(tree) if "v" in tree else {k: walk(t) for k, t in
                                               tree.items()}
    return walk(dict(shapes))


def _clip(T=8192, B=2, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.3
            ).astype(np.float32)


def _close(got: torch.Tensor, want, what=""):
    got = got.detach().numpy()
    got = got.transpose(0, 2, 3, 1) if got.ndim == 4 else got.transpose(0, 2, 1)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


def _native(feats, mrd_packed: bool):
    """JAX features in native channels-last layout."""
    out = []
    for i, f in enumerate(feats):
        if isinstance(f, jd.PackedFeature):
            f = f.unpack()
        f = np.asarray(f)
        if mrd_packed and i < len(feats) - 1:
            f = f.transpose(0, 2, 1, 3)     # (B, F, T, C) -> (B, T, F, C)
        out.append(f)
    return out


def _pair(jmod, tmod, x):
    v = _np(jax.jit(jmod.init)({"params": jax.random.PRNGKey(0)},
                               jnp.asarray(x)))
    _load_sub(tmod, v["params"])
    fj = jax.jit(jmod.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        ft = tmod(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))))
    return fj, ft


def _load_sub(tmod, params):
    wrapper = torch.nn.Module()
    wrapper.add_module("sub", tmod)
    load_discriminator_params(wrapper, {"sub": params})


@pytest.mark.parametrize("period", [2, 3, 11])
def test_mpd_matches(period):
    fj, ft = _pair(jd.DescriptMPD(period=period), td.DescriptMPD(period),
                   _clip(8191))
    assert len(fj) == len(ft) == 6
    for i, (a, b) in enumerate(zip(fj, ft)):
        _close(b, np.asarray(a), f"mpd{period}/{i}")


@pytest.mark.parametrize("scale", [1, 2])
def test_msd_matches(scale):
    """The MSD (no preset builds one: ``rates`` is empty by default); at
    scale 1 its head conv meets the ci=1 gate (kernels B2/B3 on the
    card, their plain twin here)."""
    tmod = td.DescriptMSD(scale)
    if scale == 1:
        x = torch.zeros(2, 1, 8192)
        assert tmod.convs[0].takes_ci1(x)
    fj, ft = _pair(jd.DescriptMSD(scale=scale), tmod, _clip())
    assert len(fj) == len(ft) == 7
    for i, (a, b) in enumerate(zip(fj, ft)):
        _close(b, np.asarray(a), f"msd{scale}/{i}")


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "native"])
@pytest.mark.parametrize("window", [2048, 512])
def test_mrd_matches(window, packed):
    fj, ft = _pair(jd.DescriptMRD(window_length=window, packed=packed),
                   td.DescriptMRD(window), _clip())
    assert len(fj) == len(ft) == 5 * 5 + 1
    for i, (a, b) in enumerate(zip(_native(fj, packed), ft)):
        _close(b, a, f"mrd{window}/{i}")


WHOLE = dict(periods=(2, 3), rates=(2,), fft_sizes=(1024, 512))


@pytest.fixture(scope="module")
def whole():
    """One of each sub-discriminator kind and two MRDs (the preset's
    five periods and three sizes are each sub-test's)."""
    x = _clip(4096)
    jdisc = jd.DescriptDiscriminator(**WHOLE)
    v = {"params": _wn_params(jax.eval_shape(
        jdisc.init, {"params": jax.random.PRNGKey(1)},
        jnp.asarray(x))["params"])}
    tdisc = td.DescriptDiscriminator(**WHOLE)
    load_discriminator_params(tdisc, v["params"])
    return jdisc, v, tdisc, x


def test_discriminator_matches(whole):
    """Preprocess (DC removal, 0.8 peak) and the mpd/msd/mrd order."""
    jdisc, v, tdisc, x = whole
    x = x * 0.5 + 0.1
    fj = jax.jit(jdisc.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        ft = tdisc(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 1))))
    assert len(fj) == len(ft) == 2 + 1 + 2
    assert tdisc.subs == ["mpd0", "mpd1", "msd0", "mrd0", "mrd1"]
    for c, (cj, ct) in enumerate(zip(fj, ft)):
        for i, (a, b) in enumerate(zip(_native(cj, c >= 3), ct)):
            _close(b, a, f"{tdisc.subs[c]}/{i}")


def test_discriminator_input_gradient_matches(whole):
    """The gradient of the mean square of every feature with respect to
    the audio, through the float32 preprocess."""
    jdisc, v, tdisc, x = whole

    def jf(params, a):
        feats = jdisc.apply({"params": params}, a)
        total = 0.0
        for chain in feats:
            for f in chain:
                d = f.data if isinstance(f, jd.PackedFeature) else f
                total = total + jnp.sum(d ** 2) / (
                    f.valid_rows * np.prod(d.shape[:1] + d.shape[2:-1])
                    * (d.shape[-1] // f.pout)
                    if isinstance(f, jd.PackedFeature) else d.size)
        return total

    want = np.asarray(jax.jit(jax.grad(jf, argnums=1))(
        v["params"], jnp.asarray(x)))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    xt.requires_grad_()
    sum(torch.mean(f ** 2) for chain in tdisc(xt) for f in chain).backward()
    got = xt.grad.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_build_descript():
    disc = td.build_discriminator(build_config(["v3"]), "cpu")
    assert isinstance(disc, td.DescriptDiscriminator)
    assert disc.subs == ["mpd0", "mpd1", "mpd2", "mpd3", "mpd4", "mrd0",
                         "mrd1", "mrd2"]
    comb = td.CombineDiscriminators(("descript",))
    assert isinstance(comb.descript, td.DescriptDiscriminator)
    assert td.member_sub_count("descript") == len(comb.descript.subs)


# two periods and two window sizes of the Descript discriminator (the
# preset's five and three are the sub-tests')
V3 = ["capacity=4", "n_signal=4096", "batch_size=2", "ratios=[2,2]",
      "dilations=[[1,3],[1,3]]", "valid_signal_crop=false",
      "phase_1_duration=0", "stft_scales=[512,256,128]",
      "discriminator.periods=[2,3]", "discriminator.fft_sizes=[1024,512]"]


def test_v3_generator_step_matches():
    """One warmed-up G step of a tiny ``v3`` (Snake, AdaIN as the
    identity, the Descript discriminator) from one converted state, with
    the JAX step's latent noise fed to the port."""
    jcfg, cfg = jbuild(["v3"], V3), build_config(["v3"], V3)
    step = 1
    assert not schedules.is_discriminator_step(step, cfg)
    assert schedules.warmed_up(step, cfg)
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    jmodel, jdisc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)
    v = _np(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                 jnp.asarray(x)))
    gen_params = v["params"]
    model_state = {k: t for k, t in v.items() if k != "params"}
    dis_params = _wn_params(jax.eval_shape(
        jdisc.init, {"params": rng}, jnp.asarray(x))["params"])

    def jlosses(gen_params, dis_params, model_state, x):
        """The G step's loss terms (``gen_loss_fn`` of the JAX step)."""
        out = jloop._forward_losses(
            jcfg, jmodel, jdisc, gen_params, dis_params, model_state,
            {"x": x}, jax.random.fold_in(rng, step), step)
        _, adv, fm = jloop._gan_terms(jcfg, jdisc, dis_params, out["x"],
                                      out["y"])
        terms = {**out["dists"], "adversarial": adv, "feature_matching": fm,
                 "regularization": out["reg"] * jloop.schedules.beta_factor(
                     step, jcfg)}
        m = {f"loss_{k}": v for k, v in terms.items()}
        m["loss_gen_total"] = sum(v * jcfg.weights.get(k, 1.0)
                                  for k, v in terms.items())
        return m

    # the state and the batch are arguments, not constants of the program
    mj = jax.jit(jlosses)(gen_params, dis_params, model_state,
                          jnp.asarray(x))
    r = jax.random.split(jax.random.fold_in(rng, step), 4)
    eps = np.asarray(jax.random.normal(
        r[0], (cfg.batch_size, cfg.n_signal // cfg.total_ratio(),
               cfg.latent_size), jnp.float32))
    state = loop.TrainState(cfg, device="cpu", step=step)
    load_flax_params(state.model, gen_params)
    load_discriminator_params(state.disc, dis_params)
    mt = loop.make_train_step(cfg)(
        state, {"x": torch.from_numpy(x)},
        torch.from_numpy(np.ascontiguousarray(eps.transpose(0, 2, 1))))
    for k in mj:
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-3,
                                             abs=1e-7), k
    assert float(mt["loss_adversarial"]) != 0
    assert float(mt["loss_feature_matching"]) > 0
    assert float(mt["loss_dis"]) == 0
