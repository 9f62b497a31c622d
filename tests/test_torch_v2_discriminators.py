"""The port's v2 discriminators against rave_tpu's, on converted
parameters: every feature map of ``combine(periods, scales, spectral)``
(five MPD ladders, three MSD ladders, five Encodec spectral stacks), each
member alone, the 1-D spectral discriminator, ``multi_scale`` built from
a config, feature matching over the combine's real and fake halves, and
the input gradient of a scalar of every feature.

The JAX spectral stacks run their packed-resident formulation; their
features are compared after ``PackedFeature.unpack()`` (the port's
``(B, C, F, frames)`` transposed to ``(B, F, frames, C)``).  Features
rtol/atol 2e-4 (as ``tests/test_torch_discriminators.py``), feature
matching rtol 1e-4 (a float32 mean over each map, summed over 47 maps),
the gradient atol 1e-3 of its largest element (float32 through STFTs
and up to 512-channel convs).  Inputs are short (4096 samples): the MPD
keeps its 64-512 channels whatever ``discriminator.capacity`` is.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models import discriminators as jd
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_discriminator_params
from rave_tpu_torch.models import discriminators as td
from rave_tpu_torch.train import loop

B, T = 2, 4096
SPECTRAL = (4096, 1024, 256)
MEMBERS = ("periods", "scales", "spectral")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unpack(f):
    return np.asarray(f.unpack() if isinstance(f, jd.PackedFeature) else f)


def _to_jax_layout(f: torch.Tensor) -> np.ndarray:
    """Port (B, C, T) / (B, C, H, W) -> JAX (B, T, C) / (B, H, W, C)."""
    f = f.detach().numpy()
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 2, 3, 1)


def _torch_x(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.transpose(0, 2, 1).copy())


def _init(jdisc, x):
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params["params"])
    return params, jax.jit(jdisc.apply)({"params": params}, jnp.asarray(x))


@pytest.fixture(scope="module")
def combine():
    x = (0.3 * np.random.default_rng(0).standard_normal((B, T, 1))
         ).astype(np.float32)
    jdisc = jd.CombineDiscriminators(members=MEMBERS, capacity=4,
                                     spectral_scales=SPECTRAL)
    params, feats = _init(jdisc, x)
    disc = td.CombineDiscriminators(MEMBERS, 4, SPECTRAL)
    load_discriminator_params(disc, params)
    return dict(x=x, params=params, jdisc=jdisc, disc=disc, jfeats=feats,
                feats=[[_unpack(f) for f in chain] for chain in feats])


def _compare(got_chains, want_chains):
    assert len(got_chains) == len(want_chains)
    for i, (got, want) in enumerate(zip(got_chains, want_chains)):
        assert len(got) == len(want), i
        for j, (g, w) in enumerate(zip(got, want)):
            g = _to_jax_layout(g)
            assert g.shape == w.shape, (i, j, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"chain {i} feature {j}")


def test_combine_features_match(combine):
    with torch.no_grad():
        got = combine["disc"](_torch_x(combine["x"]))
    assert len(got) == 5 + 3 + len(SPECTRAL)
    assert [n for n, _ in combine["disc"].named_children()] == [
        "mpd", "msd", "msspec"]
    _compare(got, combine["feats"])


@pytest.mark.parametrize("name,make,first", [
    ("mpd", lambda: td.MultiPeriodDiscriminator(), 0),
    ("msd", lambda: td.MultiScaleDiscriminator(capacity=4), 5),
    ("msspec", lambda: td.MultiScaleSpectralDiscriminator(SPECTRAL), 8)])
def test_each_member_matches(combine, name, make, first):
    """Each member loads its own subtree (the spectral one the packed
    tree, unchanged) and gives its chains of the combined output."""
    module = make()
    load_discriminator_params(module, combine["params"][name])
    with torch.no_grad():
        got = module(_torch_x(combine["x"]))
    _compare(got, combine["feats"][first:first + len(got)])


def test_spectral_1d_matches():
    x = (0.3 * np.random.default_rng(1).standard_normal((B, 2048, 1))
         ).astype(np.float32)
    scales = (512, 256)
    params, feats = _init(jd.MultiScaleSpectralDiscriminator1d(
        scales=scales, capacity=4), x)
    module = td.MultiScaleSpectralDiscriminator1d(scales, 4)
    load_discriminator_params(module, params)
    with torch.no_grad():
        got = module(_torch_x(x))
    _compare(got, [[_unpack(f) for f in chain] for chain in feats])
    with pytest.raises(ValueError, match="needs at least 4096 samples"):
        td.MultiScaleSpectralDiscriminator1d((4096,), 4)(_torch_x(x))


def test_build_multi_scale_matches():
    over = ["discriminator.kind=multi_scale", "discriminator.capacity=4",
            "discriminator.n_layers=2"]
    x = (0.3 * np.random.default_rng(2).standard_normal((B, T, 1))
         ).astype(np.float32)
    params, feats = _init(jloop.build_discriminator(jbuild(["v2"], over)), x)
    disc = td.build_discriminator(build_config(["v2"], over), "cpu")
    assert isinstance(disc, td.MultiScaleDiscriminator)
    load_discriminator_params(disc, params)
    with torch.no_grad():
        got = disc(_torch_x(x))
    _compare(got, [[_unpack(f) for f in chain] for chain in feats])


@pytest.mark.parametrize("relative", [True, False])
def test_feature_matching_matches(combine, relative):
    """Real = first item, fake = second: the JAX means run over packed
    maps (with the ``valid_frac`` correction where not relative), the
    port's over native ones."""
    over = [f"feature_matching_relative={str(relative).lower()}"]
    jcfg, cfg = jbuild(["v2"], over), build_config(["v2"], over)
    take = lambda f, sl: (f.replace(data=f.data[sl])  # noqa: E731
                          if isinstance(f, jd.PackedFeature) else f[sl])
    want = jax.jit(lambda jf: jloop._feature_matching(
        jcfg, [[take(f, slice(0, 1)) for f in c] for c in jf],
        [[take(f, slice(1, 2)) for f in c] for c in jf]))(combine["jfeats"])
    with torch.no_grad():
        tf = combine["disc"](_torch_x(combine["x"]))
    got = loop._feature_matching(cfg, [[f[:1] for f in c] for c in tf],
                                 [[f[1:] for f in c] for c in tf])
    assert float(got) == pytest.approx(float(want), rel=1e-4)


def test_input_gradient_matches(combine):
    jdisc, params = combine["jdisc"], combine["params"]

    def jscalar(x, params):
        feats = jdisc.apply({"params": params}, x)
        return sum(jnp.mean(_unpack_traced(f) ** 2)
                   for chain in feats for f in chain)

    def _unpack_traced(f):
        return f.unpack() if isinstance(f, jd.PackedFeature) else f

    # the weights are an argument, not constants of the program (XLA
    # would fold through them while compiling)
    want = np.asarray(jax.jit(jax.grad(jscalar))(jnp.asarray(combine["x"]),
                                                 params))
    x = _torch_x(combine["x"]).requires_grad_(True)
    sum(torch.mean(f ** 2) for chain in combine["disc"](x)
        for f in chain).backward()
    got = x.grad.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_spectral_scale_longer_than_signal_raises(combine):
    with pytest.raises(ValueError, match="scale 4096 needs at least 4096"):
        combine["disc"].msspec(_torch_x(combine["x"])[:, :, :2048])


def test_converter_rejects_stray_and_missing_leaves(combine):
    params = copy.deepcopy(combine["params"])
    params["msspec"]["spec1"]["WNConv_3"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused"):
        load_discriminator_params(td.CombineDiscriminators(MEMBERS, 4,
                                                           SPECTRAL), params)
    del params["msspec"]["spec1"]["WNConv_3"]["stray"]
    conv = params["mpd"]["period2"].pop("WNConv_4")
    with pytest.raises(KeyError, match="period2/WNConv_4"):
        load_discriminator_params(td.CombineDiscriminators(MEMBERS, 4,
                                                           SPECTRAL), params)
    params["mpd"]["period2"]["WNConv_4"] = conv
    del params["msd"]
    with pytest.raises(KeyError, match="msd"):
        load_discriminator_params(td.CombineDiscriminators(MEMBERS, 4,
                                                           SPECTRAL), params)
