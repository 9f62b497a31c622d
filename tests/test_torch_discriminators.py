"""The port's ``v2_fork`` discriminators against rave_tpu's, on converted
parameters: every feature map of the three MRDs, the five MPDs, the
three MelGAN discriminators of the stack and their combination, and the
input gradient of a scalar of all of them.

The JAX MRD runs its packed-resident formulation; its features are
compared after ``PackedFeature.unpack()`` at rtol/atol 2e-4 (as
``tests/test_discriminators.py``), every feature at that tolerance.  The
input has 8192 samples, so the first MelGAN head takes the ci=1 path
(the kernels' plain twins here).  The gradient: atol 1e-3 of its largest
element (float32 through STFT magnitudes and up to 1024-channel convs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.models import discriminators as jd
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_discriminator_params
from rave_tpu_torch.models import discriminators as td

B, T = 2, 8192


def _unpack(f):
    return np.asarray(f.unpack() if isinstance(f, jd.PackedFeature) else f)


def _to_jax_layout(f: torch.Tensor) -> np.ndarray:
    """Port (B, C, T) / (B, C, H, W) -> JAX (B, T, C) / (B, H, W, C)."""
    f = f.detach().numpy()
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def combine():
    x = (0.3 * np.random.default_rng(0).standard_normal((B, T, 1))
         ).astype(np.float32)
    jdisc = jd.CombineDiscriminators(members=("univnet", "melgan_stack"))
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params["params"])
    feats = jax.jit(jdisc.apply)({"params": params}, jnp.asarray(x))
    disc = td.CombineDiscriminators(("univnet", "melgan_stack"))
    load_discriminator_params(disc, params)
    return dict(x=x, params=params, jdisc=jdisc, disc=disc,
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
        got = combine["disc"](torch.from_numpy(
            combine["x"].transpose(0, 2, 1).copy()))
    assert len(got) == td.member_sub_count("univnet") + td.member_sub_count(
        "melgan_stack")
    _compare(got, combine["feats"])


@pytest.mark.parametrize("member,sub,index", [
    ("univnet", "mrd0", 0), ("univnet", "mrd2", 2), ("univnet", "mpd0", 3),
    ("univnet", "mpd4", 7), ("stack", "stack0", 8), ("stack", "stack2", 10)])
def test_each_sub_discriminator_matches(combine, member, sub, index):
    """Each class loads its own subtree and gives its chain of the
    combined output (stack{i} reads the i-times-pooled input)."""
    tree = combine["params"][member][sub]
    if sub.startswith("mrd"):
        res = ((5, 25), (10, 50), (2, 10))[int(sub[-1])]
        module = td.UnivNetResolutionDiscriminator(res)
    elif sub.startswith("mpd"):
        module = td.UnivNetPeriodDiscriminator((2, 3, 5, 7, 11)[int(sub[-1])])
    else:
        module = td.MelGANDiscriminator()
    load_discriminator_params(module, tree)
    x = torch.from_numpy(combine["x"].transpose(0, 2, 1).copy())
    for _ in range(int(sub[-1]) if sub.startswith("stack") else 0):
        x = td._avg_pool_1d(x)
    with torch.no_grad():
        _compare([module(x)], [combine["feats"][index]])


def test_stack_matches(combine):
    stack = td.StackDiscriminators()
    load_discriminator_params(stack, combine["params"]["stack"])
    with torch.no_grad():
        got = stack(torch.from_numpy(combine["x"].transpose(0, 2, 1).copy()))
    _compare(got, combine["feats"][8:])


def test_input_gradient_matches(combine):
    jdisc, params = combine["jdisc"], combine["params"]

    def scalar(x, feats):
        return sum(jnp.mean(f.astype(jnp.float32) ** 2)
                   for chain in feats for f in chain)

    def jscalar(x, params):
        feats = jdisc.apply({"params": params}, x)
        feats = [[f.unpack() if isinstance(f, jd.PackedFeature) else f
                  for f in chain] for chain in feats]
        return scalar(x, feats)

    # the weights are an argument, not constants of the program (XLA
    # would fold through them for half a minute while compiling)
    want = np.asarray(jax.jit(jax.grad(jscalar))(jnp.asarray(combine["x"]),
                                                 params))
    x = torch.from_numpy(combine["x"].transpose(0, 2, 1).copy())
    x.requires_grad_(True)
    sum(torch.mean(f ** 2) for chain in combine["disc"](x)
        for f in chain).backward()
    got = x.grad.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_build_and_unported_members_raise():
    cfg = build_config(["v2_fork"])
    assert isinstance(td.build_discriminator(cfg, "cpu"),
                      td.CombineDiscriminators)
    v2 = td.build_discriminator(build_config(["v2"]), "cpu")
    assert isinstance(v2, td.CombineDiscriminators)
    assert [n for n, _ in v2.named_children()] == ["mpd", "msd", "msspec"]
    # every kind is ported now: v3's Descript discriminator builds, an
    # unknown kind or member raises
    assert isinstance(td.build_discriminator(build_config(["v3"]), "cpu"),
                      td.DescriptDiscriminator)
    with pytest.raises(ValueError, match="unknown discriminator kind"):
        td.build_discriminator(build_config(
            ["v2"], ["discriminator.kind=nope"]), "cpu")
    with pytest.raises(ValueError, match="unknown discriminator member"):
        td.CombineDiscriminators(("nope",))


def test_converter_rejects_stray_and_missing_leaves(combine):
    import copy
    params = copy.deepcopy(combine["params"])
    params["stack"]["stack0"]["WNConv_0"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused"):
        load_discriminator_params(td.StackDiscriminators(), params["stack"])
    del params["stack"]["stack0"]["WNConv_0"]["stray"]
    del params["stack"]["stack1"]["WNConv_2"]
    with pytest.raises(KeyError):
        load_discriminator_params(td.StackDiscriminators(), params["stack"])
