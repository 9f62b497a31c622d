"""Port RAVE v2 vs rave_tpu's RAVE on the same converted parameters:
encode (variational mean) and the full encode -> decode, offline.

Tolerance: atol 1e-4 times the mean magnitude of the compared tensor at
full width and 2e-5 absolute on the small models (float32 through ~50
convs, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models.latent import VariationalHead as JVariationalHead
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.models.latent import VariationalHead
from rave_tpu_torch.models.rave import RAVE

TINY = ["capacity=4", "ratios=[2,2]", "dilations=[[1,3],[1,3]]"]
WIDE = ["capacity=64", "ratios=[2,2]", "dilations=[[1,3],[1,3]]"]


def _jax_model(stack, over, T, seed=0):
    cfg = jbuild(stack, over)
    m = JRAVE(cfg=cfg, train_mode=False)
    x = (np.random.default_rng(seed).standard_normal((1, T, 1)) * 0.3
         ).astype(np.float32)
    v = jax.jit(m.init)({"params": jax.random.PRNGKey(seed),
                         "latent": jax.random.PRNGKey(1),
                         "noise": jax.random.PRNGKey(2)}, jnp.asarray(x))
    return m, jax.tree.map(np.asarray, v["params"]), x


def _port(stack, over, params):
    model = RAVE(build_config(stack, over), device="cpu")
    load_flax_params(model, params)
    return model


def _compare(stack, over, T, atol, rel=False):
    m, params, x = _jax_model(stack, over, T)
    v = {"params": params}
    z_j = np.asarray(jax.jit(lambda v, a: m.apply(v, a, method=JRAVE.encode))(
        v, jnp.asarray(x)))
    y_j = np.asarray(jax.jit(lambda v, a: m.apply(v, a))(v, jnp.asarray(x)))
    model = _port(stack, over, params)
    with torch.no_grad():
        z_t = model.encode(torch.from_numpy(x)).numpy()
        y_t = model(torch.from_numpy(x)).numpy()
    assert z_t.shape == z_j.shape and y_t.shape == y_j.shape == x.shape
    for got, want in ((z_t, z_j), (y_t, y_j)):
        scale = np.abs(want).mean() if rel else 1.0
        np.testing.assert_allclose(got, want, atol=atol * scale)


def test_converter_uses_every_leaf_and_fills_every_param():
    _, params, _ = _jax_model(["v2"], TINY, 1024)
    model = RAVE(build_config(["v2"], TINY), device="cpu")
    load_flax_params(model, params)  # raises on any mismatch
    extra = jax.tree.map(lambda a: a, params)
    extra["encoder"]["Conv1d_0"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises((ValueError, KeyError)):
        load_flax_params(model, extra)
    missing = jax.tree.map(lambda a: a, params)
    del missing["decoder"]["DilatedUnit_0"]["Conv1d_1"]["bias"]
    with pytest.raises(ValueError, match="unfilled"):
        load_flax_params(model, missing)


def test_tiny_v2_offline_matches():
    _compare(["v2"], TINY, 4096, atol=2e-5)


def test_tiny_v2_causal_offline_matches():
    _compare(["v2", "causal"], TINY, 4096, atol=2e-5)


@pytest.mark.parametrize("fused", ["false", "true"])
def test_wide_v2_offline_matches(fused):
    """capacity 64 reaches the fusable widths 128 and 256."""
    _compare(["v2"], WIDE + [f"fused_kernels={fused}"], 8192, atol=2e-5)


def test_full_width_v2_offline_matches():
    _compare(["v2"], ["fused_kernels=true"], 8192, atol=1e-4, rel=True)


def test_variational_head_sampling_matches():
    """Sampling with an explicit eps equals the JAX head's draw from a key
    (the same normal numbers, transposed); atol 1e-6 (elementwise f32)."""
    z = np.random.default_rng(5).standard_normal((2, 12, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    zs_j, kl_j = JVariationalHead().apply({}, jnp.asarray(z), key)
    eps = np.asarray(jax.random.normal(key, (2, 12, 4), jnp.float32))
    head = VariationalHead()
    zs_t, kl_t = head(torch.from_numpy(z.transpose(0, 2, 1).copy()),
                      eps=torch.from_numpy(eps.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(zs_t.numpy().transpose(0, 2, 1), zs_j,
                               atol=1e-6)
    np.testing.assert_allclose(kl_t.item(), float(kl_j), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    zs_g, _ = head(torch.from_numpy(z.transpose(0, 2, 1).copy()),
                   generator=g)
    assert zs_g.shape == (2, 4, 12) and bool(torch.isfinite(zs_g).all())
    with pytest.raises(ValueError, match="eps or a generator"):
        head(torch.from_numpy(z.transpose(0, 2, 1).copy()))


@pytest.mark.parametrize("over", [["encoder_version=v1"],
                                  ["use_mel_encoder=true"],
                                  ["use_noise=true"],
                                  ["compute_dtype=bfloat16"],
                                  ["noise_augmentation=4"],
                                  ["latent_head=wasserstein"]])
def test_unsupported_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        RAVE(build_config(["v2"], TINY + over), device="cpu")


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RAVE(build_config(["v2"], TINY))
