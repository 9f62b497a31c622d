"""Kernels B2/B3 (the ci=1 head conv): the plain twins and the
``autograd.Function``'s CPU path against rave_tpu's Pallas kernels run in
interpret mode and against ``jax.grad`` of ``conv1d_ci1_pallas``.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these plain twins there.

Tolerances: atol 1e-5, rtol 1e-5 on the forward (15-term float32 sums,
as ``tests/test_pallas.py``); atol 1e-4, rtol 1e-4 on gradients, whose
sums run over 16 channels and, for ``dw``, the whole batch and time.  On
bf16 operands the twins equal the Pallas kernels bit for bit: both sum
in float32 and round once into bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops.pallas.ci1_conv import (_pallas_dx, _pallas_fwd,
                                          conv1d_ci1_pallas)
from rave_tpu_torch.ops.kernels import ci1_conv


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, T, k, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 1)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, 1, co))).astype(np.float32)
    g = rng.standard_normal((B, T, co)).astype(np.float32)
    return x, w, g


def _port(x, w, g=None):
    """JAX layouts -> the port's: x (B, 1, T), w (co, 1, k), g (B, co, T)."""
    out = [torch.from_numpy(x.transpose(0, 2, 1).copy()),
           torch.from_numpy(w.transpose(2, 1, 0).copy())]
    if g is not None:
        out.append(torch.from_numpy(g.transpose(0, 2, 1).copy()))
    return out


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as(dtype, *arrays):
    """The JAX operands in ``dtype`` and the port's (layouts converted)
    holding the same values."""
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in arrays]
    return jx, [t.to(tdt) for t in _port(*(np.asarray(a.astype(jnp.float32))
                                           for a in jx))]


def _equal_or_close(got, want, dtype, tol):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,pad", [(1000, (7, 7)), (4096, (7, 7)),
                                   (777, (14, 0))])
def test_plain_forward_matches_pallas_interpret(T, pad, dtype):
    x, w, _ = _inputs(2, T, sum(pad) + 1, 16, 0)
    (jx, jw), (xt, wt) = _as(dtype, x, w)
    want = _pallas_fwd(jx, jw, pad, tile=256, interpret=True)
    got = ci1_conv.conv1d_ci1_reference(xt, wt, pad)
    assert got.dtype == DTYPES[dtype][1]
    _equal_or_close(got.transpose(1, 2), want, dtype, 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,pad", [(1000, (7, 7)), (777, (14, 0))])
def test_plain_dx_matches_pallas_interpret(T, pad, dtype):
    x, w, g = _inputs(2, T, sum(pad) + 1, 16, 1)
    (_, jw, jg), (_, wt, gt) = _as(dtype, x, w, g)
    want = _pallas_dx(jg, jw, pad, T, tile=256, interpret=True)
    got = ci1_conv.conv1d_ci1_dx_reference(gt, wt, pad)
    assert got.dtype == DTYPES[dtype][1]
    _equal_or_close(got.transpose(1, 2), want, dtype, 1e-4)


@pytest.mark.parametrize("T,pad", [(8192, (7, 7)), (1000, (14, 0)),
                                   (333, (2, 2))])
def test_function_cpu_path_matches_jax_grad(T, pad):
    k = sum(pad) + 1
    x, w, g = _inputs(2, T, k, 16, 2)

    def loss(xx, ww):
        return jnp.sum(conv1d_ci1_pallas(xx, ww, pad) * jnp.asarray(g))

    y_j = np.asarray(conv1d_ci1_pallas(jnp.asarray(x), jnp.asarray(w), pad))
    dx_j, dw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    xt, wt, gt = (t.requires_grad_(i < 2)
                  for i, t in enumerate(_port(x, w, g)))
    y = ci1_conv.conv1d_ci1(xt, wt, pad)
    (y * gt).sum().backward()
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 1), y_j,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1),
                               np.asarray(dx_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 1, 0),
                               np.asarray(dw_j), atol=1e-4, rtol=1e-4)


def test_function_computes_only_the_gradients_asked_for():
    """A D step (input without gradient) needs no dx, a G step (frozen
    weights) no dw: the Function skips what autograd does not ask for."""
    x, w, _ = _inputs(1, 300, 15, 16, 3)
    xt, wt = _port(x, w)
    ci1_conv.conv1d_ci1(xt, wt.requires_grad_(True), (7, 7)).sum().backward()
    assert xt.grad is None and wt.grad is not None
    xt, wt = _port(x, w)
    ci1_conv.conv1d_ci1(xt.requires_grad_(True), wt, (7, 7)).sum().backward()
    assert xt.grad is not None and wt.grad is None


@pytest.mark.parametrize("bad", ["two_channels", "k17", "pad", "float64",
                                 "mixed"])
def test_cuda_wrapper_checks_before_launching(bad):
    """The launchers refuse what the kernels do not take; the checks run
    before any library is built, so they run here without a card."""
    x, w, _ = _inputs(1, 64, 15, 16, 4)
    xt, wt = _port(x, w)
    pad = (7, 7)
    if bad == "two_channels":
        xt = torch.cat([xt, xt], dim=1)
    elif bad == "k17":
        wt = torch.zeros(16, 1, 17)
        pad = (8, 8)
    elif bad == "pad":
        pad = (7, 8)
    elif bad == "mixed":
        xt = xt.to(torch.bfloat16)
    else:
        xt = xt.double()
    with pytest.raises((ValueError, TypeError)):
        ci1_conv.conv1d_ci1_cuda(xt, wt, pad)


def _dx_like_the_kernel(g, w, pad_right, misalign0):
    """Float32 kernel B3's data gradient in numpy, staged as the kernel
    stages: tiles of 1024 steps, each channel row copied in 16-byte
    pieces of 4 values from the aligned element before the
    window start (``misalign0`` is the misalignment, in values, of g's
    first element), zeros outside [0, T), and read ``shift`` values into
    the staged row.  B3-bf16 stages otherwise
    (``tests/test_torch_b3_bf16_tiles.py``)."""
    B, co, T = g.shape
    k = w.shape[-1]
    per = 4
    flat = g.reshape(-1)
    taps = w[:, 0, ::-1]                      # taps[c, o] = w[c, k-1-o]
    dx = np.zeros((B, T), np.float64)
    tile = 1024
    for b in range(B):
        for t0 in range(0, T, tile):
            ts = t0 - pad_right
            n_out = min(tile, T - t0)
            for c in range(co):
                base = (b * co + c) * T
                shift = (misalign0 + base + ts) % per
                e0 = base + ts - shift
                pieces = -(-(shift + tile + k - 1) // per)
                row = np.zeros(per * pieces)
                for q in range(pieces):
                    for i in range(per):
                        te = e0 + per * q + i - base
                        if 0 <= te < T:
                            row[per * q + i] = flat[e0 + per * q + i]
                for u in range(n_out):
                    dx[b, t0 + u] += row[shift + u:shift + u + k] @ taps[c]
    return dx[:, None, :]


@pytest.mark.parametrize("T,pad,co,misalign0", [
    (1001, (3, 4), 3, 0), (2050, (7, 7), 2, 1), (5, (0, 15), 1, 3)])
def test_dx_staging_matches_plain_dx(T, pad, co, misalign0):
    """The index arithmetic of B3's 16-byte staging (odd T, windows that
    start off a 16-byte boundary, pieces that straddle the ends)."""
    k = sum(pad) + 1
    _, w, g = _inputs(2, T, k, co, 5)
    _, wt, gt = _port(np.zeros((2, T, 1), np.float32), w, g)
    want = ci1_conv.conv1d_ci1_dx_reference(gt, wt, pad).numpy()
    got = _dx_like_the_kernel(gt.numpy().astype(np.float64),
                              wt.numpy().astype(np.float64), pad[1],
                              misalign0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_kernel_instances_by_dtype():
    """One instance per operand dtype, all in one source and library."""
    assert ci1_conv.kernels_for(torch.float32) == (ci1_conv.FORWARD,
                                                   ci1_conv.DX)
    assert ci1_conv.kernels_for(torch.bfloat16) == (ci1_conv.FORWARD_BF16,
                                                    ci1_conv.DX_BF16)
    assert len({k.library_path for k in (
        ci1_conv.FORWARD, ci1_conv.DX, ci1_conv.FORWARD_BF16,
        ci1_conv.DX_BF16)}) == 1
