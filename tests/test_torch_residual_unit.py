"""Kernel B1's plain twin vs the JAX package's fused dilated unit, the
autograd.Function's backward, the wrapper's checks and the fusion gate.

Tolerances: value atol 2e-4 / rtol 2e-3 and gradient atol 1e-3 / rtol 1e-3
(the JAX package's own kernel tolerance; float32 sums of 512 terms in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models import blocks as jblocks
from rave_tpu.ops.pallas.residual_unit import (_reference_impl,
                                               fused_dilated_unit)
from rave_tpu_torch.config import build_config
from rave_tpu_torch.models.blocks import Residual
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.ops.kernels import KERNELS, residual_unit as ru

VAL = dict(atol=2e-4, rtol=2e-3)
GRAD = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(C=128, T=200, B=2, k=3, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, T, C), f(k, C, C) * 0.05, f(C) * 0.1, f(C, C) * 0.05,
            f(C) * 0.1)


def _to_port(x, w1, b1, w2, b2):
    """JAX layouts -> the port's: x (B,C,T), w1 (co,ci,k), w2 (co,ci)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(x.transpose(0, 2, 1)), t(w1.transpose(2, 1, 0)), t(b1),
            t(w2.T), t(b2))


def _pads(d, k=3):
    p = (k - 1) * d
    return (p + 1) // 2, p // 2


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_plain_matches_jax_value(dilation):
    args = _inputs(seed=dilation)
    pl, pr = _pads(dilation)
    want_ref = np.asarray(_reference_impl(*map(jnp.asarray, args), dilation,
                                          pl, pr))
    want_fused = np.asarray(fused_dilated_unit(*map(jnp.asarray, args),
                                               dilation, pl, pr))
    targs = _to_port(*args)
    got = ru.residual_unit_reference(*targs, dilation, pl, pr)
    dispatched = ru.residual_unit(*targs, dilation, pl, pr)  # CPU -> plain
    got = got.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want_ref, **VAL)
    np.testing.assert_allclose(got, want_fused, **VAL)
    np.testing.assert_array_equal(dispatched.numpy().transpose(0, 2, 1), got)


def _jax_grads(args, dilation, pl, pr):
    x, w1, b1, w2, b2 = map(jnp.asarray, args)

    def loss(x, w1):
        return jnp.sum(fused_dilated_unit(x, w1, b1, w2, b2, dilation, pl,
                                          pr) ** 2)
    gx, gw1 = jax.grad(loss, argnums=(0, 1))(x, w1)
    return np.asarray(gx), np.asarray(gw1)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_plain_matches_jax_grad(dilation):
    args = _inputs(T=96, B=1, seed=10 + dilation)
    pl, pr = _pads(dilation)
    gx_j, gw_j = _jax_grads(args, dilation, pl, pr)
    x, w1, b1, w2, b2 = _to_port(*args)
    x.requires_grad_(True)
    w1.requires_grad_(True)
    y = ru.residual_unit_reference(x, w1, b1, w2, b2, dilation, pl, pr)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 1), gx_j, **GRAD)
    np.testing.assert_allclose(w1.grad.numpy().transpose(2, 1, 0), gw_j,
                               **GRAD)


def test_function_backward_matches_jax_grad(monkeypatch):
    """The autograd.Function's backward (autograd of the plain
    composition), with the forward launch swapped for the plain twin so
    that it runs on the CPU."""
    monkeypatch.setattr(ru, "residual_unit_cuda", ru.residual_unit_reference)
    dilation = 3
    args = _inputs(T=80, B=2, seed=7)
    pl, pr = _pads(dilation)
    gx_j, gw_j = _jax_grads(args, dilation, pl, pr)
    x, w1, b1, w2, b2 = _to_port(*args)
    for t in (x, w1, b1, w2, b2):
        t.requires_grad_(True)
    y = ru._ResidualUnit.apply(x, w1, b1, w2, b2, dilation, pl, pr)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 1), gx_j, **GRAD)
    np.testing.assert_allclose(w1.grad.numpy().transpose(2, 1, 0), gw_j,
                               **GRAD)
    assert b1.grad is not None and w2.grad is not None and b2.grad is not None


# B1's bf16 backward against the JAX package's bf16 VJP of the same unit,
# per operand (x, w1, b1, w2, b2) the relative L2 distance, the bf16 port
# within and the float32 port of the same operands beyond (measured:
# bf16 port / float32 port)
BF16_VJP_TOL = {"x": 5e-4,    # 0 / 2.9e-3
                "w1": 1e-3,   # 1.9e-5 / 9.0e-3
                "b1": 5e-4,   # 0 / 8.5e-3
                "w2": 5e-4,   # 6.2e-5 / 3.0e-3
                "b2": 3e-4}   # 0 / 1.8e-3


def test_bf16_function_backward_matches_jax_vjp(monkeypatch):
    """The arithmetic of B1-bf16's backward (autograd of the bf16 twin):
    the autograd.Function's gradients of all five operands, the forward
    launch swapped for the twin, against the VJP of the JAX package's
    unfused unit (``Residual`` over a ``DilatedUnit``, what its bf16 train
    step differentiates: the fused unit's ``custom_vjp`` backward, a VJP
    of ``_reference_impl``, raises on bf16 operands, ROADMAP C) on the
    same bf16 operands and cotangent, compiled with XLA's excess
    precision off.  XLA on the CPU sums a bf16 bias gradient in bf16, so
    each bias is held against the float32 sum of the JAX cotangent at its
    conv's output (read as the gradient of a zero added there by flax's
    method interceptor), rounded once to bf16.  The float32 port is the
    control."""
    import flax.linen as fnn

    monkeypatch.setattr(ru, "residual_unit_cuda", ru.residual_unit_reference)
    dilation, C = 3, 128
    pl, pr = _pads(dilation)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)  # noqa: E731
                              .astype(jnp.float32))
    x, w1, b1, w2, b2 = map(bf, _inputs(C=C, T=80, B=2, seed=8))
    g = jnp.asarray(np.random.default_rng(9).standard_normal(x.shape),
                    jnp.bfloat16)
    unit = jblocks.Residual(inner=jblocks.DilatedUnit(
        dim=C, kernel_size=3, dilation=dilation, weight_norm=False),
        inner_delay=0)
    params = {"params": {"inner": {
        "Conv1d_0": {"kernel": w1, "bias": b1},
        "Conv1d_1": {"kernel": w2[None], "bias": b2}}}}
    xb = jnp.asarray(x, jnp.bfloat16)
    zeros = [jnp.zeros(x.shape, jnp.bfloat16)] * 2

    def run(p, a, deltas):
        added = iter(deltas)

        def add(next_fun, args, kwargs, ctx):
            y = next_fun(*args, **kwargs)
            conv = (type(ctx.module).__name__ == "Conv1d"
                    and ctx.method_name == "__call__")
            return y + next(added) if conv else y

        with fnn.intercept_methods(add):
            return unit.apply(p, a)

    def vjp(p, a, deltas):
        return jax.vjp(run, p, a, deltas)[1](g)

    gp, gx, gd = jax.jit(vjp).lower(params, xb, zeros).compile(
        compiler_options={"xla_allow_excess_precision": False})(
            params, xb, zeros)
    convs = gp["params"]["inner"]

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    def bias(c):
        return f32(jnp.sum(c.astype(jnp.float32), (0, 1)).astype(
            jnp.bfloat16))

    want = [f32(gx).transpose(0, 2, 1),
            f32(convs["Conv1d_0"]["kernel"]).transpose(2, 1, 0), bias(gd[0]),
            f32(convs["Conv1d_1"]["kernel"])[0].T, bias(gd[1])]
    gt = torch.from_numpy(f32(g).transpose(0, 2, 1).copy())
    dist = {}
    for dtype in (torch.bfloat16, torch.float32):
        ops = [t.to(dtype).requires_grad_(True)
               for t in _to_port(x, w1, b1, w2, b2)]
        ru._ResidualUnit.apply(*ops, dilation, pl, pr).backward(gt.to(dtype))
        assert all(t.grad.dtype == dtype for t in ops)
        dist[dtype] = {n: float(np.linalg.norm(t.grad.float().numpy() - w)
                                / np.linalg.norm(w))
                       for n, t, w in zip(BF16_VJP_TOL, ops, want)}
    print("bf16 port", dist[torch.bfloat16], "float32 port",
          dist[torch.float32])
    for n, tol in BF16_VJP_TOL.items():
        assert dist[torch.bfloat16][n] <= tol < dist[torch.float32][n], (
            n, dist[torch.bfloat16][n], dist[torch.float32][n], tol)


def _contract_like_the_kernel(x, w1k, b1, w2k, b2, dilation, pad_left):
    """The unit computed in float64 from the operands as kernel B1 reads
    them, tile by tile as its grid does: CTAs of 64 output channels x 64
    time steps, each reading lrelu(x) over [t0 - pad_left, t0 + 64 +
    (k - 1) * d - pad_left), zero outside [0, T), tap j at column offset
    j * d, then W2's rows over the hidden channels of all the cluster's
    CTAs."""
    x, w1k, b1, w2k, b2 = (a.double().numpy() for a in (x, w1k, b1, w2k, b2))
    B, C, T = x.shape
    k = w1k.shape[0]
    tile, group = 64, 64
    out = np.empty_like(x)
    lx = np.where(x >= 0, x, 0.2 * x)
    for b in range(B):
        for t0 in range(0, T, tile):
            win = tile + (k - 1) * dilation
            t = t0 - pad_left + np.arange(win)
            inside = (t >= 0) & (t < T)
            window = np.zeros((C, win))
            window[:, inside] = lx[b][:, t[inside]]
            hidden = np.empty((C, tile))
            for g in range(0, C, group):          # the cluster's CTAs
                acc = sum(w1k[j, g:g + group] @ window[:, j * dilation:
                                                        j * dilation + tile]
                          for j in range(k)) + b1[g:g + group, None]
                hidden[g:g + group] = np.where(acc >= 0, acc, 0.2 * acc)
            n = min(tile, T - t0)
            for g in range(0, C, group):
                y = w2k[g:g + group] @ hidden + b2[g:g + group, None]
                out[b, g:g + group, t0:t0 + n] = (x[b, g:g + group, t0:t0 + n]
                                                  + y[:, :n])
    return out


@pytest.mark.parametrize("dilation", [1, 9])
def test_prepared_operands_contract_to_the_unit(dilation):
    """The K-major operands the wrapper hands kernel B1 (w1 as (k, C_out,
    C_in), w2 as (out, in)), contracted as the kernel's grid does, give
    the plain composition; the transposed layout of w1 does not."""
    x, w1, b1, w2, b2 = _to_port(*_inputs(C=128, T=200, B=2,
                                          seed=20 + dilation))
    pl, pr = _pads(dilation)
    w1k, w2k = ru.prepare_weights(w1, w2)
    assert w1k.shape == (3, 128, 128) and w1k.is_contiguous()
    assert w2k.shape == (128, 128) and w2k.is_contiguous()
    want = ru.residual_unit_reference(x, w1, b1, w2, b2, dilation, pl,
                                      pr).numpy()
    got = _contract_like_the_kernel(x, w1k, b1, w2k, b2, dilation, pl)
    np.testing.assert_allclose(got, want, **VAL)
    swapped = _contract_like_the_kernel(x, w1k.transpose(1, 2), b1, w2k, b2,
                                        dilation, pl)
    assert np.abs(swapped - want).max() > 100 * VAL["atol"]


@pytest.mark.parametrize("bad", ["channels", "dtype", "padding", "shape"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    C = 64 if bad == "channels" else 128
    x, w1, b1, w2, b2 = _to_port(*_inputs(C=C, T=16, B=1))
    pl, pr = _pads(3)
    if bad == "dtype":
        x = x.double()
    if bad == "padding":
        pr += 1
    if bad == "shape":
        w2 = w2[:, :64]
    with pytest.raises((ValueError, TypeError)):
        ru.residual_unit_cuda(x, w1, b1, w2, b2, 3, pl, pr)
    assert ru.KERNEL.launches == 0


def test_kernel_registry():
    from rave_tpu_torch.ops.kernels import ci1_conv as ci
    assert KERNELS[0] is ru.KERNEL and len(KERNELS) == 6
    assert KERNELS[3] is ru.KERNEL_BF16
    assert KERNELS[4:] == [ci.FORWARD_BF16, ci.DX_BF16]
    assert ru.KERNEL_BF16.library_path == ru.KERNEL.library_path
    assert all(k.source.is_file() for k in KERNELS)
    assert ru.KERNEL.library_path.parent.name == "_build"


def _jax_units(cfg, streaming):
    """(dim, dilation, fusable) of every JAX residual unit, in build order."""
    ss = jblocks.StreamSetup(streaming=streaming)
    enc = jblocks.EncoderV2(data_size=16, capacity=cfg.capacity,
                            ratios=cfg.ratios, latent_size=cfg.latent_size,
                            n_out=2, kernel_size=cfg.kernel_size,
                            dilations=cfg.dilations, ss=ss)
    out = []
    for kind, kw in enc._walk()[0]:
        if kind == "residual_unit":
            du = jblocks.DilatedUnit(dim=kw["dim"], kernel_size=3,
                                     dilation=kw["dilation"], ss=ss)
            out.append((kw["dim"], kw["dilation"], du.fusable(kw["dim"])))
    gen = jblocks.GeneratorV2(data_size=16, capacity=cfg.capacity,
                              ratios=cfg.ratios, latent_size=cfg.latent_size,
                              kernel_size=3, dilations=cfg.dilations, ss=ss)
    dils, ratios, ch = gen._plan()
    for r, ds in zip(ratios, dils):
        ch //= 2
        for d in ds:
            du = jblocks.DilatedUnit(dim=ch, kernel_size=3, dilation=d, ss=ss)
            out.append((ch, d, du.fusable(ch)))
    return out


@pytest.mark.parametrize("streaming", [False, True])
def test_fusable_gate_matches_jax_on_full_v2(streaming):
    jc = jbuild(["v2"], ["fused_kernels=true"])
    want = _jax_units(jc, streaming)
    model = RAVE(build_config(["v2"], ["fused_kernels=true"]),
                 streaming=streaming, device="cpu")
    got = [(m.inner.dim, m.inner.dilation, m.inner.fusable(m.inner.dim))
           for m in model.modules() if isinstance(m, Residual)]
    assert got == want
    assert len(got) == 22
    assert sum(f for *_, f in got) == (0 if streaming else 16)
