"""Single-input-channel same-length conv (kernels B2 and B3): CUDA
kernels, plain twins, and the ``autograd.Function`` around them.

Port of ``rave_tpu/ops/pallas/ci1_conv.py``, the MelGAN discriminator's
head conv (k = 15, 1 -> 16 channels, stride 1).  :func:`conv1d_ci1`
computes ``F.conv1d(F.pad(x, pad), w)``: its forward is kernel B2
(``csrc/ci1_conv.cu`` ``ci1_conv_forward``), its data gradient kernel B3
(``ci1_conv_dx``), and its weight gradient keeps the library rule
(``torch.nn.grad.conv1d_weight``), as the JAX package keeps XLA's.  On a
CPU tensor each step runs its plain PyTorch twin, and only for that
reason; on a CUDA tensor it launches the kernel or raises.

The operands are all float32 (``FORWARD``, ``DX``) or all bf16
(``FORWARD_BF16``, ``DX_BF16``: the Pallas kernels' contract on bf16,
float32 sums rounded once into bf16); :func:`kernels_for` picks the
instance by dtype.  The plain twins run in the operands' dtype: on bf16
CPU tensors PyTorch's conv and its data gradient also sum in float32
and round once.

Layouts are the port's: ``x`` ``(B, 1, T)``, ``w`` ``(co, 1, k)`` (the
``F.conv1d`` weight), output ``(B, co, T)``, ``pad = (left, right)`` with
``left + right == k - 1``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CudaKernel

MAX_TAPS = 16
MAX_CHANNELS = 64

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
FORWARD = CudaKernel("ci1_conv_forward", "ci1_conv.cu", "ci1_conv_forward",
                     _ARGS)
DX = CudaKernel("ci1_conv_dx", "ci1_conv.cu", "ci1_conv_dx", _ARGS)
FORWARD_BF16 = CudaKernel("ci1_conv_forward_bf16", "ci1_conv.cu",
                          "ci1_conv_forward_bf16", _ARGS)
DX_BF16 = CudaKernel("ci1_conv_dx_bf16", "ci1_conv.cu", "ci1_conv_dx_bf16",
                     _ARGS)
# per operand dtype: the forward, the data gradient, the symbol that
# reports the data gradient's launch and the fields it reports
INSTANCES = {
    torch.float32: (FORWARD, DX, "ci1_conv_dx_launch_info",
                    ("blocks", "threads", "smem_bytes", "registers")),
    torch.bfloat16: (FORWARD_BF16, DX_BF16, "ci1_conv_dx_bf16_launch_info",
                     ("blocks", "threads", "smem_bytes", "registers",
                      "stages", "tma")),
}


def kernels_for(dtype: torch.dtype) -> tuple[CudaKernel, CudaKernel]:
    """The ``(forward, data gradient)`` instances of an operand dtype."""
    return INSTANCES[dtype][:2]


def conv1d_ci1_reference(x, w, pad) -> torch.Tensor:
    """Plain forward: ``(B, 1, T)`` -> ``(B, co, T)``."""
    return F.conv1d(F.pad(x, pad), w)


def conv1d_ci1_dx_reference(g, w, pad) -> torch.Tensor:
    """Plain data gradient: ``g (B, co, T)`` -> ``(B, 1, T)``."""
    B, _, T = g.shape
    dxp = torch.nn.grad.conv1d_input((B, 1, T + pad[0] + pad[1]), w, g)
    return dxp[:, :, pad[0]:pad[0] + T]


def _check(name, big, w, pad, channels: int) -> None:
    if big.device != w.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if big.dtype not in INSTANCES or w.dtype != big.dtype:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {big.dtype} and "
                        f"{w.dtype}")
    co, ci, k = w.shape
    if ci != 1 or not 1 <= k <= MAX_TAPS or not 1 <= co <= MAX_CHANNELS:
        raise ValueError(f"{name}: w {tuple(w.shape)} is outside the "
                         f"kernel's range (one input channel, k <= "
                         f"{MAX_TAPS}, co <= {MAX_CHANNELS})")
    if big.dim() != 3 or big.shape[1] != channels:
        raise ValueError(f"{name}: tensor {tuple(big.shape)} does not fit "
                         f"w {tuple(w.shape)}")
    pl, pr = pad
    if pl < 0 or pr < 0 or pl + pr != k - 1:
        raise ValueError(f"{name}: padding {pad} must keep the length "
                         f"(left + right == k - 1)")


def _launch(kernel, big, w, pad_arg, out) -> None:
    B, _, T = big.shape
    if out.data_ptr() % 16:
        raise ValueError(f"{kernel.name}: output must be 16-byte aligned")
    with torch.cuda.device(big.device):
        stream = torch.cuda.current_stream(big.device).cuda_stream
        kernel.launch(big.data_ptr(), w.data_ptr(), out.data_ptr(), B,
                      w.shape[0], w.shape[2], T, pad_arg, stream)


def conv1d_ci1_cuda(x, w, pad) -> torch.Tensor:
    """Launch kernel B2 of ``x``'s dtype (no autograd)."""
    _check("ci1_conv_forward", x, w, pad, 1)
    x, w = x.detach().contiguous(), w.detach().contiguous()
    out = x.new_empty((x.shape[0], w.shape[0], x.shape[2]))
    _launch(kernels_for(x.dtype)[0], x, w, pad[0], out)
    return out


def conv1d_ci1_dx_cuda(g, w, pad) -> torch.Tensor:
    """Launch kernel B3 of ``g``'s dtype (no autograd)."""
    _check("ci1_conv_dx", g, w, pad, w.shape[0])
    g, w = g.detach().contiguous(), w.detach().contiguous()
    dx = g.new_empty((g.shape[0], 1, g.shape[2]))
    _launch(kernels_for(g.dtype)[1], g, w, pad[1], dx)
    return dx


def dx_launch_info(B: int, co: int, k: int, T: int,
                   dtype: torch.dtype = torch.float32) -> dict:
    """What one launch of kernel B3 (the instance of ``dtype``) at this
    shape uses on the current card: blocks, threads per block, shared
    memory and registers per thread; for bf16 also the slots of a warp's
    ring and whether it stages by TMA (1, for a 16-byte aligned g) or by
    cp.async (0)."""
    _, dx, symbol, fields = INSTANCES[dtype]
    info = (ctypes.c_int * len(fields))()
    dx.query(symbol, B, co, k, T, info)
    return dict(zip(fields, info))


def _on(device: torch.device, cuda_fn, plain_fn, *args) -> torch.Tensor:
    if device.type == "cpu":
        return plain_fn(*args)
    if device.type != "cuda":
        raise ValueError(f"conv1d_ci1: unsupported device {device}")
    return cuda_fn(*args)


class _Ci1Conv(torch.autograd.Function):
    """B2 forward; B3 data gradient; library weight gradient.  Each
    gradient is computed only where autograd asks for it."""

    @staticmethod
    def forward(ctx, x, w, pad):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        return _on(x.device, conv1d_ci1_cuda, conv1d_ci1_reference, x, w, pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _on(g.device, conv1d_ci1_dx_cuda, conv1d_ci1_dx_reference,
                     g, w, ctx.pad)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(F.pad(x, ctx.pad), w.shape, g)
        return dx, dw, None


def conv1d_ci1(x: torch.Tensor, w: torch.Tensor, pad) -> torch.Tensor:
    """Same-length conv with one input channel, ``(B, 1, T)`` ->
    ``(B, co, T)``: kernels B2/B3 on a CUDA tensor, their plain twins on
    a CPU tensor."""
    return _Ci1Conv.apply(x, w, tuple(pad))
