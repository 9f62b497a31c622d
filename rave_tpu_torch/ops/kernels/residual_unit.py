"""Fused dilated residual unit (kernel B1): CUDA kernel, plain twin, dispatch.

Port of ``rave_tpu/ops/pallas/residual_unit.py``.  The unit is

    y = x + W2 . lrelu(W1 *_dilated lrelu(x) + b1) + b2

with a same-length output and zero padding ``(pad_left, pad_right)``.
On a CUDA tensor :func:`residual_unit` launches the hand-written kernel
``csrc/residual_unit.cu`` through an ``autograd.Function`` whose backward
is autograd of the plain composition (the JAX package's ``custom_vjp``
does the same).  On a CPU tensor it runs :func:`residual_unit_reference`,
and only for that reason; a build or launch failure on the card raises.

Layouts are the port's: ``x`` ``(B, C, T)``, ``w1`` ``(C, C, k)`` (the
``F.conv1d`` weight), ``w2`` ``(C, C)`` as ``(out, in)``.  The kernel reads
the weights K-major, input channel fastest (:func:`prepare_weights`):
``w1`` as ``(k, C_out, C_in)`` and ``w2`` as it is.

The five tensors are all float32 (``KERNEL``, 3xTF32 on the tensor
cores) or all bf16 (``KERNEL_BF16``, the Pallas kernel's bf16 contract:
float32 accumulation, the hidden tile and the output each rounded once to
bf16).  bf16 serving and the bf16 train steps run the bf16 instance;
its backward is autograd of the bf16 twin.  The JAX package has no
backward kernel, and its fused unit's ``custom_vjp`` backward
(``rave_tpu/ops/pallas/residual_unit.py`` ``_bwd``, ``jax.vjp`` of
``_reference_impl``) raises on bf16 operands, so its bf16 train step
differentiates the unfused unit: the arithmetic this backward follows.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..precision import leaky_relu
from .build import CudaKernel

NEG_SLOPE = 0.2

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNEL = CudaKernel("residual_unit", "residual_unit.cu",
                    "residual_unit_forward", _ARGS)
KERNEL_BF16 = CudaKernel("residual_unit_bf16", "residual_unit.cu",
                         "residual_unit_bf16_forward", _ARGS)
DTYPES = (torch.float32, torch.bfloat16)


def kernel_for(dtype: torch.dtype) -> CudaKernel:
    """The kernel instance of an operand dtype."""
    return KERNEL_BF16 if dtype == torch.bfloat16 else KERNEL


def residual_unit_reference(x, w1, b1, w2, b2, dilation: int,
                            pad_left: int, pad_right: int) -> torch.Tensor:
    """Plain PyTorch composition of the unit (the kernel's twin).  In
    bf16 it rounds where the JAX package's ``_reference_impl`` does:
    lrelu(x) in bf16, each GEMM accumulated in float32 and rounded to
    bf16, then each bias and the residual added in bf16."""
    if x.dtype != torch.bfloat16:
        h = F.pad(F.leaky_relu(x, NEG_SLOPE), (pad_left, pad_right))
        h = F.leaky_relu(F.conv1d(h, w1, b1, dilation=dilation), NEG_SLOPE)
        return x + F.conv1d(h, w2[:, :, None], b2)
    h = F.pad(leaky_relu(x, NEG_SLOPE), (pad_left, pad_right))
    h = leaky_relu(F.conv1d(h, w1, dilation=dilation) + b1[:, None],
                   NEG_SLOPE)
    return x + (F.conv1d(h, w2[:, :, None]) + b2[:, None])


def _check(x, w1, b1, w2, b2, dilation, pad_left, pad_right) -> None:
    tensors = (x, w1, b1, w2, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError("residual_unit: all tensors must be on one device")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("residual_unit: the CUDA kernel takes five float32 "
                        "or five bfloat16 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 3:
        raise ValueError(f"residual_unit: x must be (B, C, T), got {tuple(x.shape)}")
    C = x.shape[1]
    k = w1.shape[-1]
    if C % 128 or C > 512:
        raise ValueError(f"residual_unit: C={C} is outside the kernel's "
                         "range (C % 128 == 0, C <= 512)")
    if (w1.shape != (C, C, k) or w2.shape != (C, C)
            or b1.shape != (C,) or b2.shape != (C,)):
        raise ValueError("residual_unit: weight shapes do not match C")
    if pad_left + pad_right != (k - 1) * dilation or pad_left < 0 or pad_right < 0:
        raise ValueError("residual_unit: padding must keep the length")


def prepare_weights(w1, w2):
    """The weight operands as the kernel reads them, K-major (input
    channel fastest), in their own dtype: ``w1k[j, co, ci] = w1[co, ci,
    j]``, ``(k, C, C)``, and ``w2`` ``(C_out, C_in)`` as it is."""
    return (w1.detach().permute(2, 0, 1).contiguous(),
            w2.detach().contiguous())


def pad_time(x):
    """``(x, pad)``: x as the bf16 kernel reads it and the zeros appended
    to its time axis.  The kernel reads x through TMA, which needs
    16-byte row strides and a 16-byte aligned base, so T is padded to a
    multiple of 8 (and a misaligned x copied).  The zeros only extend
    the unit's own zero padding: the first T outputs are unchanged."""
    if x.dtype != torch.bfloat16:
        return x, 0
    pad = -x.shape[-1] % 8
    if pad:
        return F.pad(x, (0, pad)), pad
    return (x.clone() if x.data_ptr() % 16 else x), 0


def residual_unit_cuda(x, w1, b1, w2, b2, dilation: int, pad_left: int,
                       pad_right: int) -> torch.Tensor:
    """Launch the CUDA kernel (forward only, no autograd)."""
    _check(x, w1, b1, w2, b2, dilation, pad_left, pad_right)
    x = x.contiguous()
    w1k, w2k = prepare_weights(w1, w2)
    b1, b2 = b1.detach().contiguous(), b2.detach().contiguous()
    if w1k.data_ptr() % 16 or w2k.data_ptr() % 16:
        raise ValueError("residual_unit: weights must be 16-byte aligned")
    T = x.shape[-1]
    x, pad = pad_time(x)
    B, C, _ = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        kernel_for(x.dtype).launch(x.data_ptr(), w1k.data_ptr(), b1.data_ptr(),
                      w2k.data_ptr(), b2.data_ptr(), out.data_ptr(),
                      B, C, T + pad, w1.shape[-1], dilation, pad_left, stream)
    return out[..., :T].contiguous() if pad else out


def launch_info(B: int, C: int, T: int, k: int, dilation: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """What one launch at this shape uses on the current card (the
    instance of ``dtype``): CTAs, cluster size, threads per CTA, dynamic
    shared memory, registers per thread, and the GEMM-1 chunk of input
    channels (float32) or the TMA ring's slots (bf16)."""
    info = (ctypes.c_int * 6)()
    bf16 = dtype == torch.bfloat16
    symbol = ("residual_unit_bf16_launch_info" if bf16
              else "residual_unit_launch_info")
    kernel_for(dtype).query(symbol, B, C, T, k, dilation, info)
    return dict(zip(("ctas", "cluster", "threads", "smem_bytes",
                     "registers", "stages" if bf16 else "chunk"), info))


class _ResidualUnit(torch.autograd.Function):
    """Kernel forward; backward through autograd of the plain composition
    in the operands' dtype.  In bf16 that is the VJP of the JAX package's
    unfused unit, which its bf16 train step differentiates (the fused
    unit's ``custom_vjp`` raises on bf16 operands); the CPU tests hold it
    against that VJP, and ``chip_smoke.py`` phase 18 its wiring on the
    card."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dilation, pad_left, pad_right):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.static = (dilation, pad_left, pad_right)
        return residual_unit_cuda(x, w1, b1, w2, b2, dilation, pad_left,
                                  pad_right)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = residual_unit_reference(*inputs, *ctx.static)
        grads = torch.autograd.grad(y, inputs, grad)
        return (*grads, None, None, None)


def residual_unit(x, w1, b1, w2, b2, dilation: int, pad_left: int,
                  pad_right: int) -> torch.Tensor:
    """The fused unit: the CUDA kernel for a CUDA ``x``, the plain
    composition for a CPU ``x``."""
    if x.device.type == "cpu":
        return residual_unit_reference(x, w1, b1, w2, b2, dilation,
                                       pad_left, pad_right)
    if x.device.type != "cuda":
        raise ValueError(f"residual_unit: unsupported device {x.device}")
    return _ResidualUnit.apply(x, w1, b1, w2, b2, dilation, pad_left,
                               pad_right)
