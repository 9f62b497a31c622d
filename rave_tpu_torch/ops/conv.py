"""Streaming-first 1-D convolutions in PyTorch.

Port of ``rave_tpu/ops/conv.py``.  Layout is channels-first
``(B, C, T)``, the layout of ``F.conv1d``.  Offline mode applies the
asymmetric ``(left, right)`` padding of :func:`~rave_tpu_torch.ops.delay.
get_padding`; streaming mode carries a left-context cache (or an
overlap-add tail, or a delay line) from one chunk to the next.  All delay
bookkeeping is static Python computed at build time
(:mod:`rave_tpu_torch.ops.delay`).

Parameters keep the PyTorch layouts: ``Conv1d`` weights ``(out, in/g, k)``,
``ConvTranspose1d`` weights ``(in, out, k)``.  Weight normalisation is done
here by hand, per OUTPUT channel for both kinds of conv, with the JAX
package's ``1e-12`` under the square root; ``torch.nn.utils.weight_norm``
would normalise a transposed conv per input channel.

A conv computes in its input's dtype: the float32 parameters are cast per
call, as flax's ``Conv1d`` does.  In bf16 the conv's output is rounded to
bf16 and the bias is added after it, in bf16 (a second rounding, as in
the JAX package); in float32 the bias is part of the conv.  A streaming
cache starts as zeros in the dtype of the chunk it first meets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .delay import ConvPlan, ConvTransposePlan, plan_conv, plan_conv_transpose


@dataclasses.dataclass(frozen=True)
class StreamSetup:
    """Global conv behaviour, threaded through every module."""
    mode: str = "centered"  # "centered" | "causal"
    streaming: bool = False


def normalize_kernel(v: torch.Tensor, g: torch.Tensor,
                     dims: tuple) -> torch.Tensor:
    """Weight normalisation ``v * g / sqrt(sum(v^2) + 1e-12)``, the sum
    taken over ``dims`` (every axis but the output channel)."""
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)
    return v * (g / norm)


def _uniform(shape, fan_in: int) -> nn.Parameter:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the JAX package's init."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class Cached(nn.Module):
    """A module that carries streaming state from one chunk to the next.

    ``cache`` is a plain tensor attribute (not a parameter, not in the
    state dict).  A :class:`StreamStep` sets it before a chunk and reads
    it back after; left unset, it is created as zeros at the first chunk
    on the chunk's device and batch size.  :meth:`reset_cache` forgets it.
    A stream starts from :meth:`initial` of each cache (zeros, but for a
    module whose state starts elsewhere); ``carry_last`` state (AdaIN's)
    comes after every cache in a stream's carry.
    """

    carry_last = False

    def __init__(self):
        super().__init__()
        self.cache: Optional[torch.Tensor] = None

    def reset_cache(self) -> None:
        self.cache = None

    def initial(self, like: torch.Tensor) -> torch.Tensor:
        """The state a stream starts from, shaped like ``like``."""
        return torch.zeros_like(like)

    def _zeros_cache(self, x: torch.Tensor, channels: int,
                     length: int) -> torch.Tensor:
        if self.cache is None:
            self.cache = x.new_zeros((x.shape[0], channels, length))
        return self.cache


class Conv1d(Cached):
    """Strided / dilated / grouped conv with offline and streaming modes.

    ``in_delay`` is the accumulated delay of the input stream in
    input-rate frames; the streaming plan folds in an alignment delay so
    the output delay is integral (:func:`~rave_tpu_torch.ops.delay.
    plan_conv`).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = True,
                 weight_norm: bool = False, in_delay: int = 0,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        if in_channels % groups:
            raise ValueError(
                f"channels {in_channels} not divisible by groups {groups}")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride = kernel_size, stride
        self.dilation, self.groups = dilation, groups
        self.use_weight_norm = weight_norm
        self.ss = ss
        self.plan: ConvPlan = plan_conv(kernel_size, stride, dilation,
                                        ss.mode, in_delay)
        shape = (out_channels, in_channels // groups, kernel_size)
        fan_in = kernel_size * in_channels // groups
        if weight_norm:
            self.v = _uniform(shape, fan_in)
            self.g = nn.Parameter(
                torch.sqrt(torch.sum(self.v.detach() ** 2, dim=(1, 2),
                                     keepdim=True)))
        else:
            self.weight = _uniform(shape, fan_in)
        self.bias = _uniform((out_channels,), fan_in) if bias else None

    @property
    def out_delay(self) -> int:
        return self.plan.out_delay

    def kernel(self) -> torch.Tensor:
        """The conv weight ``(out, in/g, k)``, weight norm resolved."""
        if self.use_weight_norm:
            return normalize_kernel(self.v, self.g, (1, 2))
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        plan = self.plan
        if self.ss.streaming:
            if plan.cache_len > 0:
                cache = self._zeros_cache(x, x.shape[1], plan.cache_len)
                xx = torch.cat([cache, x], dim=2)
                self.cache = xx[:, :, xx.shape[2] - plan.cache_len:]
            else:
                xx = x
        else:
            xx = F.pad(x, (plan.pad_left, plan.pad_right))
        w = self.kernel().to(x.dtype)
        if x.dtype != torch.bfloat16 or self.bias is None:
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return F.conv1d(xx, w, bias, stride=self.stride,
                            dilation=self.dilation, groups=self.groups)
        y = F.conv1d(xx, w, stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        return y + self.bias.to(x.dtype)[:, None]


class ConvTranspose1d(Cached):
    """Strided transposed conv (upsampler) with offline and streaming modes.

    Offline, the full transposed-conv output ``(T-1)*s + k`` is cropped by
    ``crop`` frames on each side.  Streaming keeps an overlap-add tail of
    ``kernel - stride`` output frames in the cache.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int, crop: Optional[int] = None,
                 bias: bool = False, weight_norm: bool = False,
                 in_delay: int = 0, ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride = kernel_size, stride
        self.crop = stride // 2 if crop is None else crop
        self.use_weight_norm = weight_norm
        self.ss = ss
        self.plan: ConvTransposePlan = plan_conv_transpose(
            kernel_size, stride, self.crop, in_delay)
        shape = (in_channels, out_channels, kernel_size)
        fan_in = kernel_size * in_channels
        if weight_norm:
            self.v = _uniform(shape, fan_in)
            self.g = nn.Parameter(
                torch.sqrt(torch.sum(self.v.detach() ** 2, dim=(0, 2),
                                     keepdim=True)))
        else:
            self.weight = _uniform(shape, fan_in)
        self.bias = _uniform((out_channels,), fan_in) if bias else None

    @property
    def out_delay(self) -> int:
        return self.plan.out_delay

    def kernel(self) -> torch.Tensor:
        """The weight ``(in, out, k)``, normalised per output channel."""
        if self.use_weight_norm:
            return normalize_kernel(self.v, self.g, (0, 2))
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, s = x.shape[2], self.stride
        y_full = F.conv_transpose1d(x, self.kernel().to(x.dtype), stride=s)
        if self.ss.streaming:
            tail = self.plan.tail_len
            if tail > 0:
                cache = self._zeros_cache(x, self.out_channels, tail)
                y_full[:, :, :tail] += cache
                self.cache = y_full[:, :, T * s:]
            y = y_full[:, :, :T * s]
        else:
            y = y_full[:, :, self.crop:y_full.shape[2] - self.crop]
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None]
        return y


class Delay(Cached):
    """Pure delay line of ``frames`` frames.

    Offline it is the identity (offline centered graphs have zero delay);
    streaming, it aligns a branch with a slower one.
    """

    def __init__(self, frames: int, ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.frames = frames
        self.ss = ss

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.ss.streaming or self.frames == 0:
            return x
        buf = self._zeros_cache(x, x.shape[1], self.frames)
        xx = torch.cat([buf, x], dim=2)
        self.cache = xx[:, :, x.shape[2]:]
        return xx[:, :, :x.shape[2]]


class StreamDraw(Cached):
    """A random tensor of a block: uniform in [-1, 1) or standard normal.

    Offline, each call takes the ``value`` it is given or draws one from
    ``generator`` (there is no hidden source).  Streaming, the draw is
    the module's cache and comes back unchanged, so that every chunk of
    a stream reuses one draw, as the JAX package's stream does with its
    fixed keys; the stream sets it (:meth:`sample`) and restores it on
    reset like any other cache.  An unset cache starts as ``value`` or
    zeros.
    """

    def __init__(self, kind: str, ss: StreamSetup = StreamSetup()):
        super().__init__()
        if kind not in ("uniform", "normal"):
            raise ValueError(f"unknown draw {kind!r}")
        self.kind, self.ss = kind, ss

    def sample(self, shape, generator: torch.Generator, device=None,
               dtype=torch.float32) -> torch.Tensor:
        if self.kind == "normal":
            return torch.randn(shape, generator=generator, device=device,
                               dtype=dtype)
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype) * 2 - 1

    def forward(self, shape, like: torch.Tensor,
                value: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shape = tuple(shape)
        if self.ss.streaming and self.cache is not None:
            return self.cache
        if value is None and not self.ss.streaming:
            if generator is None:
                raise ValueError(f"a {self.kind} draw of shape {shape} "
                                 "needs a value or a generator")
            value = mesh.global_draw(
                lambda s: self.sample(s, generator, like.device, like.dtype),
                shape)
        if value is None:
            value = like.new_zeros(shape)
        if tuple(value.shape) != shape:
            raise ValueError(f"{self.kind} draw: {tuple(value.shape)} for "
                             f"{shape}")
        if self.ss.streaming:
            self.cache = value
        return value


def stream_caches(root: nn.Module, fn, *args) -> tuple[list, list]:
    """The :class:`Cached` modules of ``root`` that ``fn`` carries state
    in, in module order (``carry_last`` ones after the others), and the
    initial state of each: ``fn`` runs once on ``args`` (zeros shaped
    like a chunk) from unset caches, as the JAX package initialises its
    ``"cache"`` collection.  Every cache of ``root`` is unset again
    after."""
    mods = [m for m in root.modules() if isinstance(m, Cached)]
    for m in mods:
        m.reset_cache()
    with torch.no_grad():
        fn(*args)
    used = sorted((m for m in mods if m.cache is not None),
                  key=lambda m: m.carry_last)
    caches = [m.initial(m.cache) for m in used]
    for m in mods:
        m.reset_cache()
    return used, caches


class StreamStep(nn.Module):
    """``fn`` over streaming caches as a pure function:
    ``(caches, *args) -> (out, caches)``.

    ``caches`` belong to ``mods`` (from :func:`stream_caches`), in that
    order; each is set on its module before ``fn`` runs and read back
    after, and the modules are left without caches.  A cache that ``fn``
    does not touch comes back as it went in; none is written in place.
    ``fn`` computes with ``root``'s parameters; ``root`` is a submodule,
    so that ``torch.export`` takes them and its buffers into the program.
    """

    def __init__(self, root: nn.Module, fn, mods: list):
        super().__init__()
        self.root = root
        self.fn = fn
        self.mods = list(mods)

    def forward(self, caches: list, *args):
        if len(caches) != len(self.mods):
            raise ValueError(f"{len(caches)} caches for {len(self.mods)} "
                             "streaming modules")
        for m, c in zip(self.mods, caches):
            m.cache = c
        try:
            out = self.fn(*args)
            return out, [m.cache for m in self.mods]
        finally:
            for m in self.mods:
                m.reset_cache()
