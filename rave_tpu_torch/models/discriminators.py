"""Discriminators of the ``v2``, ``v2_fork`` and ``v3`` presets.

Port of ``rave_tpu/models/discriminators.py``: the ConvNet ladders, the
multi-scale, multi-period and (1-D and 2-D) multi-scale spectral
discriminators of v2's ``combine(periods, scales, spectral)``, the
fork's UnivNet MRD + MPD and MelGAN stack, and v3's Descript (DAC)
discriminator (MPD, MSD and band-split complex-STFT MRD).  Layouts are
the port's channels-first ones: audio ``(B, 1, T)``, 1-D features
``(B, C, T)``, 2-D features ``(B, C, H, W)`` with H the leading axis of
the JAX package's ``(B, H, W, C)`` (time for the MRD and the MPDs,
frequency for the spectral discriminator), so a kernel converts by a
plain transpose.  Every multi-discriminator returns
``list[list[Tensor]]``: one feature list per sub-discriminator, score
last.  Submodules carry the flax names (``mpd/period{i}``,
``msd/disc{i}``, ``msspec/spec{i}``, ...), and each conv list is a
``convs`` ModuleList whose ``i``-th entry is flax's ``WNConv_{i}``;
explicitly named flax convs (the Descript MRD's ``band{b}_conv{l}`` and
``post``) are attributes of those names.

The JAX package's TPU formulation tricks (the packed-resident spectral
chains, the Encodec one's and the Descript MRD's, grouped-conv
supergrouping, the phase-decomposed dx of strided convs, the
shift-and-add ci=1 conv) are not ported: native
``F.conv1d``/``F.conv2d`` give the same values and gradients.  The
MelGAN head conv takes kernels B2/B3 (:func:`~rave_tpu_torch.ops.kernels.
ci1_conv.conv1d_ci1`) under the JAX package's shape gate.

Every discriminator runs in its input's dtype (the train step feeds it
the compute dtype): each conv casts its float32 kernel to it and, in
bf16, adds the bias after the conv, as the JAX package's ``WNConv``
rounds twice; the leaky-ReLU slopes are JAX's weak bf16 scalars
(:func:`~rave_tpu_torch.ops.precision.leaky_relu`); the spectral members
take the STFT in float32 and cast it back to the signal's dtype; the
Descript preprocess stays in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..config import RAVEConfig
from ..ops.conv import _uniform, normalize_kernel
from ..ops.pqmf import kaiser_filter
from ..ops.kernels.ci1_conv import conv1d_ci1
from ..ops.precision import leaky_relu
from ..ops.stft import stft

NEG_SLOPE = 0.2


def _lrelu(x: torch.Tensor, slope: float = NEG_SLOPE) -> torch.Tensor:
    return leaky_relu(x, slope)


class WNConv(nn.Module):
    """Weight-normalised N-d conv (N = ``len(kernel_size)``), grouped.

    The norm runs over every axis but the output channel.  ``padding`` is
    ``[(left, right), ...]`` per spatial axis (default: ``(k-1)//2`` each
    side).  Parameters: ``v`` ``(out, in/groups, *k)``, ``g``
    ``(out, 1, ...)`` and ``bias`` ``(out,)``.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 padding: Optional[Sequence[tuple]] = None, groups: int = 1,
                 dilation: Optional[Sequence[int]] = None):
        super().__init__()
        nd = len(kernel_size)
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides or (1,) * nd)
        self.dilation = tuple(dilation or (1,) * nd)
        self.padding = tuple(tuple(p) for p in (
            padding or [((k - 1) // 2, (k - 1) // 2) for k in kernel_size]))
        self.groups = groups
        fan_in = in_channels // groups * math.prod(kernel_size)
        self.v = _uniform((features, in_channels // groups, *kernel_size),
                          fan_in)
        self.g = nn.Parameter(torch.sqrt(torch.sum(
            self.v.detach() ** 2, dim=tuple(range(1, nd + 2)), keepdim=True)))
        self.bias = _uniform((features,), fan_in)

    def kernel(self) -> torch.Tensor:
        return normalize_kernel(self.v, self.g,
                                tuple(range(1, self.v.dim())))

    def takes_ci1(self, x: torch.Tensor) -> bool:
        """The JAX package's gate for the ci=1 head-conv kernels."""
        (k,), ((pl, pr),) = self.kernel_size, self.padding
        return (self.groups == 1 and self.strides == (1,)
                and self.dilation == (1,) and x.shape[1] == 1
                and k <= 16 and x.shape[2] >= 8192 and pl + pr == k - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The conv in ``x``'s dtype.  In bf16 the bias is added after
        the conv, in bf16 (two roundings, as the JAX package's); in
        float32 it rides inside the conv."""
        kernel = self.kernel().to(x.dtype)
        nd = len(self.kernel_size)
        if nd == 1 and self.takes_ci1(x):
            return conv1d_ci1(x, kernel, self.padding[0]) + self.bias.to(
                x.dtype)[:, None]
        conv = F.conv1d if nd == 1 else F.conv2d
        if all(pl == pr for pl, pr in self.padding):
            pad = tuple(pl for pl, _ in self.padding)
        else:
            x = F.pad(x, [p for lr in reversed(self.padding) for p in lr])
            pad = 0
        if x.dtype != torch.bfloat16:
            return conv(x, kernel, self.bias, stride=self.strides,
                        padding=pad, dilation=self.dilation,
                        groups=self.groups)
        y = conv(x, kernel, None, stride=self.strides, padding=pad,
                 dilation=self.dilation, groups=self.groups)
        return y + self.bias.to(x.dtype).reshape(-1, *(1,) * nd)


def _avg_pool_1d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """``(B, C, T)`` average pool, torch ``avg_pool1d`` semantics."""
    B, C, T = x.shape
    T -= T % window
    return x[:, :, :T].reshape(B, C, T // window, window).mean(-1)


def _convnet(convs: nn.ModuleList, x: torch.Tensor,
             after_activation: bool = False,
             slope: float = NEG_SLOPE) -> list[torch.Tensor]:
    """Each conv but the last and a leaky ReLU, each giving a feature
    taken before the activation (or after it); the last conv's output
    is the score."""
    feats = []
    for conv in convs[:-1]:
        x = conv(x)
        if after_activation:
            x = _lrelu(x, slope)
        feats.append(x)
        if not after_activation:
            x = _lrelu(x, slope)
    feats.append(convs[-1](x))
    return feats


class ConvNet1d(nn.Module):
    """``n_layers`` strided convs of ``capacity * 2^i`` channels (pad
    ``(k - stride + 1) // 2`` each side) and a 1x1 score conv."""

    def __init__(self, in_size: int = 1, capacity: int = 64,
                 n_layers: int = 4, kernel_size: int = 15, stride: int = 4):
        super().__init__()
        pad = (kernel_size - stride + 1) // 2 if kernel_size > 1 else 0
        convs, ci = [], in_size
        for i in range(n_layers):
            convs.append(WNConv(ci, capacity * 2 ** i, (kernel_size,),
                                (stride,), [(pad, pad)]))
            ci = capacity * 2 ** i
        convs.append(WNConv(ci, 1, (1,)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _convnet(self.convs, x)


class ConvNet2d(nn.Module):
    """The 2-D ladder of the period discriminators: four convs of kernel
    ``(5, 1)``, stride ``(4, 1)`` and ``64 * 2^i`` channels over one
    input channel, a 1x1 score conv."""

    def __init__(self):
        super().__init__()
        convs, ci = [], 1
        for i in range(4):
            convs.append(WNConv(ci, 64 * 2 ** i, (5, 1), (4, 1),
                                [(1, 1), (0, 0)]))
            ci = 64 * 2 ** i
        convs.append(WNConv(ci, 1, (1, 1)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _convnet(self.convs, x)


class MultiScaleDiscriminator(nn.Module):
    """Three ConvNet1d (``disc0..2``, kernel 15, stride 4) over an
    average-pool pyramid."""

    def __init__(self, capacity: int = 64, n_layers: int = 4):
        super().__init__()
        self.subs = [f"disc{i}" for i in range(3)]
        for name in self.subs:
            self.add_module(name, ConvNet1d(1, capacity, n_layers, 15, 4))

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        out = []
        for name in self.subs:
            out.append(getattr(self, name)(x))
            x = _avg_pool_1d(x, 2)
        return out


class MultiPeriodDiscriminator(nn.Module):
    """One ConvNet2d per period 2, 3, 5, 7, 11 (``period0..4``): time
    folded into ``(T/p, p)`` after zero padding on the right (unlike the
    UnivNet MPD, which reflects)."""

    PERIODS = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        for i in range(len(self.PERIODS)):
            self.add_module(f"period{i}", ConvNet2d())

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        B, C, T = x.shape
        out = []
        for i, p in enumerate(self.PERIODS):
            z = F.pad(x, (0, (p - T % p) % p))
            out.append(getattr(self, f"period{i}")(
                z.reshape(B, C, z.shape[2] // p, p)))
        return out


class EncodecConvNet(nn.Module):
    """2-D conv stack over a complex STFT ``(B, 2, F, frames)``: per
    ``(kh, kw, stride_f, dil_t)`` of ``SPECS`` a conv of 32 channels
    (stride on frequency, dilation on time) and a leaky ReLU, each
    feature taken after it; a 3x3 score conv.  This is the native
    formulation; the JAX package's default packs frequency rows into
    channels (a TPU layout), with the same parameters and values."""

    SPECS = ((9, 3, 1, 1), (9, 3, 2, 1), (9, 3, 2, 2), (9, 3, 2, 4),
             (3, 3, 1, 1))

    def __init__(self):
        super().__init__()
        convs, ci = [], 2
        for kh, kw, sh, dw in self.SPECS:
            ph, pw = (kh - 1) // 2, (kw - 1) * dw // 2
            convs.append(WNConv(ci, 32, (kh, kw), (sh, 1),
                                [(ph, ph), (pw, pw)], dilation=(1, dw)))
            ci = 32
        convs.append(WNConv(ci, 1, (3, 3), padding=[(1, 1), (1, 1)]))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _convnet(self.convs, x, after_activation=True)


def _uncentred_stft(x: torch.Tensor, scale: int, what: str) -> torch.Tensor:
    """Normalised STFT ``(B, frames, bins)`` of ``x`` ``(B, 1, T)`` with
    no centring pad; a signal shorter than the window raises (it would
    give no frame, and an empty mean trains on NaN)."""
    sig = x[:, 0]
    if sig.shape[1] < scale:
        raise ValueError(
            f"{what} discriminator scale {scale} needs at least {scale} "
            f"samples, got {sig.shape[1]} (reduce "
            "discriminator.spectral_scales or raise n_signal)")
    return stft(sig, scale, scale // 4, center=False, normalized=True)


class MultiScaleSpectralDiscriminator(nn.Module):
    """One EncodecConvNet per STFT scale (``spec0..``), real and
    imaginary parts as two channels over ``(bins, frames)``."""

    def __init__(self, scales: Sequence[int] = (4096, 2048, 1024, 512, 256)):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(len(self.scales)):
            self.add_module(f"spec{i}", EncodecConvNet())

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        out = []
        for i, scale in enumerate(self.scales):
            s = _uncentred_stft(x, scale, "spectral")
            z = torch.stack([s.real, s.imag], 1).transpose(2, 3).to(x.dtype)
            out.append(getattr(self, f"spec{i}")(z))
        return out


class MultiScaleSpectralDiscriminator1d(nn.Module):
    """One ConvNet1d (kernel 5, stride 2) per STFT scale (``spec1d0..``)
    over frames, with the ``scale + 2`` real and imaginary bins as
    channels."""

    def __init__(self, scales: Sequence[int] = (4096, 2048, 1024, 512, 256),
                 capacity: int = 64):
        super().__init__()
        self.scales = tuple(scales)
        for i, scale in enumerate(self.scales):
            self.add_module(f"spec1d{i}", ConvNet1d(
                scale + 2, capacity, kernel_size=5, stride=2))

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        out = []
        for i, scale in enumerate(self.scales):
            s = _uncentred_stft(x, scale, "spectral_1d")
            z = torch.cat([s.real, s.imag], -1).transpose(1, 2).to(x.dtype)
            out.append(getattr(self, f"spec1d{i}")(z))
        return out


class UnivNetPeriodDiscriminator(nn.Module):
    """Period discriminator: time folded into ``(T/p, p)``, reflect-padded
    on the right when ``p`` does not divide ``T``."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [1, 64, 128, 256, 512]
        convs = [WNConv(ci, co, (5, 1), (3, 1), [(2, 2), (0, 0)])
                 for ci, co in zip(chans[:-1], chans[1:])]
        convs.append(WNConv(512, 1024, (5, 1), (1, 1), [(2, 2), (0, 0)]))
        convs.append(WNConv(1024, 1, (3, 1), padding=[(1, 1), (0, 0)]))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        B, C, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x, (0, p - T % p), mode="reflect")
            T = x.shape[2]
        z = x.reshape(B, C, T // p, p)
        return _convnet(self.convs, z, after_activation=True)


class UnivNetResolutionDiscriminator(nn.Module):
    """Resolution discriminator over an STFT magnitude, time-major: the
    9-tap window and the stride 2 on the time axis H, 3 taps on the
    frequency axis W.  ``resolution`` is ``(hop_ms, win_ms)``, converted
    at a hard-coded 16 kHz as the JAX package does."""

    SPECS = ((9, 3, 1), (9, 3, 2), (9, 3, 2), (9, 3, 2), (3, 3, 1))

    def __init__(self, resolution: tuple, sampling_rate: int = 16000):
        super().__init__()
        hop_ms, win_ms = resolution
        self.hop = int(0.001 * hop_ms * sampling_rate)
        self.win = int(0.001 * win_ms * sampling_rate)
        self.n_fft = int(2 ** (int(math.log2(self.win)) + 1))
        convs, ci = [], 1
        for kh, kw, sh in self.SPECS:
            ph, pw = (kh - 1) // 2, (kw - 1) // 2
            convs.append(WNConv(ci, 32, (kh, kw), (sh, 1),
                                [(ph, ph), (pw, pw)]))
            ci = 32
        convs.append(WNConv(32, 1, (3, 3), padding=[(1, 1), (1, 1)]))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        pad = (self.n_fft - self.hop) // 2
        sig = F.pad(x, (pad, pad), mode="reflect")[:, 0]
        s = stft(sig, self.n_fft, self.hop, win_length=self.win, center=False)
        z = s.abs()[:, None].to(x.dtype)  # (B, 1, frames, bins)
        return _convnet(self.convs, z, after_activation=True)


class UnivNetDiscriminator(nn.Module):
    """Three MRDs then five MPDs (``mrd0..2``, ``mpd0..4``)."""

    def __init__(self, resolutions: Sequence[tuple] = ((5, 25), (10, 50),
                                                       (2, 10)),
                 periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.subs = []
        for i, res in enumerate(resolutions):
            self.add_module(f"mrd{i}", UnivNetResolutionDiscriminator(
                tuple(res)))
            self.subs.append(f"mrd{i}")
        for i, p in enumerate(periods):
            self.add_module(f"mpd{i}", UnivNetPeriodDiscriminator(p))
            self.subs.append(f"mpd{i}")

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        return [getattr(self, name)(x) for name in self.subs]


class MelGANDiscriminator(nn.Module):
    """Head conv (k=15, 1 -> capacity), ``n_layers`` grouped stride-4
    convs (k=41), a k=5 conv and a 1x1 scoring conv; features are taken
    before each activation."""

    def __init__(self, capacity: int = 16, multiplier: int = 4,
                 n_layers: int = 4):
        super().__init__()
        convs = [WNConv(1, capacity, (15,), padding=[(7, 7)])]
        ch = capacity
        pad = (41 - multiplier + 1) // 2
        for i in range(n_layers):
            out_ch = min(1024, capacity * multiplier ** (i + 1))
            convs.append(WNConv(ch, out_ch, (41,), (multiplier,),
                                [(pad, pad)], groups=multiplier ** (i + 1)))
            ch = out_ch
        convs.append(WNConv(ch, ch, (5,), padding=[(2, 2)]))
        convs.append(WNConv(ch, 1, (1,)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return _convnet(self.convs, x)


class StackDiscriminators(nn.Module):
    """Three MelGAN discriminators (``stack0..2``) over an average-pool
    pyramid."""

    def __init__(self, n_dis: int = 3, capacity: int = 16,
                 multiplier: int = 4, n_layers: int = 4):
        super().__init__()
        self.subs = [f"stack{i}" for i in range(n_dis)]
        for name in self.subs:
            self.add_module(name, MelGANDiscriminator(capacity, multiplier,
                                                      n_layers))

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        out = []
        for name in self.subs:
            out.append(getattr(self, name)(x))
            x = _avg_pool_1d(x, 2)
        return out


DESCRIPT_BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75),
                  (0.75, 1.0))
DESCRIPT_SLOPE = 0.1


class DescriptMPD(nn.Module):
    """Period discriminator of the Descript stack: time reflect-padded on
    the right to a multiple of ``period`` and folded into ``(T/p, p)``,
    convs of 32, 128, 512 and 1024 channels (kernel ``(5, 1)``, stride
    ``(3, 1)``), a 1024-channel one of stride 1 and a ``(3, 1)`` score
    conv; leaky ReLU 0.1, features taken after it."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        convs, ci = [], 1
        for co in (32, 128, 512, 1024):
            convs.append(WNConv(ci, co, (5, 1), (3, 1), [(2, 2), (0, 0)]))
            ci = co
        convs.append(WNConv(1024, 1024, (5, 1), padding=[(2, 2), (0, 0)]))
        convs.append(WNConv(1024, 1, (3, 1), padding=[(1, 1), (0, 0)]))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        B, C, T = x.shape
        p = self.period
        pad = (p - T % p) % p
        if pad:
            x = F.pad(x, (0, pad), mode="reflect")
        z = x.reshape(B, C, x.shape[2] // p, p)
        return _convnet(self.convs, z, True, DESCRIPT_SLOPE)


class DescriptMSD(nn.Module):
    """Scale discriminator of the Descript stack: a kaiser anti-aliased
    downsample by ``scale`` (none at 1), then a grouped conv ladder
    (head k 15, 1 -> 16, on kernels B2/B3 where the gate allows); leaky
    ReLU 0.1, features taken after it."""

    SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16),
             (1024, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1))

    def __init__(self, scale: int = 1):
        super().__init__()
        self.scale = scale
        if scale != 1:
            filt = kaiser_filter(math.pi / scale, 140)
            if not len(filt) % 2:
                filt = np.pad(filt, (1, 0))
            self.register_buffer("filt", torch.tensor(
                filt, dtype=torch.float32).reshape(1, 1, -1),
                persistent=False)
        convs, ci = [], 1
        for co, k, st, g in self.SPECS:
            convs.append(WNConv(ci, co, (k,), (st,), [(k // 2, k // 2)],
                                groups=g))
            ci = co
        convs.append(WNConv(ci, 1, (3,), padding=[(1, 1)]))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.scale != 1:
            x = F.conv1d(x, self.filt.to(x.dtype), stride=self.scale,
                         padding=self.filt.shape[-1] // 2)
        return _convnet(self.convs, x, True, DESCRIPT_SLOPE)


class DescriptMRD(nn.Module):
    """Resolution discriminator of the Descript stack: the complex STFT
    (window ``window_length``, hop a quarter of it), real and imaginary
    parts as two channels over ``(frames, bins)``, split into the
    :data:`DESCRIPT_BANDS` of the bins; per band (``band{b}_conv{l}``)
    four ``(3, 9)`` convs of 32 channels (stride 2 along frequency but
    the first) and a ``(3, 3)`` one, leaky ReLU 0.1, features after it;
    the bands concatenated along frequency into the ``post`` score
    conv."""

    SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
             ((3, 9), (1, 2)), ((3, 3), (1, 1)))

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands=DESCRIPT_BANDS):
        super().__init__()
        self.window_length = window_length
        self.hop = int(hop_factor * window_length)
        n_bins = window_length // 2 + 1
        self.bands = [(int(b0 * n_bins), int(b1 * n_bins)) for b0, b1 in bands]
        for bi in range(len(self.bands)):
            ci = 2
            for li, (k, st) in enumerate(self.SPECS):
                pad = [((k[0] - 1) // 2,) * 2, ((k[1] - 1) // 2,) * 2]
                self.add_module(f"band{bi}_conv{li}",
                                WNConv(ci, 32, k, st, pad))
                ci = 32
        self.post = WNConv(32, 1, (3, 3), padding=[(1, 1), (1, 1)])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        s = stft(x[:, 0], self.window_length, self.hop)
        z = torch.stack([s.real, s.imag], 1).to(x.dtype)
        feats, outs = [], []
        for bi, (b0, b1) in enumerate(self.bands):
            band = z[..., b0:b1]
            for li in range(len(self.SPECS)):
                band = _lrelu(getattr(self, f"band{bi}_conv{li}")(band),
                              DESCRIPT_SLOPE)
                feats.append(band)
            outs.append(band)
        feats.append(self.post(torch.cat(outs, dim=3)))
        return feats


class DescriptDiscriminator(nn.Module):
    """MPDs over ``periods`` (``mpd{i}``), MSDs over ``rates``
    (``msd{i}``, none by default) and MRDs over ``fft_sizes``
    (``mrd{i}``), after removing the clip's mean and scaling its peak to
    0.8, in float32 (the JAX package keeps this preprocess in float32:
    the backward of ``1 / (peak + 1e-9)`` blows up in low precision on
    near-silent generator output)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 rates: Sequence[int] = (),
                 fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self.subs = []
        for prefix, make, args in (("mpd", DescriptMPD, periods),
                                   ("msd", DescriptMSD, rates),
                                   ("mrd", DescriptMRD, fft_sizes)):
            for i, a in enumerate(args):
                self.add_module(f"{prefix}{i}", make(a))
                self.subs.append(f"{prefix}{i}")

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        x32 = x.float()
        x32 = x32 - x32.mean(dim=2, keepdim=True)
        x = (0.8 * x32 / (x32.abs().amax(dim=2, keepdim=True) + 1e-9)
             ).to(x.dtype)
        return [getattr(self, name)(x) for name in self.subs]


class CombineDiscriminators(nn.Module):
    """Concatenated sub-discriminator outputs of the members, in order.
    As in the JAX package, the ``periods`` member keeps its own capacity
    (64), ``scales`` and ``spectral_1d`` take ``capacity`` and
    ``spectral`` its own 32; the spectral members run over
    ``spectral_scales``."""

    def __init__(self, members: Sequence[str], capacity: int = 64,
                 spectral_scales: Sequence[int] = (4096, 2048, 1024, 512,
                                                   256)):
        super().__init__()
        self.members = tuple(members)
        # member -> (flax name, constructor)
        build = {
            "periods": ("mpd", MultiPeriodDiscriminator),
            "scales": ("msd", lambda: MultiScaleDiscriminator(
                capacity=capacity)),
            "spectral": ("msspec", lambda: MultiScaleSpectralDiscriminator(
                spectral_scales)),
            "spectral_1d": ("msspec1d",
                            lambda: MultiScaleSpectralDiscriminator1d(
                                spectral_scales, capacity)),
            "univnet": ("univnet", UnivNetDiscriminator),
            "melgan_stack": ("stack", StackDiscriminators),
            "descript": ("descript", DescriptDiscriminator),
        }
        self.names = []
        for m in self.members:
            if m not in build:
                raise ValueError(f"unknown discriminator member {m!r}")
            name, make = build[m]
            self.add_module(name, make())
            self.names.append(name)

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        out = []
        for name in self.names:
            out.extend(getattr(self, name)(x))
        return out


def member_sub_count(member: str, disc_cfg=None) -> int:
    """Number of sub-discriminators (feature lists) a combine member
    emits; the spectral members follow ``disc_cfg.spectral_scales``."""
    if disc_cfg is not None and member in ("spectral", "spectral_1d"):
        return len(disc_cfg.spectral_scales)
    return {
        "periods": 5,
        "scales": 3,
        "spectral": 5,
        "spectral_1d": 5,
        "univnet": 8,        # 3 MRD + 5 MPD
        "melgan_stack": 3,
        "descript": 8,       # 5 MPD + 3 MRD
    }[member]


def build_discriminator(cfg: RAVEConfig, device="cuda") -> nn.Module:
    """The configured discriminator, on ``device``: the JAX package's
    dispatch (``combine`` and ``multi_scale`` read the config, the other
    kinds take their defaults)."""
    d = cfg.discriminator
    kinds = {
        "combine": lambda: CombineDiscriminators(
            tuple(d.members), d.capacity, tuple(d.spectral_scales)),
        "multi_scale": lambda: MultiScaleDiscriminator(
            capacity=d.capacity, n_layers=d.n_layers),
        "multi_period": MultiPeriodDiscriminator,
        "spectral": MultiScaleSpectralDiscriminator,
        "spectral_1d": MultiScaleSpectralDiscriminator1d,
        "univnet": UnivNetDiscriminator,
        "melgan_stack": StackDiscriminators,
        "descript": lambda: DescriptDiscriminator(
            tuple(d.periods), fft_sizes=tuple(d.fft_sizes)),
    }
    if d.kind not in kinds:
        raise ValueError(f"unknown discriminator kind {d.kind!r}")
    return kinds[d.kind]().to(resolve_device(device))
