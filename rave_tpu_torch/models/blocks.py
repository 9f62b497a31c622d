"""Building blocks: activations (leaky ReLU, Snake), AdaIN, BatchNorm,
the GRU layer, dilated residual units, EncoderV2, GeneratorV2 (with its
filtered-noise branch), the v1 family: residual layers, blocks and
stacks, the upsampler, EncoderV1, NoiseGeneratorV1, GeneratorV1; and the
hybrid preset's mel front end.

Port of ``rave_tpu/models/blocks.py``.  Layout is channels-first
``(B, C, T)``.  Every block threads the static delay algebra of
:mod:`rave_tpu_torch.ops.delay`; streaming state lives in the
:class:`~rave_tpu_torch.ops.conv.Cached` modules (AdaIN's statistics and
controls too, the noise generators' uniform draw, fixed over a stream,
the GRU's hidden states and the mel front end's sample context).
Modules are registered in the order the JAX package creates them, which
:mod:`rave_tpu_torch.convert` relies on.

Dtypes follow the JAX package's flow: a block computes in its input's
dtype (bf16 under ``compute_dtype=bfloat16``, :mod:`rave_tpu_torch.ops.
precision`), its float32 parameters cast per call, and promotes to
float32 where flax does: AdaIN's float32 statistics (outside training),
BatchNorm's float32 parameters, the noise branch's float32 impulse
response.  What follows a promotion runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import (Cached, Conv1d, ConvTranspose1d, Delay, StreamDraw,
                        StreamSetup)
from ..ops.delay import get_padding, plan_conv, plan_conv_transpose
from ..ops.kernels.residual_unit import residual_unit
from ..ops.losses import amp_to_impulse_response, fft_convolve, mod_sigmoid
from ..ops.precision import leaky_relu, sigmoid, weak
from ..ops.stft import hann_window, mel_matrix, stft
from ..parallel import mesh


def normalize_dilations(dilations, ratios):
    if isinstance(dilations[0], int):
        dilations = [dilations for _ in ratios]
    return list(dilations)


def conv_delay(kernel_size: int, stride: int = 1, dilation: int = 1,
               mode: str = "centered", in_delay: int = 0) -> int:
    return plan_conv(kernel_size, stride, dilation, mode, in_delay).out_delay


def upsample_delay(ratio: int, mode: str, in_delay: int = 0) -> int:
    if ratio > 1:
        return plan_conv_transpose(2 * ratio, ratio, ratio // 2,
                                   in_delay).out_delay
    return conv_delay(3, 1, 1, mode, in_delay)


def residual_layer_delay(kernel_size: int, dilations, mode: str) -> int:
    d = 0
    for dil in dilations:
        d = conv_delay(kernel_size, 1, dil, mode, d)
    return d


def residual_block_delay(kernel_size: int, dilations_list, mode: str) -> int:
    return sum(residual_layer_delay(kernel_size, dl, mode)
               for dl in dilations_list)


class Activation(nn.Module):
    """LeakyReLU with slope 0.2, or Snake ``x + sin(alpha x)^2 / alpha``
    with a per-channel ``alpha`` ``(dim,)`` (initialised to ones)."""

    def __init__(self, kind: str = "leaky_relu", dim: int = 0,
                 negative_slope: float = 0.2):
        super().__init__()
        if kind not in ("leaky_relu", "snake"):
            raise ValueError(f"unknown activation {kind!r}")
        self.kind, self.negative_slope = kind, negative_slope
        if kind == "snake":
            self.alpha = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "leaky_relu":
            return leaky_relu(x, self.negative_slope)
        alpha = self.alpha.to(x.dtype)[:, None]
        return x + (1.0 / (alpha + weak(1e-9, x))) * torch.sin(alpha * x) ** 2


class AdaIN(Cached):
    """Adaptive instance normalisation for timbre transfer while serving.

    Training runs it as the identity.  Serving (``train_mode`` off) keeps
    its state ``(B, C, 8)`` as the module's cache, carried with the conv
    caches: per batch slot and channel the source's and the target's
    running mean and std (``std`` with ``ddof=1`` over time), and,
    replicated over both axes, the update counters and the float flags
    ``learn_x``/``learn_y`` (slots :attr:`SLOTS`).  A streaming pass with
    ``learn_y`` on folds the chunk's statistics into the target's; with
    ``learn_x`` on (and ``learn_y`` off) into the source's: target
    learning wins.  Once both have statistics and ``learn_y`` is off, the
    output is ``(x - mean_x) / (std_x + 1e-5) * std_y + mean_y``.  An
    offline pass reads a state it was given and updates nothing; without
    one it is the identity (no statistics yet).  The state is float32
    whatever ``x`` is, and outside training the output is float32 too
    (flax's promotion of a bf16 ``x`` against float32 statistics).
    """

    SLOTS = ("mean_x", "std_x", "mean_y", "std_y", "num_update_x",
             "num_update_y", "learn_x", "learn_y")
    MEAN_X, STD_X, MEAN_Y, STD_Y, N_X, N_Y, LEARN_X, LEARN_Y = range(8)
    carry_last = True

    def __init__(self, dim: int, ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.dim, self.ss = dim, ss
        self.train_mode = True

    @classmethod
    def initial_state(cls, batch: int, dim: int, device=None,
                      dtype=torch.float32) -> torch.Tensor:
        """No statistics, learning off: zeros, the stds one."""
        s = torch.zeros(batch, dim, 8, device=device, dtype=dtype)
        s[..., cls.STD_X] = 1.0
        s[..., cls.STD_Y] = 1.0
        return s

    def initial(self, like: torch.Tensor) -> torch.Tensor:
        return self.initial_state(like.shape[0], self.dim, like.device,
                                  like.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.train_mode:
            return x
        dtype = torch.promote_types(x.dtype, torch.float32)
        state = self.cache
        if state is None:
            if not self.ss.streaming:
                return x.to(dtype)
            state = self.initial_state(x.shape[0], self.dim, x.device,
                                       dtype)

        def slot(k):
            return state[..., k:k + 1]

        if self.ss.streaming:
            mean = x.mean(2, keepdim=True)
            std = x.std(2, keepdim=True)

            def upd(k, src, n):
                return slot(k) + (src - slot(k)) / (slot(n) + 1)

            learn_y = slot(self.LEARN_Y) > 0
            do_x = ~learn_y & (slot(self.LEARN_X) > 0)
            mean_y = torch.where(learn_y, upd(self.MEAN_Y, mean, self.N_Y),
                                 slot(self.MEAN_Y))
            std_y = torch.where(learn_y, upd(self.STD_Y, std, self.N_Y),
                                slot(self.STD_Y))
            mean_x = torch.where(do_x, upd(self.MEAN_X, mean, self.N_X),
                                 slot(self.MEAN_X))
            std_x = torch.where(do_x, upd(self.STD_X, std, self.N_X),
                                slot(self.STD_X))
            state = torch.cat([mean_x, std_x, mean_y, std_y,
                               slot(self.N_X) + do_x, slot(self.N_Y) + learn_y,
                               slot(self.LEARN_X), slot(self.LEARN_Y)], -1)
            self.cache = state
        transfer = (x - slot(self.MEAN_X)) / (slot(self.STD_X) + 1e-5) \
            * slot(self.STD_Y) + slot(self.MEAN_Y)
        use = ((slot(self.LEARN_Y) <= 0) & (slot(self.N_X) > 0)
               & (slot(self.N_Y) > 0))
        return torch.where(use, transfer, x)


class BatchNorm(nn.Module):
    """flax's ``BatchNorm`` over the channel axis 1 (eps 1e-5, momentum
    0.99).  With ``train_bn`` false it normalises by the stored
    statistics (``use_running_average=True``).  With ``train_bn`` it
    normalises by the batch's mean and biased variance, taken as
    ``max(E[x^2] - E[x]^2, 0)`` (flax's ``use_fast_variance``), and moves
    the stored ones to ``0.99 * r + 0.01 * batch``; the update happens
    under ``no_grad`` too, as a flax D step's does.  ``F.batch_norm``'s
    training mode differs (unbiased variance in the update, momentum 0.1).
    ``train()`` and ``eval()`` change nothing: ``train_bn`` decides.  A
    bf16 ``x`` is promoted to float32 first, as flax promotes it against
    the float32 parameters."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.train_bn = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if not self.train_bn:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        axes = (0,) + tuple(range(2, x.dim()))
        # over the global batch under a process group (parallel.mesh)
        mu, ex2 = mesh.global_moments(x, axes)
        var = torch.clamp(ex2 - mu * mu, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mu.detach(), alpha=1 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)


class GRULayer(Cached):
    """``num_layers`` stacked GRUs of width ``dim`` over the time axis of
    ``(B, dim, T)``: flax's ``nn.RNN(nn.GRUCell)`` per layer, from a zero
    state offline, from the carried state ``(B, num_layers, dim)`` (this
    module's cache) in a stream.  Causal, so it adds no delay.

    Layer ``l`` keeps flax's cell: ``weight_ih{l}`` ``[ir|iz|in]``
    ``(3 dim, dim)`` with ``bias_ih{l}``, ``weight_hh{l}`` ``[hr|hz|hn]``
    with only ``bias_hn{l}`` ``(dim,)`` (flax's ``hr`` and ``hz`` have no
    bias), so that ``r = sigmoid(x W_ir + b_ir + h W_hr)``, ``z`` alike,
    ``n = tanh(x W_in + b_in + r (h W_hn + b_hn))``, ``h' = (1 - z) n
    + z h``.  That is ``torch.gru`` (cuDNN on the card) with a hidden bias
    ``[0|0|b_hn]``, which runs offline and in training; a stream steps
    the same cell by hand (:meth:`cell`), which ``torch.export``,
    AOTInductor and CUDA-graph capture take as plain matmuls.
    Initialised as flax's cell: input kernels normal with std
    ``1/sqrt(dim)``, recurrent kernels orthogonal per gate, biases zero.
    """

    def __init__(self, dim: int, num_layers: int = 1,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.dim, self.num_layers, self.ss = dim, num_layers, ss
        for layer in range(num_layers):
            w_hh = torch.empty(3 * dim, dim)
            for g in range(3):
                nn.init.orthogonal_(w_hh[g * dim:(g + 1) * dim])
            self.register_parameter(f"weight_ih{layer}", nn.Parameter(
                torch.randn(3 * dim, dim) / dim ** 0.5))
            self.register_parameter(f"weight_hh{layer}", nn.Parameter(w_hh))
            self.register_parameter(f"bias_ih{layer}", nn.Parameter(
                torch.zeros(3 * dim)))
            self.register_parameter(f"bias_hn{layer}", nn.Parameter(
                torch.zeros(dim)))

    def weights(self, layer: int) -> tuple:
        """``(weight_ih, weight_hh, bias_ih, bias_hh)`` of ``layer``, the
        hidden bias ``[0|0|b_hn]``."""
        b_hn = getattr(self, f"bias_hn{layer}")
        return (getattr(self, f"weight_ih{layer}"),
                getattr(self, f"weight_hh{layer}"),
                getattr(self, f"bias_ih{layer}"),
                torch.cat([b_hn.new_zeros(2 * self.dim), b_hn]))

    def cell(self, x: torch.Tensor, h: torch.Tensor,
             layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer`` over ``x`` ``(B, T, dim)`` from the state ``h``
        ``(B, dim)``, one frame at a time: ``(outputs, last state)``."""
        w_ih, w_hh, b_ih, b_hh = self.weights(layer)
        gi = F.linear(x, w_ih, b_ih)
        outs = []
        for t in range(x.shape[1]):
            gh = F.linear(h, w_hh, b_hh)
            i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1), h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.transpose(1, 2)
        if self.ss.streaming:
            state = self._zeros_cache(x, self.num_layers, self.dim)
            last = []
            for layer in range(self.num_layers):
                seq, h = self.cell(seq, state[:, layer], layer)
                last.append(h)
            self.cache = torch.stack(last, dim=1)
            return seq.transpose(1, 2)
        h0 = x.new_zeros(self.num_layers, x.shape[0], self.dim)
        flat = [w for layer in range(self.num_layers)
                for w in self.weights(layer)]
        out, _ = torch.gru(seq.contiguous(), h0, flat, True,
                           self.num_layers, 0.0, self.training, False, True)
        return out.transpose(1, 2)


class DilatedUnit(nn.Module):
    """act -> dilated conv(k) -> act -> 1x1 conv.  Stride 1; own delay =
    the dilated conv's right pad."""

    def __init__(self, dim: int, kernel_size: int, dilation: int,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.dim, self.kernel_size, self.dilation = dim, kernel_size, dilation
        self.activation = activation
        self.ss = ss
        self.act1 = Activation(activation, dim)
        self.conv1 = Conv1d(dim, dim, kernel_size, dilation=dilation,
                            weight_norm=weight_norm, ss=ss)
        self.act2 = Activation(activation, dim)
        self.conv2 = Conv1d(dim, dim, 1, weight_norm=weight_norm, ss=ss)

    @property
    def out_delay(self) -> int:
        return conv_delay(self.kernel_size, 1, self.dilation, self.ss.mode)

    def fusable(self, in_ch: int) -> bool:
        """Whether the fused kernel B1 can run this unit: offline, plain
        leaky_relu, square channels with C % 128 == 0 and C <= 512 (the
        gate of the JAX package, unchanged)."""
        return (not self.ss.streaming
                and self.activation == "leaky_relu"
                and in_ch == self.dim
                and self.dim % 128 == 0 and self.dim <= 512)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.act2(self.conv1(self.act1(x))))


class Residual(nn.Module):
    """x + f(x), the skip delayed by f's streaming delay.  With ``fused``
    and a fusable unit the whole chain is one launch of kernel B1."""

    def __init__(self, inner: DilatedUnit, inner_delay: int,
                 ss: StreamSetup = StreamSetup(), fused: bool = False):
        super().__init__()
        self.inner = inner
        self.skip = Delay(inner_delay, ss)
        self.ss = ss
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        du = self.inner
        if self.fused and du.fusable(x.shape[1]):
            pl, pr = get_padding(du.kernel_size, 1, du.dilation, self.ss.mode)
            # every operand in x's dtype, as Conv1d(return_weights=True)
            # hands them to the Pallas kernel
            d = x.dtype
            return residual_unit(x, du.conv1.kernel().to(d),
                                 du.conv1.bias.to(d),
                                 du.conv2.kernel()[:, :, 0].to(d),
                                 du.conv2.bias.to(d), du.dilation, pl, pr)
        return du(x) + self.skip(x)


class _NoiseGenerator(nn.Module):
    """Filtered noise: strided causal convs (kernel ``2r``, whatever the
    model's mode, so that the branch streams exactly) -> band amplitudes
    ``mod_sigmoid(x - 5)`` -> a windowed impulse response per frame and
    band -> uniform noise in [-1, 1) convolved with it by FFT.

    The noise ``(B, T', data_size, prod(ratios))`` (``T'`` the frames
    after the convs) is an argument, or drawn from ``generator``; in a
    stream it is the :class:`~rave_tpu_torch.ops.conv.StreamDraw`'s
    fixed draw.  Output ``(B, data_size, T' * prod(ratios))``.
    """

    def __init__(self, channels: Sequence[int], data_size: int,
                 ratios: Sequence[int], noise_bands: int, activation: str,
                 ss: StreamSetup):
        super().__init__()
        self.data_size, self.noise_bands = data_size, noise_bands
        self.ratios = list(ratios)
        causal = dataclasses.replace(ss, mode="causal")
        layers = []
        for i, r in enumerate(self.ratios):
            layers.append(Conv1d(channels[i], channels[i + 1], 2 * r,
                                 stride=r, ss=causal))
            if i != len(self.ratios) - 1:
                layers.append(Activation(activation, channels[i + 1]))
        self.net = nn.Sequential(*layers)
        self.draw = StreamDraw("uniform", ss)

    @property
    def total_ratio(self) -> int:
        t = 1
        for r in self.ratios:
            t *= r
        return t

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        amp = mod_sigmoid(self.net(x) - 5.0)
        B, _, Tp = amp.shape
        amp = amp.transpose(1, 2).reshape(B, Tp, self.data_size,
                                           self.noise_bands)
        ir = amp_to_impulse_response(amp, self.total_ratio)
        out = fft_convolve(self.draw(ir.shape, ir, noise, generator), ir)
        return out.transpose(1, 2).reshape(B, self.data_size,
                                           Tp * self.total_ratio)


class NoiseGeneratorV2(_NoiseGenerator):
    """GeneratorV2's noise branch: ``in_size`` -> ``hidden_size`` per
    hidden conv -> ``data_size * noise_bands``, the model's activation
    between the convs."""

    def __init__(self, in_size: int, hidden_size: int, data_size: int,
                 ratios: Sequence[int], noise_bands: int,
                 activation: str = "leaky_relu",
                 ss: StreamSetup = StreamSetup()):
        channels = ([in_size] + [hidden_size] * (len(ratios) - 1)
                    + [data_size * noise_bands])
        super().__init__(channels, data_size, ratios, noise_bands,
                         activation, ss)


class NoiseGeneratorV1(_NoiseGenerator):
    """GeneratorV1's noise branch: ``in_size`` channels through every
    hidden conv, leaky ReLU between them; ratios (4, 4, 4), 5 bands."""

    def __init__(self, in_size: int, data_size: int,
                 ratios: Sequence[int] = (4, 4, 4), noise_bands: int = 5,
                 ss: StreamSetup = StreamSetup()):
        channels = [in_size] * len(ratios) + [data_size * noise_bands]
        super().__init__(channels, data_size, ratios, noise_bands,
                         "leaky_relu", ss)


class EncoderV2(nn.Module):
    """Dilated residual encoder: in conv, residual units, strided downs."""

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int],
                 latent_size: int, n_out: int, kernel_size: int,
                 dilations: Sequence, keep_dim: bool = False,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 adain: bool = False, fused: bool = False, in_delay: int = 0,
                 gru_layers: int = 0, ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.capacity, self.ratios = capacity, list(ratios)
        self.adain = adain
        self.latent_size, self.n_out = latent_size, n_out
        self.kernel_size, self.dilations = kernel_size, dilations
        self.keep_dim, self.in_delay, self.ss = keep_dim, in_delay, ss

        layers = []
        ch = data_size
        for kind, kw in self._walk()[0]:
            if kind == "in_conv":
                layers.append(Conv1d(ch, kw["features"], kw["kernel_size"],
                                     weight_norm=weight_norm, ss=ss))
            elif kind == "adain":
                layers.append(AdaIN(kw["dim"], ss))
            elif kind == "residual_unit":
                inner = DilatedUnit(kw["dim"], kernel_size, kw["dilation"],
                                    activation, weight_norm, ss)
                layers.append(Residual(inner, kw["inner_delay"], ss, fused))
            else:  # "down" / "out_conv"
                layers.append(nn.Sequential(
                    Activation(activation, ch),
                    Conv1d(ch, kw["features"], kw["kernel_size"],
                           stride=kw.get("stride", 1),
                           in_delay=kw.get("in_delay", 0),
                           weight_norm=weight_norm, ss=ss)))
            ch = kw.get("features", ch)
        self.layers = nn.ModuleList(layers)
        self.gru = GRULayer(ch, gru_layers, ss) if gru_layers else None

    def _walk(self):
        """``[(kind, kwargs)]`` in build order, and the final delay."""
        mode = self.ss.mode
        dilations_list = normalize_dilations(self.dilations, self.ratios)
        steps = []
        num_channels = self.capacity
        steps.append(("in_conv", dict(features=num_channels,
                                      kernel_size=2 * self.kernel_size + 1)))
        d = conv_delay(2 * self.kernel_size + 1, 1, 1, mode, self.in_delay)
        for r, dils in zip(self.ratios, dilations_list):
            for dil in dils:
                if self.adain:
                    steps.append(("adain", dict(dim=num_channels)))
                unit_d = conv_delay(self.kernel_size, 1, dil, mode)
                steps.append(("residual_unit",
                              dict(dim=num_channels, dilation=dil,
                                   inner_delay=unit_d)))
                d += unit_d
            out_channels = num_channels * (r if self.keep_dim else 2)
            steps.append(("down", dict(features=out_channels,
                                       kernel_size=2 * r,
                                       stride=r, in_delay=d)))
            d = conv_delay(2 * r, r, 1, mode, d)
            num_channels = out_channels
        steps.append(("out_conv", dict(features=self.latent_size * self.n_out,
                                       kernel_size=self.kernel_size)))
        d = conv_delay(self.kernel_size, 1, 1, mode, d)
        return steps, d

    @property
    def out_delay(self) -> int:
        return self._walk()[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x if self.gru is None else self.gru(x)


class GeneratorV2(nn.Module):
    """Mirror decoder: with ``gru_layers`` a :class:`GRULayer` on the
    latent, then conv, transposed-conv upsamplers with residual units,
    amplitude modulation, with ``use_noise`` the filtered noise of
    :class:`NoiseGeneratorV2` (fed the last activation, added after the
    modulation), tanh."""

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int],
                 latent_size: int, kernel_size: int, dilations: Sequence,
                 keep_dim: bool = False, amplitude_modulation: bool = False,
                 use_noise: bool = False, noise_hidden: int = 128,
                 noise_ratios: Sequence[int] = (2, 2, 2),
                 noise_bands: int = 5,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 adain: bool = False, fused: bool = False,
                 gru_layers: int = 0, ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.data_size, self.capacity = data_size, capacity
        self.ratios, self.kernel_size = list(ratios), kernel_size
        self.dilations, self.keep_dim = dilations, keep_dim
        self.amplitude_modulation = amplitude_modulation
        self.ss = ss

        dilations_list, rev_ratios, num_channels = self._plan()
        self.gru = (GRULayer(latent_size, gru_layers, ss) if gru_layers
                    else None)
        layers = [Conv1d(latent_size, num_channels, kernel_size,
                         weight_norm=weight_norm, ss=ss)]
        d = conv_delay(kernel_size, 1, 1, ss.mode)
        for r, dils in zip(rev_ratios, dilations_list):
            out_channels = num_channels // (r if keep_dim else 2)
            up = ConvTranspose1d(num_channels, out_channels, 2 * r, r,
                                 weight_norm=weight_norm, in_delay=d, ss=ss)
            layers.append(nn.Sequential(Activation(activation, num_channels),
                                        up))
            d = up.out_delay
            num_channels = out_channels
            for dil in dils:
                if adain:
                    layers.append(AdaIN(num_channels, ss))
                inner = DilatedUnit(num_channels, kernel_size, dil,
                                    activation, weight_norm, ss)
                layers.append(Residual(inner, inner.out_delay, ss, fused))
                d += inner.out_delay
        wave_features = data_size * (2 if amplitude_modulation else 1)
        layers.append(nn.Sequential(
            Activation(activation, num_channels),
            Conv1d(num_channels, wave_features, kernel_size * 2 + 1,
                   weight_norm=weight_norm, ss=ss)))
        self.layers = nn.ModuleList(layers)
        self.noise = (NoiseGeneratorV2(num_channels, noise_hidden, data_size,
                                       noise_ratios, noise_bands, activation,
                                       ss) if use_noise else None)

    def _plan(self):
        dilations_list = normalize_dilations(self.dilations, self.ratios)[::-1]
        ratios = list(self.ratios)[::-1]
        if self.keep_dim:
            num_channels = self.capacity
            for r in self.ratios:
                num_channels *= r
        else:
            num_channels = 2 ** len(ratios) * self.capacity
        return dilations_list, ratios, num_channels

    @property
    def out_delay(self) -> int:
        mode = self.ss.mode
        dilations_list, ratios, _ = self._plan()
        d = conv_delay(self.kernel_size, 1, 1, mode)
        for r, dils in zip(ratios, dilations_list):
            d = plan_conv_transpose(2 * r, r, r // 2, d).out_delay
            for dil in dils:
                d += conv_delay(self.kernel_size, 1, dil, mode)
        return conv_delay(self.kernel_size * 2 + 1, 1, 1, mode, d)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``noise``/``generator``: the noise branch's draw (see
        :class:`NoiseGeneratorV2`), unused without ``use_noise``."""
        if self.gru is not None:
            x = self.gru(x)
        for layer in self.layers[:-1]:
            x = layer(x)
        act, conv = self.layers[-1]
        x = act(x)
        wave = conv(x)
        if self.amplitude_modulation:
            wav, amp = wave.chunk(2, dim=1)
            wave = wav * sigmoid(amp)
        if self.noise is not None:
            wave = wave + self.noise(x, noise, generator)
        return torch.tanh(wave)


# ------------------------- v1 blocks ------------------------------------


class SampleNorm(nn.Module):
    """Each frame divided by its L2 norm over the channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.float32, torch.float64):
            return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        # bf16: the squares rounded, then summed, as jnp.linalg.norm does
        return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


class ResidualLayer(nn.Module):
    """(act, dilated conv) pairs plus the input, delayed by the chain's
    streaming delay."""

    def __init__(self, dim: int, kernel_size: int, dilations: Sequence[int],
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        layers = []
        for dil in dilations:
            layers += [Activation(activation, dim),
                       Conv1d(dim, dim, kernel_size, dilation=dil,
                              weight_norm=weight_norm, ss=ss)]
        self.net = nn.Sequential(*layers)
        self.skip = Delay(residual_layer_delay(kernel_size, dilations,
                                               ss.mode), ss)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x) + self.skip(x)


class ResidualBlock(nn.Sequential):
    """ResidualLayers in sequence, one per dilation list."""

    def __init__(self, dim: int, kernel_size: int, dilations_list,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 ss: StreamSetup = StreamSetup()):
        super().__init__(*(ResidualLayer(dim, kernel_size, dil, activation,
                                         weight_norm, ss)
                           for dil in dilations_list))


class ResidualStack(nn.Module):
    """One ResidualBlock per kernel size in parallel, each delayed to the
    slowest branch, summed."""

    def __init__(self, dim: int, kernel_sizes: Sequence[int], dilations_list,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        delays = [residual_block_delay(k, dilations_list, ss.mode)
                  for k in kernel_sizes]
        self.out_delay = max(delays)
        self.blocks = nn.ModuleList(
            ResidualBlock(dim, k, dilations_list, activation, weight_norm, ss)
            for k in kernel_sizes)
        self.align = nn.ModuleList(Delay(self.out_delay - d, ss)
                                   for d in delays)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = None
        for block, align in zip(self.blocks, self.align):
            y = align(block(x))
            out = y if out is None else out + y
        return out


class UpsampleLayer(nn.Module):
    """act + transposed conv (kernel ``2r``, stride ``r``, no bias), or a
    kernel-3 conv at ratio 1."""

    def __init__(self, in_dim: int, out_dim: int, ratio: int,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 in_delay: int = 0, ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.act = Activation(activation, in_dim)
        if ratio > 1:
            self.conv = ConvTranspose1d(in_dim, out_dim, 2 * ratio, ratio,
                                        weight_norm=weight_norm,
                                        in_delay=in_delay, ss=ss)
        else:
            self.conv = Conv1d(in_dim, out_dim, 3, weight_norm=weight_norm,
                               in_delay=in_delay, ss=ss)
        self.out_delay = self.conv.out_delay

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.act(x))


class EncoderV1(nn.Module):
    """Strided-conv encoder: a kernel-7 conv, then per ratio ``r`` (norm,
    act, conv of kernel ``2r + 1`` and stride ``r`` doubling the
    channels) and ``repeat_layers - 1`` more (norm, act, kernel-3 conv);
    act and a kernel-5 conv in ``n_out`` groups.  The norm is
    :class:`SampleNorm`, or :class:`BatchNorm` at flax's momentum 0.9
    (eps 1e-5): batch statistics, its running ones advanced, while its
    ``train_bn`` holds (the model's ``train_mode``), else the running
    ones, a per-channel affine that streams chunk by chunk."""

    def __init__(self, data_size: int, capacity: int, latent_size: int,
                 ratios: Sequence[int], n_out: int, sample_norm: bool = False,
                 repeat_layers: int = 1, activation: str = "leaky_relu",
                 weight_norm: bool = False, ss: StreamSetup = StreamSetup()):
        super().__init__()

        def norm(ch):
            return SampleNorm() if sample_norm else BatchNorm(ch, momentum=0.9)

        conv = Conv1d(data_size, capacity, 7, weight_norm=weight_norm, ss=ss)
        layers, ch = [conv], capacity
        for i, r in enumerate(ratios):
            out_dim = 2 ** (i + 1) * capacity
            for j in range(repeat_layers):
                conv = Conv1d(ch, out_dim, 2 * r + 1 if j == 0 else 3,
                              stride=r if j == 0 else 1,
                              in_delay=conv.out_delay,
                              weight_norm=weight_norm, ss=ss)
                layers += [norm(ch), Activation(activation, ch), conv]
                ch = out_dim
        conv = Conv1d(ch, latent_size * n_out, 5, groups=n_out,
                      in_delay=conv.out_delay, weight_norm=weight_norm, ss=ss)
        layers += [Activation(activation, ch), conv]
        self.out_delay = conv.out_delay
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class GeneratorV1(nn.Module):
    """v1 decoder: a kernel-7 conv, per ratio an upsampler and a residual
    stack, then three branches: ``tanh(wave) * mod_sigmoid(loudness)``,
    the two delay-aligned (the loudness conv has stride ``loud_stride``,
    repeated back to the band rate), plus with ``use_noise`` the
    :class:`NoiseGeneratorV1` noise times ``warmed_up``."""

    def __init__(self, latent_size: int, capacity: int, data_size: int,
                 ratios: Sequence[int], loud_stride: int = 1,
                 use_noise: bool = True, kernel_sizes: Sequence[int] = (3,),
                 dilations_list=((1, 1), (3, 1), (5, 1)),
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        n = len(ratios)
        self.loud_stride = loud_stride
        self.conv_in = Conv1d(latent_size, 2 ** n * capacity, 7,
                              weight_norm=weight_norm, ss=ss)
        d = self.conv_in.out_delay
        body = []
        for i, r in enumerate(ratios):
            out_dim = 2 ** (n - i - 1) * capacity
            up = UpsampleLayer(2 ** (n - i) * capacity, out_dim, r,
                               activation, weight_norm, d, ss)
            stack = ResidualStack(out_dim, kernel_sizes, dilations_list,
                                  activation, weight_norm, ss)
            d = up.out_delay + stack.out_delay
            body += [up, stack]
        self.body = nn.Sequential(*body)
        self.wave_conv = Conv1d(out_dim, data_size, 7,
                                weight_norm=weight_norm, in_delay=d, ss=ss)
        self.loud_conv = Conv1d(out_dim, 1, 2 * loud_stride + 1,
                                stride=loud_stride, weight_norm=weight_norm,
                                in_delay=d, ss=ss)
        wave_d = self.wave_conv.out_delay
        loud_d = self.loud_conv.out_delay * loud_stride
        self.out_delay = max(wave_d, loud_d)
        self.wave_align = Delay(self.out_delay - wave_d, ss)
        self.loud_align = Delay(self.out_delay - loud_d, ss)
        self.noise = (NoiseGeneratorV1(out_dim, data_size, ss=ss)
                      if use_noise else None)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                warmed_up=True) -> torch.Tensor:
        """``noise``/``generator``: the noise branch's draw (see
        :class:`NoiseGeneratorV1`), unused without ``use_noise``."""
        x = self.body(self.conv_in(x))
        wave = self.wave_conv(x)
        loud = self.loud_conv(x)
        if self.loud_stride != 1:
            loud = loud.repeat_interleave(self.loud_stride, dim=2)
        y = (torch.tanh(self.wave_align(wave))
             * mod_sigmoid(self.loud_align(loud)))
        if self.noise is not None:
            gate = torch.as_tensor(warmed_up, dtype=y.dtype, device=y.device)
            y = y + gate * self.noise(x, noise, generator)
        return y


# ----------------------------------------------------------------------
# the hybrid preset's mel-spectrogram front end (streaming-capable)
# ----------------------------------------------------------------------

def mel_front_delay(n_fft: int, hop: int) -> int:
    """Streaming delay of the centred mel front end in mel frames: a frame
    centred at ``k * hop`` needs ``n_fft - n_fft // 2`` samples after its
    centre, and the chunk itself gives one hop of them."""
    lookahead = n_fft - n_fft // 2
    return -(-lookahead // hop) - 1


class MelFrontEnd(Cached):
    """Audio ``(B, T)`` -> the log1p power mel spectrogram ``(B, n_mels,
    T // hop)``: periodic Hann, ``normalized`` (divided by the window's
    L2 norm) power spectrum, torchaudio's htk mel basis without norm,
    ``log1p``; no parameters (the basis is a constant).

    Offline the signal is reflect-padded by ``n_fft // 2`` on both sides
    and frames ``[0, T // hop)`` are kept.  In a stream the module's
    cache is the last ``D * hop + n_fft // 2`` samples (``D`` =
    :func:`mel_front_delay`), so a chunk gives ``chunk // hop`` frames,
    offline frame ``k`` arriving as streamed frame ``k + D``; the encoder
    takes ``D`` as its ``in_delay``.  The one difference is the clip head:
    offline reflect-pads the first ``n_fft // 2`` samples, a stream
    starts from zeros.
    """

    def __init__(self, n_fft: int, hop: int, n_mels: int, sample_rate: int,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.n_fft, self.hop, self.n_mels = n_fft, hop, n_mels
        self.sample_rate, self.ss = sample_rate, ss
        self.energy = float(np.sum(hann_window(n_fft).astype(np.float64)
                                   ** 2))

    @property
    def out_delay(self) -> int:
        return (mel_front_delay(self.n_fft, self.hop) if self.ss.streaming
                else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_fft, hop = self.n_fft, self.hop
        frames = x.shape[1] // hop
        if self.ss.streaming:
            ctx = mel_front_delay(n_fft, hop) * hop + n_fft // 2
            if self.cache is None:
                self.cache = x.new_zeros((x.shape[0], ctx))
            buf = torch.cat([self.cache, x], dim=1)
            self.cache = buf[:, buf.shape[1] - ctx:]
            spec = stft(buf, n_fft, hop, center=False)
        else:
            spec = stft(x, n_fft, hop)
        spec = spec[:, :frames]
        # normalized: the power over the window's energy (a real division;
        # a complex one has no AOTInductor C shim)
        power = (spec.real.square() + spec.imag.square()) / self.energy
        mel = power @ mel_matrix(self.sample_rate, n_fft, self.n_mels,
                                 x.device, htk=True, norm=None).T
        return torch.log1p(mel).transpose(1, 2)
