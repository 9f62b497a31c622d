"""v2 building blocks: activations (leaky ReLU, Snake), AdaIN, dilated
residual units, EncoderV2, GeneratorV2.

Port of the v2 part of ``rave_tpu/models/blocks.py``.  Layout is
channels-first ``(B, C, T)``.  Every block threads the static delay
algebra of :mod:`rave_tpu_torch.ops.delay`; streaming state lives in the
:class:`~rave_tpu_torch.ops.conv.Cached` modules (AdaIN's statistics and
controls too).  Modules are registered in the order the JAX package
creates them, which :mod:`rave_tpu_torch.convert` relies on.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Cached, Conv1d, ConvTranspose1d, Delay, StreamSetup
from ..ops.delay import get_padding, plan_conv, plan_conv_transpose
from ..ops.kernels.residual_unit import residual_unit


def normalize_dilations(dilations, ratios):
    if isinstance(dilations[0], int):
        dilations = [dilations for _ in ratios]
    return list(dilations)


def conv_delay(kernel_size: int, stride: int = 1, dilation: int = 1,
               mode: str = "centered", in_delay: int = 0) -> int:
    return plan_conv(kernel_size, stride, dilation, mode, in_delay).out_delay


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
            return F.leaky_relu(x, self.negative_slope)
        alpha = self.alpha.to(x.dtype)[:, None]
        return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


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
    one it is the identity (no statistics yet).
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
        state = self.cache
        if state is None:
            if not self.ss.streaming:
                return x
            state = self.initial_state(x.shape[0], self.dim, x.device,
                                       x.dtype)

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
            return residual_unit(x, du.conv1.kernel(), du.conv1.bias,
                                 du.conv2.kernel()[:, :, 0], du.conv2.bias,
                                 du.dilation, pl, pr)
        return du(x) + self.skip(x)


class EncoderV2(nn.Module):
    """Dilated residual encoder: in conv, residual units, strided downs."""

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int],
                 latent_size: int, n_out: int, kernel_size: int,
                 dilations: Sequence, keep_dim: bool = False,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 adain: bool = False, fused: bool = False, in_delay: int = 0,
                 ss: StreamSetup = StreamSetup()):
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
        return x


class GeneratorV2(nn.Module):
    """Mirror decoder: conv, transposed-conv upsamplers with residual
    units, amplitude modulation, tanh."""

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int],
                 latent_size: int, kernel_size: int, dilations: Sequence,
                 keep_dim: bool = False, amplitude_modulation: bool = False,
                 activation: str = "leaky_relu", weight_norm: bool = True,
                 adain: bool = False, fused: bool = False,
                 ss: StreamSetup = StreamSetup()):
        super().__init__()
        self.data_size, self.capacity = data_size, capacity
        self.ratios, self.kernel_size = list(ratios), kernel_size
        self.dilations, self.keep_dim = dilations, keep_dim
        self.amplitude_modulation = amplitude_modulation
        self.ss = ss

        dilations_list, rev_ratios, num_channels = self._plan()
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        if self.amplitude_modulation:
            wav, amp = x.chunk(2, dim=1)
            x = wav * torch.sigmoid(amp)
        return torch.tanh(x)
