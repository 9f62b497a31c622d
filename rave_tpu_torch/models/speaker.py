"""ECAPA-style speaker embedding network and the AAM-softmax head.

Port of ``rave_tpu/models/speaker.py`` for serving: ``SpeakerRAVE`` has
three dilated residual stages (d = 1, 3, 5; strides 4, 4, 2) over the 16
PQMF bands, a three-way feature concat, attentive statistics pooling and
a 256-dim linear head.  Its two norms are BatchNorms on stored statistics
(the pretrained-checkpoint layout) or, with ``cohort_norm``,
:class:`CohortNorm` (batch statistics, no stored ones).  Layout is
channels-first ``(B, C, T)``.  The network always runs offline and
centered, as in the JAX package.  It trains from scratch with
``train_speaker_encoder``: the cohort norm is plain tensor arithmetic
under autograd, and a BatchNorm built with ``train_bn`` normalises by
the batch's statistics and advances its running ones as flax does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv1d
from .blocks import BatchNorm, DilatedUnit, Residual


class CohortNorm(nn.Module):
    """Normalisation by the statistics of the batch itself ("cohort"):
    mean and biased variance over every axis but the channel axis 1, eps
    1e-5, learnable ``weight`` (flax ``scale``) and ``bias``, no stored
    statistics, the same in training and serving.  An embedding therefore
    depends on the whole batch it is computed in."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = (0,) + tuple(range(2, x.dim()))
        mu = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, correction=0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mu) / torch.sqrt(var + self.eps)
                * self.weight.view(shape) + self.bias.view(shape))


def standardize_embeddings(emb: torch.Tensor,
                           eps: float = 1e-10) -> torch.Tensor:
    """Per-feature standardisation of embeddings ``(B, D)`` across the
    batch (biased variance)."""
    mu = emb.mean(dim=0, keepdim=True)
    var = emb.var(dim=0, keepdim=True, correction=0)
    return (emb - mu) / torch.sqrt(var + eps)


class AAMSpeakerHead(nn.Module):
    """Additive-angular-margin softmax head: scaled cosines between the
    L2-normalised embedding and the L2-normalised class weights
    ``weight`` ``(D, classes)`` (the flax layout); with ``labels`` the
    margin is added to the target class's angle."""

    def __init__(self, dim: int, classes: int, margin: float = 0.2,
                 scale: float = 30.0, standardize: bool = False):
        super().__init__()
        self.classes, self.margin, self.scale = classes, margin, scale
        self.standardize = standardize
        # flax's lecun_normal: a normal cut at two deviations, scaled so
        # that the cut distribution has variance 1 / dim
        s = 1.0 / (0.87962566 * dim ** 0.5)
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(dim, classes), std=s, a=-2 * s, b=2 * s))

    def forward(self, emb: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight
        wn = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + 1e-9)
        if self.standardize:
            emb = standardize_embeddings(emb)
        en = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)
        cos = en @ wn                                       # (B, classes)
        if labels is None:
            return self.scale * cos
        theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
        cos_m = torch.cos(theta + self.margin)
        oh = F.one_hot(labels, self.classes).to(cos.dtype)
        return self.scale * (oh * cos_m + (1.0 - oh) * cos)


class _Stage(nn.Module):
    """Residual dilated unit, activation, strided conv (k = 2 * ratio)."""

    def __init__(self, dim: int, out_dim: int, dilation: int, ratio: int,
                 kernel_size: int = 3):
        super().__init__()
        inner = DilatedUnit(dim, kernel_size, dilation)
        self.residual = Residual(inner, inner.out_delay)
        self.down = Conv1d(dim, out_dim, 2 * ratio, stride=ratio,
                           weight_norm=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.leaky_relu(self.residual(x), 0.2))


def _max_pool_1d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    B, C, T = x.shape
    T -= T % window
    return x[:, :, :T].reshape(B, C, T // window, window).amax(-1)


class SpeakerRAVE(nn.Module):
    """PQMF bands ``(B, 16, T/16)`` -> embedding ``(B, 256)``.  Its norms
    are :class:`BatchNorm` (on stored statistics unless ``train_bn``) or,
    with ``cohort_norm``, :class:`CohortNorm`."""

    def __init__(self, n_band: int = 16, cohort_norm: bool = False):
        super().__init__()
        norm = CohortNorm if cohort_norm else BatchNorm
        self.in_layer = Conv1d(n_band, 128, 7, weight_norm=True)
        self.layer2 = _Stage(128, 256, dilation=1, ratio=4)
        self.layer3 = _Stage(256, 256, dilation=3, ratio=4)
        self.layer4 = _Stage(256, 256, dilation=5, ratio=2)
        self.cat_layer = Conv1d(256, 256, 1, weight_norm=True)
        self.out_layer = Conv1d(768, 768, 3, weight_norm=True)
        self.attn1 = Conv1d(3 * 768, 128, 1)
        self.attn_bn = norm(128)
        self.attn2 = Conv1d(128, 768, 1)
        self.bn5 = norm(1536)
        self.fc6 = nn.Linear(1536, 256)

    @property
    def train_bn(self) -> bool:
        """Whether the BatchNorms run on batch statistics (flax's
        ``SpeakerRAVE.train_bn``); always false with the cohort norm."""
        return getattr(self.bn5, "train_bn", False)

    @train_bn.setter
    def train_bn(self, on: bool) -> None:
        for bn in (self.attn_bn, self.bn5):
            if isinstance(bn, BatchNorm):
                bn.train_bn = on

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_layer(x)
        x1 = self.layer2(x)
        x2 = self.layer3(x1)
        x3 = self.layer4(x2)
        x2p = _max_pool_1d(x2, 2)
        # align the pooled x2 with x3 (both at T/32)
        t = min(x2p.shape[2], x3.shape[2])
        x2p, x3 = x2p[:, :, :t], x3[:, :, :t]
        x4 = self.cat_layer(x2p + x3)
        z = F.leaky_relu(self.out_layer(torch.cat([x2p, x3, x4], dim=1)), 0.2)

        # attentive statistics pooling over time
        mean = z.mean(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp(z.var(dim=2, keepdim=True, correction=0),
                                     1e-4, 1e4))
        glob = torch.cat([z, mean.expand_as(z), std.expand_as(z)], dim=1)
        w = self.attn2(self.attn_bn(F.relu(self.attn1(glob))))
        w = torch.softmax(w, dim=2)
        mu = torch.sum(z * w, dim=2)
        sg = torch.sqrt(torch.clamp(torch.sum(z * z * w, dim=2) - mu * mu,
                                    1e-4, 1e4))
        return self.fc6(self.bn5(torch.cat([mu, sg], dim=-1)))
