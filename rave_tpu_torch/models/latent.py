"""Latent heads: variational and discrete (port of ``VariationalHead``
and ``DiscreteHead`` in ``rave_tpu/models/latent.py``).  Channels-first:
``z`` is ``(B, n_out * latent, T)``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .quantization import ResidualVectorQuantization, Sampler


class VariationalHead(nn.Module):
    """Reparametrised Gaussian with closed-form KL.

    Sampling is explicit: pass the noise ``eps`` (shaped like the mean)
    or a ``torch.Generator`` to draw it from.
    """

    def forward(self, z: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mean, scale = self.mean_scale(z)
        std = F.softplus(scale) + 1e-4
        var = std * std
        logvar = torch.log(var)
        if eps is None:
            if generator is None:
                raise ValueError("VariationalHead needs eps or a generator")
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device, dtype=mean.dtype)
        zs = mean + eps * std
        kl = torch.mean(torch.sum(mean * mean + var - logvar - 1, dim=1))
        return zs, kl

    @staticmethod
    def mean_scale(z: torch.Tensor):
        return z.chunk(2, dim=1)

    @staticmethod
    def num_out() -> int:
        return 2


class DiscreteHead(nn.Module):
    """Residual VQ head.  ``enabled`` (the quantize gate of
    :func:`~rave_tpu_torch.train.schedules.quantize_enabled`) mixes
    ``gate * zq + (1 - gate) * z`` and gates the commitment loss; the RVQ
    runs first in any case, so a train pass updates the codebooks even
    with the gate off, as in the JAX package.  Noise augmentation is the
    noise heads' (ROADMAP A6)."""

    def __init__(self, num_quantizers: int, latent_size: int,
                 codebook_size: int = 1024):
        super().__init__()
        self.rvq = ResidualVectorQuantization(num_quantizers, latent_size,
                                              codebook_size)

    def forward(self, z: torch.Tensor, train: bool = False, enabled=True,
                sampler: Optional[Sampler] = None):
        """``z`` ``(B, latent, T)`` -> ``(z, commitment loss)``."""
        zq, diff, _ = self.rvq(z, train, sampler)
        gate = torch.as_tensor(enabled, dtype=z.dtype, device=z.device)
        return gate * zq + (1 - gate) * z, gate * diff

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        return self.rvq.encode(z)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return self.rvq.decode(idx)

    @staticmethod
    def num_out() -> int:
        return 1
