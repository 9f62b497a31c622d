"""Latent heads: variational, Wasserstein, spherical and discrete, and the
spherical angles (port of ``rave_tpu/models/latent.py``).  Channels-first:
``z`` is ``(B, n_out * latent, T)``.  Every random draw is an argument
(the noise-augmentation channels ``aug`` ``(B, noise_augmentation, T)``,
drawn by the model) or comes from a ``torch.Generator``."""

from __future__ import annotations

import math
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


def _append(z: torch.Tensor, aug: Optional[torch.Tensor]) -> torch.Tensor:
    return z if aug is None else torch.cat([z, aug], dim=1)


class WassersteinHead(nn.Module):
    """The latent as it is, regularised by the RBF-kernel MMD to a
    standard normal reference ``ref`` (shaped like ``z``; each frame's
    channel vector is one sample), with the noise-augmentation channels
    ``aug`` appended."""

    def __init__(self, noise_augmentation: int = 0):
        super().__init__()
        self.noise_augmentation = noise_augmentation

    @staticmethod
    def _mean_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d = ((x[:, None] - y[None]) ** 2).mean(dim=2) / x.shape[-1]
        return torch.exp(-d).mean()

    def forward(self, z: torch.Tensor, ref: Optional[torch.Tensor] = None,
                aug: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if ref is None:
            if generator is None:
                raise ValueError("WassersteinHead needs ref or a generator")
            ref = torch.randn(z.shape, generator=generator, device=z.device,
                              dtype=z.dtype)
        flat = z.transpose(1, 2).reshape(-1, z.shape[1])
        ref = ref.transpose(1, 2).reshape(-1, z.shape[1])
        mmd = (self._mean_kernel(flat, flat) + self._mean_kernel(ref, ref)
               - 2 * self._mean_kernel(flat, ref))
        return _append(z, aug), mmd

    @staticmethod
    def num_out() -> int:
        return 1


class SphericalHead(nn.Module):
    """Each frame divided by its L2 norm over the channels (+ 1e-12); the
    regulariser is 0."""

    def forward(self, z: torch.Tensor):
        norm = torch.linalg.vector_norm(z, dim=1, keepdim=True)
        return z / (norm + 1e-12), z.new_zeros(())

    @staticmethod
    def num_out() -> int:
        return 1


class DiscreteHead(nn.Module):
    """Residual VQ head.  ``enabled`` (the quantize gate of
    :func:`~rave_tpu_torch.train.schedules.quantize_enabled`) mixes
    ``gate * zq + (1 - gate) * z`` and gates the commitment loss; the RVQ
    runs first in any case, so a train pass updates the codebooks even
    with the gate off, as in the JAX package.  The noise-augmentation
    channels ``aug`` are appended after the gate."""

    def __init__(self, num_quantizers: int, latent_size: int,
                 codebook_size: int = 1024, noise_augmentation: int = 0):
        super().__init__()
        self.noise_augmentation = noise_augmentation
        self.rvq = ResidualVectorQuantization(num_quantizers, latent_size,
                                              codebook_size)

    def forward(self, z: torch.Tensor, train: bool = False, enabled=True,
                sampler: Optional[Sampler] = None,
                aug: Optional[torch.Tensor] = None):
        """``z`` ``(B, latent, T)`` -> ``(z, commitment loss)``."""
        zq, diff, _ = self.rvq(z, train, sampler)
        gate = torch.as_tensor(enabled, dtype=z.dtype, device=z.device)
        return _append(gate * zq + (1 - gate) * z, aug), gate * diff

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        return self.rvq.encode(z)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return self.rvq.decode(idx)

    @staticmethod
    def num_out() -> int:
        return 1


def unit_norm_vector_to_angles(x: torch.Tensor) -> torch.Tensor:
    """Unit vectors ``(..., C)`` (channels last) -> their ``C - 1``
    generalised spherical angles, each mapped to [-1, 1]: ``arccos`` of
    each coordinate over the norm of the coordinates from it on (+1e-12
    under the root), the last angle on the full circle by the sign of the
    last coordinate."""
    cums = torch.cumsum(torch.flip(x, dims=[-1]) ** 2, dim=-1)
    norms = torch.sqrt(torch.flip(cums, dims=[-1])[..., :-1] + 1e-12)
    angles = torch.arccos(torch.clamp(x[..., :-1] / norms, -1.0, 1.0))
    last = torch.where(x[..., -1:] >= 0, angles[..., -1:],
                       2 * math.pi - angles[..., -1:])
    angles = torch.cat([angles[..., :-1] / math.pi,
                        last / (2 * math.pi)], dim=-1)
    return 2 * (angles - 0.5)


def angles_to_unit_norm_vector(angles: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unit_norm_vector_to_angles`: ``(..., C - 1)``
    -> unit vectors ``(..., C)``."""
    a = torch.remainder(angles / 2 + 0.5, 1.0)
    a = torch.cat([a[..., :-1] * math.pi, a[..., -1:] * (2 * math.pi)],
                  dim=-1)
    ones = torch.ones_like(a[..., :1])
    cos = torch.cat([torch.cos(a), ones], dim=-1)
    sin = torch.cat([ones, torch.cumprod(torch.sin(a), dim=-1)], dim=-1)
    return cos * sin
