"""Residual vector quantization with EMA codebooks.

Port of ``rave_tpu/models/quantization.py``.  A codebook's state
(``embed``, ``embed_avg``, ``cluster_size``, ``inited``) lives in
registered buffers, so ``state_dict``, checkpoints and exported programs
carry it.  A train pass updates it in place, without gradient, in the JAX
package's order: k-means init while ``inited < 0.5``, the nearest-code
search, dead-code expiry, then the EMA with Laplace smoothing.  The EMA
overwrites ``embed`` after the expiry has written it, so the expired codes'
fresh draws never survive a pass, as in the JAX package (ROADMAP C).

Random rows (the k-means seeds and the expiry's fresh codes) come from a
``sampler(samples, num)``: by default ``num`` rows drawn with replacement
through an explicit ``torch.Generator``; a caller may pass its own rule.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

Sampler = Callable[[torch.Tensor, int], torch.Tensor]

# the JAX package's codebook settings, which no preset changes
KMEANS_ITERS = 50
DECAY = 0.99
EPSILON = 1e-5              # Laplace smoothing of the code counts
THRESHOLD_EMA_DEAD_CODE = 2.0


def sample_vectors(samples: torch.Tensor, num: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """``num`` rows of ``samples`` ``(N, D)`` drawn with replacement."""
    idx = torch.randint(0, samples.shape[0], (num,), generator=generator,
                        device=samples.device)
    return samples[idx]


def neg_distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``-(|x|^2 - 2 x.e^T + |e|^2)`` ``(N, K)``, the JAX package's
    expression term for term (its argmax is the nearest code)."""
    return -(torch.sum(x ** 2, -1, keepdim=True) - 2 * x @ embed.T
             + torch.sum(embed ** 2, -1)[None])


def one_hot(idx: torch.Tensor, num: int, dtype) -> torch.Tensor:
    """``F.one_hot`` without its range check, which reads the indices
    back to the host."""
    out = torch.zeros(*idx.shape, num, dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def kmeans(samples: torch.Tensor, num_clusters: int, iters: int,
           sampler: Sampler):
    """Fixed-iteration k-means: ``(means (K, D), bins (K,))``.  An empty
    cluster keeps its mean."""
    means = sampler(samples, num_clusters)
    for _ in range(iters):
        onehot = one_hot(neg_distances(samples, means).argmax(-1),
                         num_clusters, samples.dtype)
        bins = onehot.sum(0)
        new_means = (onehot.T @ samples) / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = one_hot(neg_distances(samples, means).argmax(-1), num_clusters,
                   samples.dtype).sum(0)
    return means, bins


class EuclideanCodebook(nn.Module):
    """EMA codebook of ``codebook_size`` codes of ``dim`` channels."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.codebook_size = K = codebook_size
        self.register_buffer("embed", torch.zeros(K, dim))
        self.register_buffer("embed_avg", torch.zeros(K, dim))
        self.register_buffer("cluster_size", torch.zeros(K))
        self.register_buffer("inited", torch.tensor(0.0))
        # host mirror of ``inited >= 0.5``, so that a train pass does not
        # read the device flag; None until first needed or after a load
        self._inited_host: Optional[bool] = None

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._inited_host = None

    def is_inited(self) -> bool:
        """Whether k-means init has run (one host read after a load)."""
        if self._inited_host is None:
            self._inited_host = bool(self.inited.item() >= 0.5)
        return self._inited_host

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embed[idx]

    @torch.no_grad()
    def _train_update(self, xf: torch.Tensor, idx: torch.Tensor,
                      sampler: Sampler) -> None:
        K = self.codebook_size
        onehot = one_hot(idx, K, torch.float32)
        counts = onehot.sum(0)
        embed_sum = onehot.T @ xf
        expired = self.cluster_size < THRESHOLD_EMA_DEAD_CODE
        fresh = sampler(xf, K)
        self.embed.copy_(torch.where(expired[:, None], fresh, self.embed))
        d = DECAY
        self.cluster_size.copy_(self.cluster_size * d + counts * (1 - d))
        self.embed_avg.copy_(self.embed_avg * d + embed_sum * (1 - d))
        n = self.cluster_size.sum()
        smoothed = (self.cluster_size + EPSILON) / (n + K * EPSILON) * n
        self.embed.copy_(self.embed_avg / smoothed[:, None])

    def forward(self, x: torch.Tensor, train: bool = False,
                sampler: Optional[Sampler] = None):
        """``x`` ``(N, dim)`` -> ``(quantized, indices)``; a train pass
        also updates the codebook (``sampler`` draws its random rows)."""
        xf = x.detach().to(torch.float32)
        if train:
            if sampler is None:
                raise ValueError("a train pass needs a sampler")
            if not self.is_inited():
                with torch.no_grad():
                    means, bins = kmeans(xf, self.codebook_size,
                                         KMEANS_ITERS, sampler)
                    self.embed.copy_(means)
                    self.embed_avg.copy_(means)
                    self.cluster_size.copy_(bins)
                    self.inited.fill_(1.0)
                self._inited_host = True
        with torch.no_grad():
            idx = neg_distances(xf, self.embed).argmax(-1)
        quantized = self.embed[idx].to(x.dtype)
        if train:
            self._train_update(xf, idx, sampler)
        return quantized, idx


class VectorQuantization(nn.Module):
    """One VQ stage: straight-through estimator and commitment loss."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.codebook = EuclideanCodebook(dim, codebook_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                sampler: Optional[Sampler] = None):
        """``x`` ``(B, D, T)`` -> ``(quantized, indices (B, T), loss)``."""
        B, D, T = x.shape
        flat = x.transpose(1, 2).reshape(-1, D)
        q, idx = self.codebook(flat, train, sampler)
        q = q.reshape(B, T, D).transpose(1, 2)
        idx = idx.reshape(B, T)
        loss = x.new_zeros(())
        if train:
            loss = torch.mean((q.detach() - x) ** 2)
            q = x + (q - x).detach()
        return q, idx, loss

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        B, D, T = x.shape
        _, idx = self.codebook(x.transpose(1, 2).reshape(-1, D))
        return idx.reshape(B, T)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        """Indices ``(B, T)`` -> codes ``(B, D, T)``."""
        return self.codebook.decode(idx).transpose(1, 2)


class ResidualVectorQuantization(nn.Module):
    """``num_quantizers`` VQ stages, each quantizing the residual of the
    stages before it (``vq0..``)."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantization(dim, codebook_size)
            for _ in range(num_quantizers))

    def forward(self, x: torch.Tensor, train: bool = False,
                sampler: Optional[Sampler] = None):
        """``x`` ``(B, D, T)`` -> ``(quantized, loss, indices (B, N, T))``."""
        quantized = torch.zeros_like(x)
        residual = x
        losses, indices = [], []
        for layer in self.layers:
            q, idx, loss = layer(residual, train, sampler)
            residual = residual - q
            quantized = quantized + q
            losses.append(loss)
            indices.append(idx)
        return quantized, torch.stack(losses).sum(), torch.stack(indices, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``(B, D, T)`` -> indices ``(B, N, T)`` int64."""
        residual, out = x, []
        for layer in self.layers:
            idx = layer.encode(residual)
            residual = residual - layer.decode(idx)
            out.append(idx)
        return torch.stack(out, 1)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices ``(B, N, T)`` -> the summed codes ``(B, D, T)``."""
        out = 0.0
        for i, layer in enumerate(self.layers):
            out = out + layer.decode(indices[:, i])
        return out
