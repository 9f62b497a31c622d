"""Latent-space PCA statistics (the port's copy of
``rave_tpu/train/latent_stats.py``, plain numpy).

A PCA of the posterior means that the eval step returns gives
``latent_pca`` / ``latent_mean`` / ``fidelity``; an export crops the
latent to the dimensions that reach a cumulative-variance target.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def fit_latent_pca(zs: np.ndarray) -> dict:
    """``zs`` ``(N, latent)`` collected posterior means -> the PCA:
    components as rows in decreasing order of variance, the mean, and
    the cumulative share of variance (``fidelity``)."""
    mean = zs.mean(0)
    z = zs - mean
    cov = z.T @ z / max(len(z) - 1, 1)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    components = evecs[:, order].T
    var = np.clip(evals[order], 0, None)
    var = var / max(var.sum(), 1e-12)
    return dict(latent_pca=components.astype(np.float32),
                latent_mean=mean.astype(np.float32),
                fidelity=np.cumsum(var).astype(np.float32))


def save_latent_stats(run_dir: str, stats: dict) -> Path:
    p = Path(run_dir) / "latent_stats.npz"
    np.savez(p, **stats)
    return p


def load_latent_stats(run_dir: str) -> dict | None:
    p = Path(run_dir) / "latent_stats.npz"
    if not p.exists():
        return None
    with np.load(p) as z:
        return {k: z[k] for k in z.files}


def n_dims_for_fidelity(fidelity: np.ndarray, target: float = 0.95) -> int:
    """Smallest number of latent dimensions whose cumulative variance
    exceeds ``target``."""
    return int(np.argmax(fidelity > target)) + 1
