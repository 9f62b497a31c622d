"""The compute dtype of the neural trunk, and Python scalars as JAX
reads them beside a low-precision tensor.

``compute_dtype=bfloat16`` runs the encoder and the decoder in bf16 (the
JAX package's ``RAVE.encode_input`` / ``decode_bands`` casts); PQMF, the
latent heads, the speaker encoder and the losses stay float32.  JAX's
weak typing turns a Python scalar beside a bf16 array into a bf16
constant (``0.2 * x`` multiplies by 0.2001953125), while PyTorch keeps
the scalar in float32 and rounds only the product; :func:`weak` rounds
the scalar first, so that each op rounds where JAX's does.  XLA lowers a
bf16 logistic as ``1 / (1 + exp(-x))`` with every step rounded to bf16;
:func:`sigmoid` does the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype``."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r} (float32 or "
                         "bfloat16)")
    return COMPUTE_DTYPES[name]


def weak(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype where that is narrower than
    float32 (JAX's weak-typed scalar), else unchanged."""
    if like.dtype in (torch.float32, torch.float64):
        return value
    return torch.tensor(value, dtype=like.dtype).item()


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """Leaky ReLU; in bf16 with the slope rounded to bf16, as
    ``jnp.where(x >= 0, x, slope * x)`` computes it."""
    if x.dtype in (torch.float32, torch.float64):
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * weak(slope, x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function; in bf16 as ``1 / (1 + exp(-x))``, each
    step rounded to bf16 (XLA's expansion of a bf16 logistic)."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))
