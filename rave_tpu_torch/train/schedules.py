"""Training schedules as plain functions of the integer step.

Port of ``rave_tpu/train/schedules.py``.
"""

from __future__ import annotations

import math

from ..config import RAVEConfig


def warmed_up(step: int, cfg: RAVEConfig) -> bool:
    """Discriminators activate after phase 1."""
    return step >= cfg.phase_1_duration


def quantize_enabled(step: int, cfg: RAVEConfig) -> bool:
    """The RVQ gate: on once ``step >= warmup_quantize``; ``None`` (or
    the presets' -1) means on from step 0."""
    if cfg.warmup_quantize is None:
        return True
    return step >= cfg.warmup_quantize


def beta_factor(step: int, cfg: RAVEConfig) -> float:
    """Log-space beta warmup from ``beta_initial`` to ``beta_target``."""
    if step + 1 >= cfg.beta_warmup_len:
        return cfg.beta_target
    t = min(max((step + 1) / cfg.beta_warmup_len, 0.0), 1.0)
    return math.exp(math.log(cfg.beta_initial) * (1 - t)
                    + math.log(cfg.beta_target) * t)


def is_discriminator_step(step: int, cfg: RAVEConfig) -> bool:
    """D trains on every ``update_discriminator_every``-th step once
    warmed up; every other step trains G."""
    return warmed_up(step, cfg) and step % cfg.update_discriminator_every == 0
