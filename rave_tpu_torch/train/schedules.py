"""Training schedules as plain functions of the integer step.

Port of ``rave_tpu/train/schedules.py``, and of the KL schedules
``get_beta_kl``, ``get_beta_kl_cyclic`` and ``get_beta_kl_cyclic_annealed``
that the JAX package keeps in ``rave_tpu/ops/losses.py``.
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


def get_beta_kl(step: float, warmup: float, min_beta: float,
                max_beta: float) -> float:
    """The KL weight rising log-linearly from ``min_beta`` at step 0 to
    ``max_beta`` at ``warmup``, then ``max_beta``."""
    t = min(max(step / warmup, 0.0), 1.0)
    if step > warmup:
        return max_beta
    return math.exp(t * (math.log(max_beta) - math.log(min_beta))
                    + math.log(min_beta))


def get_beta_kl_cyclic(step: int, cycle_size: int, min_beta: float,
                       max_beta: float) -> float:
    """:func:`get_beta_kl` over each cycle of ``cycle_size`` steps, its
    warmup half a cycle."""
    return get_beta_kl(step % cycle_size, cycle_size // 2, min_beta,
                       max_beta)


def get_beta_kl_cyclic_annealed(step: int, cycle_size: int, warmup: int,
                                min_beta: float, max_beta: float) -> float:
    """:func:`get_beta_kl_cyclic` whose floor itself warms up by
    :func:`get_beta_kl` over ``warmup`` steps."""
    min_beta = get_beta_kl(step, warmup, min_beta, max_beta)
    return get_beta_kl_cyclic(step, cycle_size, min_beta, max_beta)
