"""Checkpoints of the full train state with ``torch.save``.

The port's counterpart of ``rave_tpu/train/checkpoint.py`` (orbax there):
the last ``keep`` checkpoints under ``<run>/checkpoints`` and, in its own
directory ``checkpoints/best``, the one with the lowest ``validation``
(``best_metric.json`` beside them), as the reference keeps ``best`` and
``last`` (``scripts/train.py:152-154``).  A checkpoint holds the
generator's and the discriminator's state dicts (BatchNorm statistics
included), every optimizer, the step, the latent generator's state and
the EMA; restoring one gives a state equal to the saved one bit for bit.
The loader's data order is not saved (nor is it in the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .loop import TrainState

_OPTIMIZERS = ("enc_opt", "dec_opt", "dis_opt", "spk_opt")


def state_dict(state: TrainState) -> dict:
    """Everything of ``state`` that training changes, on the CPU."""
    def cpu(tree):
        if torch.is_tensor(tree):
            return tree.detach().cpu().clone()
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    return cpu({
        "step": state.step,
        "model": state.model.state_dict(),
        "disc": state.disc.state_dict(),
        **{name: getattr(state, name).state_dict()
           for name in _OPTIMIZERS if getattr(state, name) is not None},
        "generator": state.generator.get_state(),
        "ema": state.ema,
    })


def load_state_dict(state: TrainState, sd: dict) -> None:
    """Restore ``state`` in place from :func:`state_dict`'s output."""
    state.step = int(sd["step"])
    state.model.load_state_dict(sd["model"])
    state.disc.load_state_dict(sd["disc"])
    for name in _OPTIMIZERS:
        opt = getattr(state, name)
        if (opt is None) != (name not in sd):
            raise ValueError(f"checkpoint and state disagree on {name}")
        if opt is not None:
            opt.load_state_dict(sd[name])
    state.generator.set_state(sd["generator"])
    if (state.ema is None) != (sd["ema"] is None):
        raise ValueError("checkpoint and state disagree on the EMA")
    if state.ema is not None:
        dev = next(iter(state.ema.values())).device
        state.ema = {k: v.to(dev) for k, v in sd["ema"].items()}


class CheckpointManager:
    """``save`` / ``restore`` of :class:`TrainState` under ``run_dir``."""

    def __init__(self, run_dir: str, keep: int = 3):
        self.dir = Path(run_dir).absolute() / "checkpoints"
        self.best_dir = self.dir / "best"
        self.best_dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._best = np.inf
        self._best_file = self.dir / "best_metric.json"
        if self._best_file.exists():
            self._best = json.loads(self._best_file.read_text())["best"]

    @staticmethod
    def _steps(d: Path) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in d.glob("ckpt_*.pt"))

    @staticmethod
    def _write(d: Path, step: int, sd: dict) -> None:
        # write then rename, so that a run killed mid-save leaves the
        # previous checkpoint as the latest
        tmp = d / f"ckpt_{step}.pt.tmp"
        torch.save(sd, tmp)
        tmp.replace(d / f"ckpt_{step}.pt")

    def save(self, state: TrainState, metrics: Optional[dict] = None) -> None:
        """Save ``state`` as the latest checkpoint (once per step); with a
        finite ``metrics["validation"]`` below the best so far, also as
        the best."""
        step, sd = int(state.step), None
        if self.latest_step() != step:
            sd = state_dict(state)
            self._write(self.dir, step, sd)
            for old in self._steps(self.dir)[:-self.keep]:
                (self.dir / f"ckpt_{old}.pt").unlink()
        if metrics and "validation" in metrics:
            v = float(metrics["validation"])
            if np.isfinite(v) and v < self._best:
                self._best = v
                for old in self._steps(self.best_dir):
                    (self.best_dir / f"ckpt_{old}.pt").unlink()
                self._write(self.best_dir, step, sd or state_dict(state))
                self._best_file.write_text(json.dumps(
                    {"best": v, "step": step}))

    def latest_step(self) -> Optional[int]:
        steps = self._steps(self.dir)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> None:
        """Load checkpoint ``step`` (the latest by default) into ``state``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        load_state_dict(state, torch.load(self.dir / f"ckpt_{step}.pt",
                                          map_location="cpu",
                                          weights_only=True))

    def restore_best(self, state: TrainState) -> None:
        """Load the checkpoint with the lowest validation so far, or the
        latest when none was validated."""
        steps = self._steps(self.best_dir)
        if not steps:
            print("WARNING: no best-validation checkpoint exists (was the "
                  "run trained without --val_every?); falling back to the "
                  "latest checkpoint")
            self.restore(state)
            return
        load_state_dict(state, torch.load(
            self.best_dir / f"ckpt_{steps[-1]}.pt", map_location="cpu",
            weights_only=True))


def save_config(run_dir: str, cfg) -> None:
    """Write the operative config to ``<run>/config.json`` (the reference
    writes ``config.gin``, ``scripts/train.py:224-225``)."""
    p = Path(run_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / "config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
