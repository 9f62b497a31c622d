"""Profiling: a section timer and ``torch.profiler`` traces.

The port's counterpart of ``rave_tpu/utils/profiler.py`` (the
reference's ``Profiler``, ``rave/model.py:32-47``, and Lightning's
``profiler="simple"``).  ``Sections`` times host regions, synchronising
the card at the end of each when ``sync`` holds, so that a section's
time includes the device work it queued; ``trace`` records a
``torch.profiler`` timeline.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


class Sections:
    def __init__(self, sync: bool = True):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync and torch.cuda.is_available()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.sync:
            torch.cuda.synchronize()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def __repr__(self) -> str:
        lines = ["=" * 60]
        for k in self.totals:
            n = self.counts[k]
            lines.append(f"{k}: total {self.totals[k]*1e3:.2f}ms "
                         f"avg {self.totals[k]/max(n,1)*1e3:.2f}ms x{n}")
        lines.append("=" * 60)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Host and device timeline of the block, written as a Chrome trace
    ``<logdir>/trace.json``: ``with trace('runs/x/profile'): step(...)``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
