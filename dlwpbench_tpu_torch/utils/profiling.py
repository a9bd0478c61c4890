"""Tracing and profiling (counterpart of `dlwpbench_tpu/utils/profiling.py`).

- `trace(log_dir)`: a context manager around `torch.profiler.profile`,
  the host's ops and, where there is a card, its kernels, copies and
  memsets; it yields the profiler (`key_averages()` gives the breakdown)
  and, with `log_dir`, writes a TensorBoard-loadable trace there
  (`*.pt.trace.json`, `torch.profiler.tensorboard_trace_handler`);
- `annotate(name)`: a named range in that trace (`record_function`);
- `StepTimer`: steady-state step timing with the first `skip` steps
  (compiles, kernel builds, warm-up) excluded and percentile summaries;
  with `sync`, each step waits for the card before it is timed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, host: bool = True, device: bool = True):
    """Profile the block; yields the `torch.profiler.profile` object.
    `host` records the host's ops, `device` the card's activity (when CUDA
    is available); `log_dir` receives the trace file on exit."""
    activities = [ProfilerActivity.CPU] if host else []
    if device and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = None if log_dir is None else tensorboard_trace_handler(log_dir)
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def annotate(name: str):
    return record_function(name)


@dataclass
class StepTimer:
    """Collects per-step wall times; the first `skip` steps are excluded.
    With `sync`, each step's end waits for the card
    (`torch.cuda.synchronize`), so its time covers its kernels."""

    skip: int = 1
    sync: bool = False
    _times: list = field(default_factory=list)
    _seen: int = 0
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip:
            self._times.append(dt)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "median_s": float(np.median(t)),
            "p90_s": float(np.percentile(t, 90)),
            "total_s": float(t.sum()),
        }
