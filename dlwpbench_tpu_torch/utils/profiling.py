"""Tracing and profiling (counterpart of `dlwpbench_tpu/utils/profiling.py`).

- `trace(log_dir)`: a context manager around `torch.profiler.profile`,
  the host's ops and, where there is a card, its kernels, copies and
  memsets; it yields the profiler (`key_averages()` gives the breakdown)
  and, with `log_dir`, writes a TensorBoard-loadable trace there
  (`*.pt.trace.json`, `torch.profiler.tensorboard_trace_handler`);
- `span(name, device=None)`: a named span of the program's own work.
  While no profiler runs it costs one read of the profiler's flag and
  does nothing else.  While one runs it enters a fast record function
  (scope FUNCTION, not a user annotation, so the profiler mirrors nothing
  of it onto the device's timeline: the trace's device events stay the
  kernels, copies and memsets alone), which puts the span in the host's
  trace around the operators it encloses, and it appends a record to a
  bounded buffer: name, the enclosing span on its thread, the thread,
  and host start and end in ns on the profiler's clock (the Unix clock,
  `time.time_ns()`, as the profiler's host events carry it).  With a
  CUDA `device`, the span is also timed on the card: a timing CUDA event
  on that device's current stream at its entry and at its exit, read
  once they have run; with a CPU `device` the host clock stands in;
- `add(name, value=1)`: an always-on counter (a count and a sum), for
  points that run once per process or once per batch, never per kernel;
- `spans()`, `counters()` and `reset()` read the records and counters
  back and clear them.  When the buffer is full the oldest record goes,
  counted as `spans.dropped`;
- `StepTimer`: steady-state step timing with the first `skip` steps
  (compiles, kernel builds, warm-up) excluded and percentile summaries;
  with `sync`, each step waits for the card before it is timed.

The program's span names start with `dlwpbench.`.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

SPAN_CAPACITY = 16384  # records kept; a traced train step leaves about ten


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


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span on the same thread
    thread: int  # the thread's native id
    start_ns: int  # host clock, Unix ns (the profiler's clock)
    end_ns: int
    device_ms: Optional[float]  # the span's time on the card; None for a host span

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_OFF = contextlib.nullcontext()  # what `span` gives while no profiler runs
_lock = threading.Lock()
_local = threading.local()  # each thread's stack of open span names
_records: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_counts: dict[str, int] = {}
_sums: dict[str, float] = {}


def span(name: str, device: Optional[torch.device] = None):
    """A context manager around the program's work named `name`.  Entered
    as `with span(...) as on:`, `on` is None while no profiler runs.
    `device`: the device the work runs on, whose current stream times the
    span too (a CPU device: the host clock)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


class _Span:
    __slots__ = ("_name", "_device", "_parent", "_record", "_events", "_stream", "_start")

    def __init__(self, name: str, device):
        self._name, self._device = name, device

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self._record = _RecordFunctionFast(self._name)
        self._record.__enter__()
        self._events = None
        self._start = time.time_ns()
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        end = time.time_ns()
        self._record.__exit__(*exc)
        _local.stack.pop()
        if self._events is not None:
            device = self._events  # read in `spans()`, once they have run
        elif self._device is not None:
            device = (end - self._start) / 1e6
        else:
            device = None
        record = [self._name, self._parent, threading.get_native_id(), self._start, end, device]
        with _lock:
            if len(_records) == _records.maxlen:
                _add("spans.dropped", 1)
            _records.append(record)
        return False


def spans() -> list[SpanRecord]:
    """The kept span records, oldest first; a device-timed span's events
    are waited for and read here."""
    with _lock:
        records = list(_records)
    out = []
    for rec in records:
        if isinstance(rec[5], tuple):
            start, end = rec[5]
            end.synchronize()
            rec[5] = start.elapsed_time(end)
        out.append(SpanRecord(*rec))
    return out


def _add(name: str, value) -> None:
    _counts[name] = _counts.get(name, 0) + 1
    _sums[name] = _sums.get(name, 0) + value


def add(name: str, value: float = 1) -> None:
    """Count one event named `name` and add `value` to its sum."""
    with _lock:
        _add(name, value)


def counters() -> dict[str, tuple[int, float]]:
    """{name: (count, sum)} of every counter."""
    with _lock:
        return {k: (_counts[k], _sums[k]) for k in _counts}


def reset() -> None:
    """Forget every span record and counter."""
    with _lock:
        _records.clear()
        _counts.clear()
        _sums.clear()


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
