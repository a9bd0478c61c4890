"""Reduces `torch.profiler` traces of two stretches of the run to what
the per-layer metrics and the result's `device` and `breakdown` read.
The first stretch records the card's activity alone, which costs the
host almost nothing; the second records the host's operators too, whose
recording slows the host, so only what that cannot distort is read from
it (kernel times, and where the host was when the card waited):

- `busy_s` (first stretch): the union of the intervals in which a
  kernel, a copy or a memset ran on the card;
- `attention_s` (second stretch): the device seconds of the kernels launched from inside
  one of the program's registered attention operators
  (`dlwpbench_torch::*`), found through each kernel's launch: its
  correlation id leads to the host's launch call, and the operators
  enclosing that call on its thread are its callers;
- `device_ops` (first stretch): device seconds by kernel name, largest
  first;
- `idle_gaps` (second stretch): idle device seconds by what the host was
  doing, largest first: each gap is charged to the benchmark's span and
  the operator that launched the kernel ending it.

`summarize` works on plain event tuples, so the tests can feed it events
of their own; `events_of` takes them from a stopped profiler.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Optional

ATTENTION_PREFIX = "dlwpbench_torch::"
SPAN_PREFIX = "portbench::"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    thread: int = 0
    correlation: int = 0


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    attention_s: float
    device_ops: list
    idle_gaps: list


def events_of(prof) -> list[Event]:
    """The events of a stopped `torch.profiler.profile`."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        start = int(e.start_ns())
        out.append(Event(e.name(), dev, start, start + int(e.duration_ns()),
                         int(e.start_thread_id()), int(e.correlation_id())))
    return out


def _launches(events: Iterable[Event]) -> dict[int, tuple[bool, str]]:
    """{correlation id: (launched inside an attention operator, label)} of
    every host event that carries a correlation id, from a sweep over each
    thread's nested host events."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if not e.on_device:
            by_thread[e.thread].append(e)
    out = {}
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.start_ns, -(e.end_ns - e.start_ns)))
        stack: list[Event] = []
        for e in evs:
            while stack and stack[-1].end_ns <= e.start_ns:
                stack.pop()
            if e.correlation:
                ops = [s for s in stack if not s.name.startswith(SPAN_PREFIX)]
                spans = [s.name[len(SPAN_PREFIX):] for s in stack
                         if s.name.startswith(SPAN_PREFIX)]
                label = f"{spans[-1] if spans else '-'} / {ops[-1].name if ops else e.name}"
                attn = any(s.name.startswith(ATTENTION_PREFIX) for s in stack)
                out[e.correlation] = (attn, label)
            stack.append(e)
    return out


def _top(totals: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _sweep(dev: list[Event], launches: dict):
    """(busy ns, attention ns, {kernel: s}, {gap label: s}) of device events
    sorted by start."""
    busy = attention = 0
    ops, gaps = collections.Counter(), collections.Counter()
    cur_lo = cur_hi = dev[0].start_ns
    for e in dev:
        ops[e.name] += (e.end_ns - e.start_ns) / 1e9
        attn, label = launches.get(e.correlation, (False, f"- / {e.name}"))
        if attn:
            attention += e.end_ns - e.start_ns
        if e.start_ns > cur_hi:  # an idle gap ends at this event
            busy += cur_hi - cur_lo
            gaps[label] += (e.start_ns - cur_hi) / 1e9
            cur_lo = e.start_ns
        cur_hi = max(cur_hi, e.end_ns)
    return busy + cur_hi - cur_lo, attention, ops, gaps


def _device(events: list[Event]) -> list[Event]:
    return sorted((e for e in events if e.on_device  # not the host spans' mirrors
                   and not e.name.startswith(SPAN_PREFIX)), key=lambda e: e.start_ns)


def summarize(device_only: list[Event], window_s: float,
              with_host: list[Event]) -> Optional[TraceSummary]:
    """The summary of a stretch traced on the device alone (`device_only`,
    `window_s` long by the host's clock) and of a stretch with the host's
    operators (`with_host`); None when either holds no device event."""
    dev, dev_host = _device(device_only), _device(with_host)
    if not dev or not dev_host:
        return None
    busy, _, ops, _ = _sweep(dev, {})
    _, attention, _, gaps = _sweep(dev_host, _launches(with_host))
    return TraceSummary(window_s=window_s, busy_s=busy / 1e9, attention_s=attention / 1e9,
                        device_ops=_top(ops), idle_gaps=_top(gaps))
