"""What every kind of traffic shares: the run's context and outcome, the
program's configuration object, the device's clocks and the traced
stretch."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from portbench import trace


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device


@dataclasses.dataclass
class Outcome:
    kind: str
    t_window_start: float  # perf_counter at the window's start
    window_s: float
    units: int  # optimizer steps or forecast batches completed in the window
    rows: int  # the work of the throughput: samples, or grid points forecast
    memory_peak_bytes: int
    failed: int
    numbers: dict  # the numbers compared with the reference
    record: dict  # what the per-layer readers read
    summary: Optional[trace.TraceSummary] = None
    phases: dict = dataclasses.field(default_factory=dict)  # seconds of the run's phases


def port_config(cfg: dict, sequence_length: int):
    """The program's configuration object for `cfg`'s model, data and
    training sections."""
    from dlwpbench_tpu_torch.training.config import Config

    def wrap(x):
        if isinstance(x, dict):
            return Config({k: wrap(v) for k, v in x.items()})
        return x

    return wrap({"model": dict(cfg["model"]), "data": dict(cfg["data"]),
                 "training": {**cfg["training"], "sequence_length": sequence_length},
                 "seed": 0})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mark(device: torch.device):
    """A point in the compute stream's time: a CUDA event on the card, the
    host clock elsewhere."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def intervals(marks: list, device: torch.device) -> list[float]:
    """Seconds between consecutive marks (read once the stream is synchronised)."""
    if device.type == "cuda":
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return [b - a for a, b in zip(marks, marks[1:])]


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free_cache(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def traced(step: Callable[[], Any], n: int, device: torch.device):
    """Run `step` n times with the card's activity traced, then n times
    more with the host's operators traced too (each stretch begun and
    ended by a synchronise); their summary, or None when no device event
    was traced."""
    from torch.profiler import ProfilerActivity, profile

    stretches = []
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        if device.type != "cuda":
            acts = [ProfilerActivity.CPU]
        sync(device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            sync(device)
            window_s = time.perf_counter() - t0
        stretches.append((trace.events_of(prof), window_s))
    (device_only, window_s), (with_host, _) = stretches
    return trace.summarize(device_only, window_s, with_host)
