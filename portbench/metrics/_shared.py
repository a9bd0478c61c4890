"""Helpers the per-layer readers share (not a metric: its name starts with _)."""

from __future__ import annotations

import statistics


def mean_ms(values) -> float | None:
    return 1e3 * statistics.fmean(values) if values else None


def p95_ms(values) -> float | None:
    if len(values) < 2:
        return None
    return 1e3 * statistics.quantiles(values, n=20, method="inclusive")[18]


def idle_percent(run) -> float | None:
    s = run["summary"]
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def attention_roofline(run) -> float | None:
    """100 x the least time of the traced stretch's attention work (each
    call's forward, and backward in training, once) over the device time
    of the kernels the attention operators launched."""
    from portbench import work

    s, peaks = run["summary"], run["peaks"]
    if s is None or peaks is None or s.attention_s <= 0 or not run["attention_calls"]:
        return None
    least = work.least_seconds(run["attention_calls"], peaks["flops_per_s"][run["dtype"]],
                               peaks["bytes_per_s"], run["backward"])
    return 100.0 * least * run["traced_units"] / s.attention_s


def mfu(run) -> float | None:
    """100 x the model FLOPs of the window's completed units (a training
    step counts three forwards) over the window's seconds at the card's
    peak."""
    peaks = run["peaks"]
    if peaks is None or run["units"] == 0:
        return None
    flops = run["forward_flops"] * (3 if run["backward"] else 1) * run["units"]
    return 100.0 * flops / run["window_s"] / peaks["flops_per_s"][run["dtype"]]
