"""Reads the program's own spans and counters (not a metric: its name
starts with _).

The program records a span (`dlwpbench_tpu_torch.utils.profiling.span`)
only while a profiler runs, so its buffer holds the two stretches that
`kinds/common.traced` profiles after the window, and, in a process that
ran cells before, theirs too.  A stretch is `traced_units` unit spans
(a training step, or a forecast batch); the last 2 x `traced_units` unit
spans are this run's two stretches.  The readers read the first one,
which traces the card alone, so the host is not slowed by recording its
operators.  A span belongs to the stretch when it starts after the end
of the unit before the stretch and ends by the end of its last unit: the
input's spans come before the step they feed, a unit's own inside it.
A span that follows its units (`after=True`: the rollout's
concatenation) belongs when it starts from the stretch's first unit on
and before the next stretch's first unit.

Against a program without these spans or counters, every reader finds
nothing and returns None.
"""

from __future__ import annotations

UNIT_SPAN = {"train": "dlwpbench.train.step", "rollout": "dlwpbench.rollout.batch"}


def _profiling():
    try:
        from dlwpbench_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def _records() -> list:
    read = getattr(_profiling(), "spans", None)
    return read() if read is not None else []


def per_unit_ms(run, names: tuple, device: bool = False, after: bool = False) -> float | None:
    """ms of the spans named `names` in the first traced stretch, per unit:
    their time on the card with `device`, else on the host's clock."""
    n = int(run.get("traced_units") or 0)
    unit = UNIT_SPAN.get(run["kind"])
    if n == 0 or unit is None:
        return None
    records = _records()
    units = sorted((r for r in records if r.name == unit), key=lambda r: r.start_ns)
    if len(units) < 2 * n:
        return None
    before, stretch, following = units[:-2 * n], units[-2 * n:-n], units[-n]
    if after:
        lo, hi = stretch[0].start_ns, following.start_ns
        picked = [r for r in records if r.name in names and lo <= r.start_ns < hi]
    else:
        lo = before[-1].end_ns if before else -1
        hi = stretch[-1].end_ns
        picked = [r for r in records if r.name in names and lo < r.start_ns and r.end_ns <= hi]
    if not picked:
        return None
    return sum(r.device_ms if device else r.host_ms for r in picked) / n


def kernel_load_s() -> float | None:
    """Seconds this process spent building (nvcc) and loading the
    program's kernel libraries; None where it loaded none."""
    read = getattr(_profiling(), "counters", None)
    if read is None:
        return None
    counts = read()
    if "build.load" not in counts:
        return None
    return sum(counts[k][1] for k in ("build.nvcc", "build.load") if k in counts)
