"""Rollout loop: host ms per forecast batch copying its inputs to the card (`dlwpbench.rollout.h2d`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "rollout":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.rollout.h2d",))
