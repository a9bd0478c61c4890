"""Rollout loop: host ms per forecast batch copying the forecast back once the card is done (`dlwpbench.rollout.d2h`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "rollout":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.rollout.d2h",))
