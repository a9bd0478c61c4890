"""Rollout loop: host ms per forecast batch in `rollout_dataset`'s final concatenations (`dlwpbench.rollout.concat`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "rollout":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.rollout.concat",), after=True)
