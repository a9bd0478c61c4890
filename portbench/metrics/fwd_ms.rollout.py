"""Rollout loop: device ms per forecast batch of the model's rollout (`dlwpbench.rollout.forward`), first traced stretch."""

from portbench.metrics import _spans

UNIT = "ms"


def read(run):
    if run["kind"] != "rollout":
        return None
    return _spans.per_unit_ms(run, ("dlwpbench.rollout.forward",), device=True)
