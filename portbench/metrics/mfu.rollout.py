"""Device, whole step: the reference's model FLOPs completed in the window over the window's seconds at the card's peak, in %."""

from portbench.metrics import _shared

UNIT = "%"


def read(run):
    if run["kind"] != "rollout":
        return None
    return _shared.mfu(run)
