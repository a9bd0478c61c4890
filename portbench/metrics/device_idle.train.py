"""Device: share of the traced stretch with no kernel, copy or memset on the card, in %."""

from portbench.metrics import _shared

UNIT = "%"


def read(run):
    if run["kind"] != "train":
        return None
    return _shared.idle_percent(run)
