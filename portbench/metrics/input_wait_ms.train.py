"""Host input pipeline: mean ms a window step waits in next() on the prefetch iterator."""

from portbench.metrics import _shared

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _shared.mean_ms(run["spans"]["input_wait"])
