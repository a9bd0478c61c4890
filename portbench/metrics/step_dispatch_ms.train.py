"""Trainer: mean host ms for Trainer.train_step to return (it does not synchronise)."""

from portbench.metrics import _shared

UNIT = "ms"


def read(run):
    if run["kind"] != "train":
        return None
    return _shared.mean_ms(run["spans"]["dispatch"])
