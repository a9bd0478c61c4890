"""Rollout loop: window ms outside rollout_dataset's own per-batch timings, per batch (assembly, appends, concatenation)."""

UNIT = "ms"


def read(run):
    if run["kind"] != "rollout":
        return None
    return 1e3 * (run["window_s"] - sum(run["batch_s"])) / run["units"] if run["units"] else None
