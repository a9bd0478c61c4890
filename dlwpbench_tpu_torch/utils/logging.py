"""Lightweight experiment logging (the reference's W&B plane, offline).

The port's copy of `dlwpbench_tpu/utils/logging.py`: JSONL scalar streams
under the run dir, with the call shape of wandb
(`log({...}, step=...)`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class RunLogger:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._f = open(self.path, "a")

    def log(self, metrics: Mapping[str, Any], step: int | None = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
