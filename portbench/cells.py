"""Finds a cell's files by name under the benchmark's folder:

- `workloads/<cell>.json`: {"config", "traffic", "chips", "limits"};
- `configs/<config>.json`: the configuration as it is run: the model,
  data and training sections, the reference `family`
  (`reference/<family>.py`), the `dtype` of its peak, `reference_rows`;
- `traffic/<traffic>.json`: the traffic mix, whose `kind` names the loop
  that drives it (`kinds/<kind>.py`);
- `metrics/<name>.py`: one reader per per-layer metric, `UNIT` and
  `read(run) -> float | None`.

A later cell, configuration, mix or metric is a new file here; no file
that exists needs an edit.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict


def _json(root: str, folder: str, name: str) -> dict:
    path = os.path.join(root, folder, f"{name}.json")
    if not os.path.isfile(path):
        raise SystemExit(f"portbench: no {folder[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    w = _json(root, "workloads", name)
    return Cell(name=name, config=_json(root, "configs", w["config"]),
                traffic=_json(root, "traffic", w["traffic"]), chips=int(w["chips"]),
                limits=dict(w["limits"]))


def metric_readers(root: str = ROOT) -> dict:
    """{metric name: reader module} of every file in `metrics/`."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[name] = module
    return out
