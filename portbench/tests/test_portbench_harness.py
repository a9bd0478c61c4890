"""The harness is driven by files: a new configuration, cell, traffic mix
and per-layer metric are found by name and run with no edit to any file
that exists; and BENCHMARK.json agrees with the files."""

import json
import os
import shutil

import pytest
import torch

from portbench import cells, run
from portbench.tests._tiny import shrink

PKG = cells.ROOT
CHECKOUT = os.path.dirname(PKG)

NEW_METRIC = '''"""A metric a later change adds: steps completed in the window."""

UNIT = "steps"


def read(run):
    return run["units"] if run["kind"] == "train" else None
'''


def _copy_folders(tmp_path):
    root = tmp_path / "bench"
    for folder in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(os.path.join(PKG, folder), root / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_a_new_cell_configuration_mix_and_metric_run_as_files_alone(tmp_path):
    root = _copy_folders(tmp_path)
    before = {p: os.path.getmtime(os.path.join(dp, p)) for dp, _, fs in os.walk(root) for p in fs}
    config = shrink(cells.load_cell("swin.train.b32")).config
    config["name"] = "swin-tiny"
    (root / "configs" / "swin-tiny.json").write_text(json.dumps(config))
    traffic = json.loads((root / "traffic" / "train.b32.json").read_text())
    traffic.update(batch_size=4, batches_per_epoch=2, warmup_steps=3, trace_steps=2)
    (root / "traffic" / "train.b4.json").write_text(json.dumps(traffic))
    (root / "workloads" / "swin-tiny.train.b4.json").write_text(json.dumps(
        {"config": "swin-tiny", "traffic": "train.b4", "chips": 1,
         "limits": {"loss": 1e-4, "grad": 1e-3, "change": 1e-2}}))
    (root / "metrics" / "steps_done.train.py").write_text(NEW_METRIC)

    cell = cells.load_cell("swin-tiny.train.b4", root=str(root))
    assert cell.traffic["batch_size"] == 4
    res = run.run_cell(cell, 2**31 + 11, 0.5, True, torch.device("cpu"), root=str(root))
    assert res["correct"] and res["metrics"]["steps_done.train"]["value"] == res["attempted"]
    assert res["metrics"]["steps_done.train"]["unit"] == "steps"
    assert list(res)[-1] == "checks"
    after = {p: os.path.getmtime(os.path.join(dp, p)) for dp, _, fs in os.walk(root) for p in fs
             if p in before}
    assert after == before  # nothing that existed was touched


def test_an_unknown_cell_is_refused_by_name(tmp_path):
    with pytest.raises(SystemExit, match="no workload named"):
        cells.load_cell("nosuch.cell", root=str(tmp_path))


def _benchmark():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_agrees_with_the_files():
    bench = _benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        with open(os.path.join(CHECKOUT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert w["config"] in names and cell.config["name"] == w["config"]
        assert cell.chips == w["chips"]
        assert os.path.isfile(os.path.join(PKG, "traffic", f"{w['traffic']}.json"))
    readers = cells.metric_readers()
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"], m["name"]
    traffic_metrics = {}
    for w in bench["workloads"]:
        tp = cells.load_cell(w["name"]).traffic["throughput"]
        traffic_metrics[tp["name"]] = tp["unit"]
    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    assert e2e == {**traffic_metrics, "peak_mem": "GiB", "setup_s": "s"}
