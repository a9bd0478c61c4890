"""The port's measurement and results entries beside the ladder, against
JAX's scripts (imported from `scripts/` as `tests/test_ladder.py` does),
on the CPU:

- `ladder_tables` on the repository's `results/ladder.json` (JAX's TPU
  ladder, read only), written into a temporary directory: the same
  sections and table rows as JAX's `scripts/ladder_tables.py` run into
  another one (the header aside: the port's names the recorded device,
  "not recorded" for JAX's entries, and no TPU figure);
- `benchmark_models --models unet,swin --steps 2 --iters 1`: JAX's
  parameter counts, and the matrix merged with what the file holds;
- `backfill_graph_flops` on a ladder holding one `graphcast@50k` entry:
  the gather form's count, which is the port's executed form;
- `ns_zoo_sweep` with its `run` recorded: each family's train command is
  JAX's overrides in JAX's order through the port's `-m` entry points,
  the evaluation under `outputs/`, the snapshots under `--root`;
- `paper_figures` on an evaluated run directory: the same figure files as
  JAX's `scripts/paper_figures.py`.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu_torch import backfill_graph_flops as TBG
from dlwpbench_tpu_torch import benchmark_ladder as TL
from dlwpbench_tpu_torch import benchmark_models as TBM
from dlwpbench_tpu_torch import ladder_tables as TLT
from dlwpbench_tpu_torch import ns_zoo_sweep as TNS
from dlwpbench_tpu_torch import paper_figures as TPF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(md_path):
    with open(md_path) as f:
        return [ln for ln in f.read().splitlines() if ln.startswith(("|", "## "))]


def test_ladder_tables_reproduce_jax_rows(tmp_path):
    import ladder_tables as JLT

    ladder = os.path.join(REPO, "results", "ladder.json")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    os.makedirs(jdir)
    JLT.main(["--ladder", ladder, "--out-md", str(jdir / "t.md"),
              "--out-png", str(jdir / "t.png")])
    lines = TLT.main(["--ladder", ladder, "--out-md", str(tdir / "t.md"),
                      "--out-png", str(tdir / "t.png")])
    want, got = _tables(jdir / "t.md"), _tables(tdir / "t.md")
    assert len(want) > 100 and got == want
    assert os.path.getsize(tdir / "t.png") > 0
    header = "\n".join(lines[:lines.index(next(ln for ln in lines if ln.startswith("## ")))])
    assert "Device: not recorded." in header
    assert "TPU" not in header and "TFLOP/s bf16 peak" not in header and "MFU" not in header
    for mine, theirs in ((TLT.REF_RUNTIME, JLT.REF_RUNTIME),
                         (TLT.REF_MEMORY_MB, JLT.REF_MEMORY_MB)):
        assert set(mine) == set(theirs)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k])
    assert TLT.LABEL == JLT.LABEL and TLT.RUNG_ORDER == JLT.RUNG_ORDER


def test_ladder_tables_name_the_recorded_card(tmp_path):
    """A port entry's device and power limit reach the header, and its
    `peak_mb` the memory column."""
    e = {"family": "unet", "rung": "50k", "grid": "32x64", "width": 10, "params": 46888,
         "batch": 1, "seq": 15, "step_s": 0.0123, "epoch_s_2014_protocol": 1.18,
         "compile_s": 2.0, "gridpoints_per_s": 1.0, "peak_mb": 123.4,
         "device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
    path = tmp_path / "ladder.json"
    path.write_text(json.dumps({"unet@50k@32x64": e}))
    lines = TLT.main(["--ladder", str(path), "--out-md", str(tmp_path / "t.md"),
                      "--out-png", str(tmp_path / "t.png")])
    assert "Device: NVIDIA H100 80GB HBM3, power limit 700.00 W." in lines
    assert "| 50k | 0.05M | 12.3 | 1.18 | 20.54 | 17.4x | 123 | 350 |  |" in lines


def test_benchmark_models_counts_and_merges(tmp_path):
    from benchmark_models import model_zoo as jax_zoo

    kept = {"params": 1, "rollout_s": 1.0, "compile_s": 1.0, "gridpoints_per_s": 1.0}
    (tmp_path / "benchmark_matrix.json").write_text(json.dumps(
        {"batch": 1, "steps": 16, "grid": [32, 64], "results": {"convlstm": kept}}))
    res = TBM.main(["--models", "unet,swin", "--steps", "2", "--iters", "1", "--out-dir",
                    str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "benchmark_matrix.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(res))
    # merged: the rows of an earlier run stay beside the new ones
    assert set(saved["results"]) == {"convlstm", "unet", "swin"}
    assert saved["results"]["convlstm"] == kept
    assert saved["batch"] == 1 and saved["steps"] == 2 and saved["grid"] == [32, 64]
    assert saved["device"] == "cpu"
    zoo = jax_zoo(1, 32, 64, 4, 1, 8)
    shapes = tuple(jax.ShapeDtypeStruct(s, jnp.float32)
                   for s in ((1, 1, 4, 32, 64), (1, 3, 1, 32, 64), (1, 3, 8, 32, 64)))
    for name in ("unet", "swin"):
        e = saved["results"][name]
        tree = jax.eval_shape(zoo[name].init, jax.random.PRNGKey(0), *shapes)
        assert e["params"] == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree)), name
        assert e["rollout_s"] > 0 and e["gridpoints_per_s"] == pytest.approx(
            2 * 32 * 64 / e["rollout_s"], rel=1e-3)
        assert "peak_mb" not in e and "error" not in e
    assert os.path.getsize(tmp_path / "runtime_over_params.png") > 0


def test_backfill_graph_flops_on_a_graphcast_entry(tmp_path):
    w, n = TL.solve_width("graphcast", TL.RUNGS["50k"], 32, 64, 4, 1, 8, None)
    entry = {"family": "graphcast", "rung": "50k", "grid": "32x64", "width": w, "params": n,
             "batch": 1, "seq": 3, "step_s": 0.02, "flops_per_step": 1.0e9}
    path = tmp_path / "ladder.json"
    path.write_text(json.dumps({"graphcast@50k@32x64": entry,
                                "unet@50k@32x64": {"family": "unet", "grid": "32x64",
                                                   "step_s": 0.01, "width": 10}}))
    out = TBG.main(["--ladder", str(path), "--training", str(tmp_path / "none.json"),
                    "--device", "cpu"])
    assert out["training"] is None
    with open(path) as f:
        saved = json.load(f)
    e = saved["graphcast@50k@32x64"]
    assert "algorithmic_flops_per_step" not in saved["unet@50k@32x64"]
    # the port's executed form is the gather form: the same count
    arrays = tuple(np.zeros(a.shape, np.float32)
                   for a in TL.synthetic_arrays(1, 3, (32, 64)))
    executed, _ = TL.step_flops(TL.prepare_step(TL.build("graphcast", w, 32, 64, 4, 1, 8),
                                                arrays, torch.device("cpu")))
    assert e["algorithmic_flops_per_step"] == executed > 0
    assert e["algorithmic_tflops"] == round(executed / 0.02 / 1e12, 3)
    assert e["step_s"] == 0.02 and e["flops_per_step"] == 1.0e9  # the wall clock untouched


def test_ns_zoo_sweep_commands_are_jax_overrides(tmp_path, monkeypatch):
    import ns_zoo_sweep as JNS

    assert list(TNS.FAMILIES) == list(JNS.FAMILIES) and TNS.COMMON == JNS.COMMON
    calls = []
    monkeypatch.setattr(TNS, "run", lambda cmd, log_path=None: calls.append(cmd) or "ok\n")
    TNS.main(["--epochs", "3", "--root", str(tmp_path), "--device", "cpu"])
    assert len(calls) == 3 * len(JNS.FAMILIES)
    for i, fam in enumerate(JNS.FAMILIES):
        group, extra = JNS.FAMILIES[fam]
        jax_overrides = ([f"model={group}", f"model.name=ns_{fam}"]
                         + [o.format(epochs=3) for o in JNS.COMMON] + extra)
        train, base, ev = calls[3 * i: 3 * i + 3]
        assert train == [sys.executable, "-m", "dlwpbench_tpu_torch.train", *jax_overrides,
                         "--device", "cpu"]
        run_dir = os.path.join(REPO, "outputs", f"ns_{fam}")
        assert base == [sys.executable, "-m", "dlwpbench_tpu_torch.build_baselines", "-c",
                        run_dir, "--sequence-length", "8", "--device", "cpu"]
        assert ev == [sys.executable, "-m", "dlwpbench_tpu_torch.evaluate", "-c", run_dir,
                      "--sequence-length", "8", "--batch-size", "8", "--device", "cpu"]
        assert (tmp_path / f"ns_{fam}" / "train_tail.log").exists()
        assert (tmp_path / f"ns_{fam}" / "eval.log").exists()


def _evaluated_run(root, name, seed):
    """A run directory with `evaluation/` as `evaluate -c` writes it:
    metrics and the forecast files of 2 samples x 8 lead steps x 2
    variables on 16 x 32."""
    from dlwpbench_tpu_torch.evaluation import evaluate as E
    from dlwpbench_tpu_torch.grids.latlon import LatLonGrid

    r = np.random.default_rng(seed)
    grid = LatLonGrid(16, 32)
    targets = r.standard_normal((2, 8, 2, 16, 32)).astype(np.float32)
    outputs = (targets + 0.1 * r.standard_normal(targets.shape)).astype(np.float32)
    out_dir = os.path.join(root, name, "evaluation")
    E.compute_metrics(outputs, targets, grid.lats, ["z500", "t850"], out_dir)
    E.write_forecast_files(out_dir, targets[:, 0], outputs, targets, ["z500", "t850"],
                           grid.lats, grid.lons)
    return os.path.join(root, name)


def test_paper_figures_match_jax_files(tmp_path):
    import paper_figures as JPF

    runs = [_evaluated_run(tmp_path / "runs", n, s) for n, s in (("unet", 0), ("swin", 1))]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JPF.main(["-c", *runs, "--out-dir", str(jdir), "--platform", "cpu"])
    made = TPF.main(["-c", *runs, "--out-dir", str(tdir)])
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert len(made) == 2 + 7 * 2 and all(os.path.getsize(p) > 0 for p in made)
    # the zonal spectrum the figures draw, against JAX's
    from dlwpbench_tpu.training.losses import zonal_power_spectrum as jzps
    from dlwpbench_tpu_torch.grids.latlon import LatLonGrid

    field = np.random.default_rng(3).standard_normal((8, 16, 32)).astype(np.float32)
    lats = LatLonGrid(16, 32).lats
    np.testing.assert_allclose(TPF.zonal_power(field, lats), np.asarray(jzps(field, lats)),
                               rtol=1e-5, atol=1e-6)
