"""The port's scaling entries on the CPU, against JAX's scripts (imported
from `scripts/` as `tests/test_aux.py` imports them):

- `scaling_model`'s algebra: every family's (comm bytes, K, alpha) at
  both grids, both payload widths and P in 1 .. 64 equal to JAX's
  exactly, `efficiency` and `compute_scale` within 1e-12;
- with both modules' chips and fused overhead set to the same values (and
  the port's bf16 factor to JAX's 0.85), the two entries on JAX's
  `results/ladder.json` and `results/benchmark_training.json` (read only)
  give the same rows, every `efficiency_by_chips` equal;
- with the defaults: the H100's link, no TPU figure, no fused row without
  the audit's measured overhead and no bf16-exchange row without the
  ladder's bf16 pair; the microbench's fit in place of the datasheet
  figure only where it was measured over NCCL, one rank a card;
- `benchmark_scaling --device cpu --devices 1,2` through
  `launch.spawn_local` on gloo: a row per rank count with JAX's keys, and
  with `--spatial 2` the 1 x 2 mesh (the U-Net on latitude rows; its
  values against JAX's in `tests/test_torch_parallel.py`).
"""

import json
import os
import sys

import pytest
import torch

from dlwpbench_tpu_torch import benchmark_scaling as TBS
from dlwpbench_tpu_torch import scaling_model as TSM
from dlwpbench_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
JAX_LADDER = os.path.join(REPO, "results", "ladder.json")
JAX_TRAINING = os.path.join(REPO, "results", "benchmark_training.json")
PS = (1, 2, 4, 8, 16, 32, 64)
GRIDS = {"5.625deg": (32, 64), "1.0deg": (180, 360)}
FAMILIES = ("unet", "sfno2d", "sfno2d_fused", "sfno2d_fused_2d", "graphcast", "swin_ring",
            "swin_ring_2d")
# every TPU figure JAX's script carries: its chips' link rates, v5p's FLOP
# ratio, the v5e's fused overhead and the bf16 factor
TPU_FIGURES = (200e9, 600e9, 459 / 197, 2.08 / 0.93, 0.85)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("width", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("family", FAMILIES)
def test_model_families_equal_jax(family, grid, width):
    import scaling_model as JSM

    H, W = GRIDS[grid]
    port, jax_ = TSM.model_families(H, W, width)[family], JSM.model_families(H, W, width)[family]
    for P in PS:
        assert port(P) == jax_(P), (family, grid, width, P)


@pytest.mark.parametrize("family", FAMILIES)
def test_efficiency_and_compute_scale_equal_jax(family):
    import scaling_model as JSM

    for H, W in GRIDS.values():
        assert TSM.compute_scale(family, H, W) == pytest.approx(
            JSM.compute_scale(family, H, W), rel=0, abs=1e-12)
        comm, K, alpha = TSM.model_families(H, W, 2)[family](8)
        for t_comp in (1e-4, 1e-2, 1.0):
            for comm_s in (0.0, comm / 450e9, comm / 200e9, 1.0):
                assert TSM.efficiency(t_comp, comm_s, K, alpha) == pytest.approx(
                    JSM.efficiency(t_comp, comm_s, K, alpha), rel=0, abs=1e-12)


def test_rows_equal_jax_under_the_same_constants(tmp_path, monkeypatch):
    import scaling_model as JSM

    monkeypatch.setattr(JSM, "CHIPS", {"v5e": {"ici_gbps": 200e9}})
    monkeypatch.setattr(TSM, "CHIPS", {"v5e": {"link_bytes_per_s": 200e9, "link_source": "x"}})
    monkeypatch.setattr(TSM, "fused_overhead", lambda mb: JSM.FUSED_SINGLE_CHIP_OVERHEAD)
    monkeypatch.setattr(TSM, "bf16_step_ratio", lambda ladder: 0.85)
    monkeypatch.chdir(REPO)  # JAX's script reads results/benchmark_training.json from here
    JSM.main(["--ladder", JAX_LADDER, "--out", str(tmp_path / "jax.json")])
    TSM.main(["--ladder", JAX_LADDER, "--training", JAX_TRAINING, "--microbench",
              str(tmp_path / "absent.json"), "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    keys = {k for k in want if not k.startswith("_")}
    assert keys == {k for k in got if not k.startswith("_")}
    assert len(keys) == 22
    for k in keys:
        assert got[k]["efficiency_by_chips"] == want[k]["efficiency_by_chips"], k
        for f in ("single_chip_step_s", "train_step_b32_s", "speedup_vs_best_single_chip",
                  "per_conv_single_chip_step_s", "mesh"):
            if f in want[k]:
                assert got[k][f] == want[k][f], (k, f)


def _port_ladder(tmp_path, bf16_pair=False):
    """A ladder as the port's entry writes it: each family's 8m row on the
    H100 (step times made up for the test), the SFNO's 32m pair if asked."""
    rows = {f"{k}@8m@32x64": {"step_s": s, "device": "NVIDIA H100 80GB HBM3",
                              "power_limit_w": 700.0}
            for k, s in (("unet", 0.02), ("sfno2d", 0.03), ("graphcast", 0.05), ("swin", 0.04))}
    if bf16_pair:
        rows["sfno2d@32m@32x64"] = {"step_s": 0.04}
        rows["sfno2d@32m@32x64@bf16"] = {"step_s": 0.03}
    path = tmp_path / "ladder.json"
    path.write_text(json.dumps(rows))
    return str(path)


def _all_numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _all_numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


def test_defaults_carry_no_tpu_figure(tmp_path):
    """No audit file and no bf16 pair: the H100's datasheet link on every
    row, no fused row, no bf16-exchange SFNO row, no v5e or v5p key and
    none of JAX's TPU figures anywhere in the output."""
    out = tmp_path / "model.json"
    res = TSM.main(["--ladder", _port_ladder(tmp_path), "--microbench", str(tmp_path / "no.json"),
                    "--training", str(tmp_path / "no.json"), "--out", str(out)])
    assert json.loads(out.read_text()) == res
    rows = {k: v for k, v in res.items() if not k.startswith("_")}
    assert set(rows) == {f"h100-sxm5:{g}:{f}" for g in GRIDS for f in (
        "unet", "sfno2d:fp32comm", "graphcast", "swin_ring", "swin_ring_2d")}
    assert all(v["link_bytes_per_s"] == 450e9 for v in rows.values())
    text = json.dumps(res)
    assert "v5e" not in text and "v5p" not in text and "TPU" not in text
    nums = list(_all_numbers(res))
    assert not any(n == pytest.approx(f, rel=1e-9) for n in nums for f in TPU_FIGURES)
    assert res["_inputs"] == {"fused_overhead_measured": None, "bf16_step_ratio": None}


@pytest.mark.parametrize("backend,ranks_per_card,devices,measured",
                         [("nccl", 1, 4, True), ("gloo", 2, 2, False), ("nccl", 1, 1, False)],
                         ids=["nccl-4-cards", "gloo-shared-card", "nccl-one-rank"])
def test_measured_inputs_replace_the_defaults(tmp_path, backend, ranks_per_card, devices,
                                              measured):
    """The audit's K8 / K1 brings the fused rows, the ladder's bf16 pair the
    bf16-exchange rows; the microbench's fitted bandwidth replaces the
    datasheet only over NCCL, one rank a card, several cards."""
    mb = tmp_path / "mb.json"
    mb.write_text(json.dumps({
        "devices": devices, "backend": backend, "ranks_per_card": ranks_per_card,
        "device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
        "timing": {"effective_bw_gbps": 123.5},
        "schedule_audit": {"fused_step_time_s": {"K1": 0.002, "K8": 0.005}}}))
    res = TSM.main(["--ladder", _port_ladder(tmp_path, bf16_pair=True), "--microbench", str(mb),
                    "--training", str(tmp_path / "no.json"), "--out", str(tmp_path / "m.json")])
    assert res["_inputs"] == {"fused_overhead_measured": 2.5, "bf16_step_ratio": 0.75}
    fused = res["h100-sxm5:5.625deg:sfno2d_fused:bf16comm"]
    assert fused["fused_overhead_measured"] == 2.5
    assert fused["single_chip_step_s"] == round(0.03 * 0.75 * 2.5, 4)
    assert "h100-sxm5:1.0deg:sfno2d:bf16comm" in res
    links = {v["link_bytes_per_s"] for k, v in res.items() if not k.startswith("_")}
    assert links == ({123.5e9} if measured else {450e9})


# ---------------------------------------------------------------------------
# benchmark_scaling on 1 and 2 gloo ranks
# ---------------------------------------------------------------------------


def test_benchmark_scaling_writes_a_row_per_rank_count(tmp_path, monkeypatch):
    import benchmark_scaling as JBS  # noqa: F401  (JAX's script: the row keys below are its)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = TBS.main(["--device", "cpu", "--devices", "1,2", "--per-device-batch", "1",
                    "--steps", "1"])
    saved = json.loads((tmp_path / "outputs" / "scaling.json").read_text())
    assert saved == res and set(saved) == {"1", "2"}
    for n, row in saved.items():
        assert {"mesh", "step_s", "gridpoints_per_s", "efficiency"} <= set(row), row
        assert row["mesh"] == f"{n}x1" and row["global_batch"] == int(n)
        assert row["step_s"] > 0 and row["gridpoints_per_s"] == pytest.approx(
            int(n) * 1 * 32 * 64 / row["step_s"])
        assert (row["backend"], row["ranks_per_card"], row["device"]) == ("gloo", None, "cpu")
        assert not any(row["attention_launches"].values()) and "error" not in row
    assert saved["1"]["efficiency"] == 1.0
    assert saved["2"]["efficiency"] == pytest.approx(
        saved["2"]["gridpoints_per_s"] / (2 * saved["1"]["gridpoints_per_s"]))


def test_benchmark_scaling_spatial_rows(tmp_path, monkeypatch):
    """`--spatial 2`: at 2 ranks the mesh is 1 x 2, both ranks on one
    sample's latitude rows (the batch split over the mesh's "data", 1
    group); at 1 rank the plain step."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = TBS.main(["--device", "cpu", "--devices", "1,2", "--spatial", "2",
                    "--per-device-batch", "1", "--steps", "1"])
    assert [(n, r["mesh"], r["global_batch"]) for n, r in res.items()] == [
        ("1", "1x1", 1), ("2", "1x2", 1)]
    assert all(r["step_s"] > 0 and "error" not in r for r in res.values())
    assert res["2"]["efficiency"] == pytest.approx(
        res["2"]["gridpoints_per_s"] / (2 * res["1"]["gridpoints_per_s"]))


@pytest.mark.parametrize("argv,error", [
    (["--device", "cpu", "--backend", "nccl"], ValueError),
    (["--device", "cuda"], SystemExit)], ids=["nccl-on-cpu", "cuda-without-card"])
def test_benchmark_scaling_refusals(argv, error, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "spawn_local", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(error):
        TBS.main([*argv, "--devices", "1,2"])
