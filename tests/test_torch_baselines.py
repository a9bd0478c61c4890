"""The port's baselines and run-directory evaluation against the JAX
package's, on the CPU, on a run the port's `train` CLI wrote from the
committed WeatherBench fixture (`tests/fixtures/wb_zarr`).

Tolerances:
- the baseline functions and the baseline forecasts (the climatology's
  `outputs.npz`): none, bit for bit (the same numpy on the same arrays);
- the baselines' RMSE and Frobenius curves: rtol 1e-5 (fp32 reductions,
  JAX's against torch's, sum in other orders); the zonal-mean RMSEs: rtol
  1e-4, as in `test_torch_evaluate.py` (each is a difference of zonal
  means of fields near 1e5, msl in Pa, so the fp32 rounding of the means
  grows by their ratio to the difference);
- `evaluate -c` against a rollout of the checkpoint's weights loaded by
  hand in this process: none, bit for bit (the same CPU kernels on the
  same weights and batches).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dlwpbench_tpu.evaluation import baselines as jbase
from dlwpbench_tpu_torch import build_baselines, evaluate, train
from dlwpbench_tpu_torch.data.sources import build_datasets
from dlwpbench_tpu_torch.evaluation import baselines as tbase
from dlwpbench_tpu_torch.evaluation import evaluate as E
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_saved_config
from dlwpbench_tpu_torch.utils import netcdf3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the suite's workers share the
    cores, and a test's extra threads only wait on the other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "wb_zarr")
SEQ = 5  # the fixture's 1980 test split holds 32 frames: 5 windows of 5
FIXTURE_OVERRIDES = [
    "data=weatherbench", f"data.data_path={FIXTURE}",
    "data.train_start_date=1979-01-01", "data.train_stop_date=1979-01-07",
    "data.val_start_date=1979-01-08", "data.val_stop_date=1979-01-10",
    "data.test_start_date=1980-01-01", "data.test_stop_date=1980-01-08",
    "data.timedelta=1", "data.height=8", "data.width=16",
    "data.prognostic_variable_names_and_levels={msl: [], stream250: [], z: [300, 500]}",
    "data.prognostic_channels=4",
    "training.batch_size=4", "training.sequence_length=4",
    "validation.sequence_length=4", "validation.batch_size=4", "verbose=false",
]
RUNS = {
    "unet": ["model=unet", "model.hidden_channels=[6]"],
    "swin": ["model=swintransformer", "model.embed_dim=8", "model.depths=[2,2]",
             "model.num_heads=[2,2]"],
}


def test_persistence_matches_jax():
    inits = np.random.default_rng(0).standard_normal((5, 3, 4, 8)).astype(np.float32)
    got = tbase.persistence_forecast(inits, 7)
    np.testing.assert_array_equal(got, jbase.persistence_forecast(inits, 7))
    assert got.shape == (5, 7, 3, 4, 8) and got.flags.writeable


@pytest.mark.parametrize("months", [np.arange(40) % 12 + 1, np.full(40, 3), np.arange(40) % 5 + 6])
def test_monthly_climatology_matches_jax(months):
    fields = np.random.default_rng(1).standard_normal((40, 2, 4, 8)).astype(np.float32)
    got = tbase.monthly_climatology(fields, months)
    np.testing.assert_array_equal(got, jbase.monthly_climatology(fields, months))
    valid = np.random.default_rng(2).integers(1, 13, (6, 4))
    np.testing.assert_array_equal(tbase.climatology_forecast(got, valid),
                                  jbase.climatology_forecast(got, valid))


@pytest.fixture(scope="module", params=sorted(RUNS))
def run_dir(request, tmp_path_factory):
    """A port run trained for 2 epochs on the fixture."""
    path = str(tmp_path_factory.mktemp(f"run_{request.param}") / request.param)
    res = train.main([*RUNS[request.param], *FIXTURE_OVERRIDES, "training.epochs=2",
                      f"run_dir={path}", "--device", "cpu"])
    assert len(res["train_loss"]) == 2 and np.isfinite(res["val_loss"]).all()
    return path


def _metrics(cwd, name):
    with open(os.path.join(cwd, "outputs", name, "evaluation", "metrics.json")) as f:
        return json.load(f)


def test_build_baselines_matches_jax(run_dir, tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import build_baselines as jbuild  # scripts/build_baselines.py

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jbuild.main(["-c", run_dir, "--sequence-length", str(SEQ)])
    monkeypatch.chdir(tmp_path / "torch")
    got = build_baselines.main(["-c", run_dir, "--sequence-length", str(SEQ)])

    clim = [np.load(tmp_path / side / build_baselines.CLIMATOLOGY_NPZ)["outputs"]
            for side in ("torch", "jax")]
    np.testing.assert_array_equal(*clim)
    assert clim[0].shape == (5, SEQ - 1, 4, 8, 16)
    for name in ("persistence", "climatology"):
        t, j = _metrics(tmp_path / "torch", name), _metrics(tmp_path / "jax", name)
        assert set(t) == set(j) and t["variables"] == j["variables"]
        assert got[name]["rmse"] == t["rmse"]
        for key in ("rmse", "frobenius"):
            for v in t["variables"]:
                np.testing.assert_allclose(t[key][v], j[key][v], rtol=1e-5)
        for key in ("zonal_rmse_global", "zonal_rmse_trade_winds",
                    "zonal_rmse_south_westerlies"):
            np.testing.assert_allclose([t[key][v] for v in t["variables"]],
                                       [j[key][v] for v in j["variables"]], rtol=1e-4)
        assert (tmp_path / "torch" / "outputs" / name / "evaluation" / "rmses.nc").exists()


def _rollout_by_hand(run_dir):
    """The best checkpoint's weights loaded into a fresh model, rolled out
    over the test split and de-normalised."""
    cfg = load_saved_config(run_dir)
    cfg.testing["sequence_length"] = SEQ
    model = registry.build_model(cfg.model, seed=0)
    payload = torch.load(os.path.join(run_dir, "checkpoints", f"{cfg.model.name}_best.ckpt"),
                         map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    _, _, test_ds, stats = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                          int(cfg.model.context_size))
    test_ds.sequence_length = SEQ
    _, outputs, _ = E.rollout_dataset(model.eval(), test_ds, 2)
    names = E.prognostic_channel_names(cfg.data, outputs.shape[2])
    return E.denormalize(outputs, stats, names), names


def test_evaluate_run_dir_restores_best_checkpoint(run_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    build_baselines.main(["-c", run_dir, "--sequence-length", str(SEQ)])
    proc = subprocess.run(
        [sys.executable, "-m", "dlwpbench_tpu_torch.evaluate", "-c", run_dir,
         "--sequence-length", str(SEQ), "--batch-size", "2", "--device", "cpu"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Restored" in proc.stdout and "steady-state grid-points/s" in proc.stdout
    out_dir = os.path.join(run_dir, "evaluation")
    for fname in ("inits.nc", "outputs.nc", "targets.nc", "rmses.nc", "accs.nc",
                  "rmses_climatology.nc", "metrics.json"):
        assert os.path.exists(os.path.join(out_dir, fname)), fname
    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics["acc"]) == set(metrics["variables"])
    assert np.isfinite([metrics["acc"][v] for v in metrics["variables"]]).all()

    want, names = _rollout_by_hand(run_dir)
    data, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    for i, name in enumerate(names):
        np.testing.assert_array_equal(data[name], want[:, :, i])


@pytest.mark.parametrize("extra", [["model=unet"], ["--weights", "w.npz"], ["--out-dir", "d"]])
def test_evaluate_run_dir_refuses_overrides(run_dir, extra, capsys):
    with pytest.raises(SystemExit):
        evaluate.main([*extra, "-c", run_dir, "--device", "cpu"])
    assert "-c takes its config and weights from each run directory" in capsys.readouterr().err


def test_build_baselines_remaps_face_fields_as_jax(run_dir, tmp_path, monkeypatch):
    """A run whose fields are HEALPix faces: the fixture's splits with
    their fields swapped for [T, 4, 12, 2, 2] faces.  The baselines are
    remapped to the data's 8 x 16 lat-lon grid before the metrics, and the
    metrics are those of `scripts/build_baselines.py` on the same splits
    (rtol 1e-5, as above)."""
    import dlwpbench_tpu.data.sources as jsources
    import dlwpbench_tpu_torch.build_baselines as mod

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import build_baselines as jbuild  # scripts/build_baselines.py

    def on_faces(real):
        def build(*a, **k):
            train_ds, val_ds, test_ds, stats = real(*a, **k)
            rng = np.random.default_rng(0)
            for ds in (train_ds, test_ds):
                ds.prognostic = rng.standard_normal(
                    (ds.prognostic.shape[0], 4, 12, 2, 2)).astype(np.float32)
                ds.prescribed = ds.constants = None
            return train_ds, val_ds, test_ds, stats
        return build

    monkeypatch.setattr(mod, "build_datasets", on_faces(mod.build_datasets))
    monkeypatch.setattr(jsources, "build_datasets", on_faces(jsources.build_datasets))
    for side in ("torch", "jax"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        (build_baselines.main if side == "torch" else jbuild.main)(
            ["-c", run_dir, "--sequence-length", str(SEQ)])
    clim = np.load(tmp_path / "torch" / build_baselines.CLIMATOLOGY_NPZ)["outputs"]
    assert clim.shape == (5, SEQ - 1, 4, 8, 16)
    for name in ("persistence", "climatology"):
        t, j = _metrics(tmp_path / "torch", name), _metrics(tmp_path / "jax", name)
        for v in t["variables"]:
            np.testing.assert_allclose(t["rmse"][v], j["rmse"][v], rtol=1e-5)
