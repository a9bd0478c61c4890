"""The port's config, data and evaluation path against the JAX package's.

- the config loader composes `configs/` exactly as the JAX one does;
- the synthetic test split yields the same batches and init dates;
- `python -m dlwpbench_tpu_torch.evaluate` on JAX weights writes metrics
  whose lat-weighted RMSE per lead (and the other curves) match the JAX
  `rollout_dataset` + `compute_metrics` within 1e-4 relative (fp32 over
  a 16-step closed-loop rollout, where the summation order of two
  frameworks differs).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlwpbench_tpu.models  # noqa: F401  (fills the JAX registry)
from dlwpbench_tpu.data import dataset as jdataset
from dlwpbench_tpu.data import sources as jsources
from dlwpbench_tpu.evaluation import evaluate as JE
from dlwpbench_tpu.grids.latlon import LatLonGrid
from dlwpbench_tpu.models import registry as jregistry
from dlwpbench_tpu.training import config as jconfig
from dlwpbench_tpu_torch import resolve_device, weights
from dlwpbench_tpu_torch.data import dataset as tdataset
from dlwpbench_tpu_torch.data import sources as tsources
from dlwpbench_tpu_torch.training import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
SMALL = ["model=swintransformer", "data=synthetic", "data.height=8", "data.width=16",
         "model.embed_dim=16", "model.depths=[2,2]", "model.num_heads=[2,2]"]


@pytest.mark.parametrize(
    "overrides",
    [[], SMALL, ["model=unet", "training.batch_size=4", "data.n_time=${data.height}"],
     ["model=panguweather", "data=weatherbench"]],
)
def test_config_loader_matches_jax(overrides):
    got = tconfig.to_plain(tconfig.load_config(CONFIGS, overrides=overrides))
    want = jconfig.to_plain(jconfig.load_config(CONFIGS, overrides=overrides))
    assert got == want


def _split(mod, overrides):
    cfg = jconfig.load_config(CONFIGS, overrides=overrides)
    cfg.testing["sequence_length"] = 17
    return mod.build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing, 1)


def test_synthetic_test_split_matches_jax():
    _, _, jtest, jstats = _split(jsources, SMALL)
    _, _, ttest, tstats = _split(tsources, SMALL)
    assert ttest.init_indices == jtest.init_indices and len(ttest) == len(jtest) > 0
    t, j = tstats["prognostic"], jstats["prognostic"]
    assert (t.mean, t.std) == (j.mean, j.std)
    jb, tb = list(jtest.batches(2)), list(ttest.batches(2))
    assert len(jb) == len(tb)
    for jbatch, tbatch in zip(jb, tb):
        for j, t in zip(jbatch, tbatch):
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("start", ["2017-01-01T05:00", "2019-06-03T11:00", "2020-02-27T00:00"])
def test_biweekly_init_indices_matches_jax(start):
    times = np.datetime64(start) + np.arange(400) * np.timedelta64(6, "h")
    np.testing.assert_array_equal(
        tdataset.biweekly_init_indices(times, times[3], times[-5]),
        jdataset.biweekly_init_indices(times, times[3], times[-5]),
    )


def test_devices_never_fall_back():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_evaluate_cli_matches_jax(tmp_path):
    cfg = jconfig.load_config(CONFIGS, overrides=SMALL)
    cfg.testing["sequence_length"] = 17
    model = jregistry.build_model(cfg.model)
    _, _, test_ds, stats = jsources.build_datasets(
        cfg.data, cfg.training, cfg.validation, cfg.testing, 1
    )
    const, pres, prog, _ = next(iter(test_ds.batches(1)))
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(const), jnp.asarray(pres),
                        jnp.asarray(prog))
    weights.save_npz(tmp_path / "w.npz", jax.tree_util.tree_map(np.asarray, params))

    _, outputs, targets = JE.rollout_dataset(model, params, test_ds, batch_size=8)
    names = JE.prognostic_channel_names(cfg.data, outputs.shape[2])
    outputs = JE.denormalize(outputs, stats, names)
    targets = JE.denormalize(targets, stats, names)
    want = JE.compute_metrics(outputs, targets, LatLonGrid(8, 16).lats, names,
                              str(tmp_path / "jax"), timedelta_hours=6.0)

    out_dir = tmp_path / "torch"
    proc = subprocess.run(
        [sys.executable, "-m", "dlwpbench_tpu_torch.evaluate", *SMALL,
         "--weights", str(tmp_path / "w.npz"), "--device", "cpu", "--out-dir", str(out_dir)],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "steady-state grid-points/s" in proc.stdout
    with open(out_dir / "metrics.json") as f:
        got = json.load(f)
    assert set(got) == set(want)
    for key in ("rmse", "frobenius"):
        for name in names:
            assert len(got[key][name]) == 16
            np.testing.assert_allclose(got[key][name], want[key][name], rtol=1e-4)
    for key in ("zonal_rmse_global", "zonal_rmse_trade_winds", "zonal_rmse_south_westerlies"):
        np.testing.assert_allclose([got[key][n] for n in names],
                                   [want[key][n] for n in names], rtol=1e-4)
    for fname in ("inits.nc", "outputs.nc", "targets.nc", "rmses.nc"):
        assert (out_dir / fname).exists()


def test_acc_and_climatology_rmse_match_jax(tmp_path):
    """`compute_metrics` with a climatology: ACC and the climatology's RMSE
    per variable and lead against the JAX package's on the same random
    [2, 6, 5, 32, 64] fp32 fields (lat-weighted means over 4,096 points
    and 2 samples, in other orders: atol 1e-5 on values of order 1)."""
    from dlwpbench_tpu_torch.evaluation import evaluate as TE

    rng = np.random.default_rng(21)
    outputs, targets, clim = (rng.standard_normal((2, 6, 5, 32, 64)).astype(np.float32)
                              for _ in range(3))
    names = [f"var{i}" for i in range(5)]
    lats = LatLonGrid(32, 64).lats
    got = TE.compute_metrics(outputs, targets, lats, names, str(tmp_path / "torch"),
                             climatology=clim)
    want = JE.compute_metrics(outputs, targets, lats, names, str(tmp_path / "jax"),
                              climatology=clim)
    for key in ("acc", "rmse_climatology"):
        assert set(got[key]) == set(names)
        for name in names:
            assert len(got[key][name]) == 6
            np.testing.assert_allclose(got[key][name], want[key][name], rtol=0, atol=1e-5)
