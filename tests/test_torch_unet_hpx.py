"""The port's HEALPix conv ops, `UNetHPX` and a HEALPix run through the
train, build_baselines and evaluate CLIs, against the JAX package's, on
the CPU.

Inputs come from numpy seeds and go to both sides; JAX parameters reach
the port through `weights.load_flax_params`.  Neither side reaches a
Pallas kernel.  Tolerances, fp32:
- `GeoConv`, `GeoConvTranspose`, `avg_pool_2x` on faces: atol 1e-5 (the
  pad and the pool are exact; a conv sums 9 x C products in another
  order);
- the `UNetHPX` rollout and every parameter gradient: max|diff| <= 1e-4 x
  max|that tensor| (three closed-loop steps through the convs of two
  levels);
- a HEALPix run's `build_baselines -c` against `scripts/build_baselines.py`
  on the same run directory: the remapped climatology forecast within
  1e-6 of its max|value| (the remap's 4-tap sums in other orders), RMSE
  and Frobenius curves rtol 1e-5 (fp32 reductions in other orders);
- its `evaluate -c`: the RMSE of `metrics.json` against JAX's
  `HEALPixRemap` and `compute_metrics` on the same de-normalised
  forecasts, rtol 1e-5 (the remap's 4-tap sums and the reductions in
  other orders), and `outputs.nc` within 1e-6 of its max|value|.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlwpbench_tpu.evaluation import evaluate as JE
from dlwpbench_tpu.grids.remap import HEALPixRemap as JRemap
from dlwpbench_tpu.models import unet as junet
from dlwpbench_tpu.ops import conv as jconv
from dlwpbench_tpu_torch import build_baselines, evaluate, train, weights
from dlwpbench_tpu_torch.data.sources import build_datasets
from dlwpbench_tpu_torch.evaluation import evaluate as E
from dlwpbench_tpu_torch.grids.latlon import LatLonGrid
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models import unet as tunet
from dlwpbench_tpu_torch.ops import conv as tconv
from dlwpbench_tpu_torch.training.config import load_config, load_saved_config
from dlwpbench_tpu_torch.utils import netcdf3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
MODEL_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close_per_tensor(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


# ---------------------------------------------------------------- ops on faces
@pytest.mark.parametrize("nside, k, dilation", [(4, 3, 1), (8, 3, 1), (4, 1, 1), (8, 3, 2)])
def test_geoconv_on_faces_matches_jax(nside, k, dilation):
    x = _randn(nside * k, 2, 12, nside, nside, 5)
    jm = jconv.GeoConv(6, k, mesh="healpix", dilation=dilation)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tconv.GeoConv(5, 6, k, mesh="healpix", dilation=dilation)
    weights.load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12, nside, nside, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


def test_transpose_and_pool_on_faces_match_jax():
    x = _randn(1, 2, 12, 4, 4, 5)
    jm = jconv.GeoConvTranspose(3, 2, 2, mesh="healpix")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tconv.GeoConvTranspose(5, 3, 2, 2, mesh="healpix")
    weights.load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)

    want = np.asarray(jconv.avg_pool_2x(jnp.asarray(x), mesh="healpix"))
    got = tconv.avg_pool_2x(torch.from_numpy(x), mesh="healpix").numpy()
    assert got.shape == want.shape == (2, 12, 2, 2, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)
    faces = torch.from_numpy(x)
    assert torch.equal(tconv.unfold_faces(tconv.fold_faces(faces)), faces)


# ---------------------------------------------------------------- UNetHPX
HPX = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
           hidden_channels=(4, 8), n_convolutions=2, activation="gelu_exact")


def test_unet_hpx_rollout_and_grads_match_jax():
    """nside 4, 3 closed-loop steps, batch 2: the faces pool to nside 2;
    the port with per-step remat (its values and gradients are those
    without, `tests/test_torch_unet.py`)."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    B, T, n = 2, 4, 4
    const, pres = f(B, 1, 2, 12, n, n), f(B, T, 1, 12, n, n)
    prog, target = f(B, T, 2, 12, n, n), f(B, T - 1, 2, 12, n, n)
    jmodel = junet.UNetHPX(**HPX)
    params = jmodel.init(jax.random.PRNGKey(0), const, pres, prog)

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, j_out), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    tmodel = tunet.UNetHPX(**HPX, remat=True)
    assert tmodel.mesh == "healpix"
    weights.load_flax_params(tmodel, _np_tree(params))
    out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    assert out.shape == j_out.shape == (B, T - 1, 2, 12, n, n)
    _assert_close_per_tensor({"out": out.detach().numpy()}, {"out": j_out}, MODEL_TOL)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = weights.flatten_tree(weights.to_flax_tree(
        tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))
    _assert_close_per_tensor(got, weights.flatten_tree(_np_tree(j_grads["params"])), MODEL_TOL)


def test_unet_hpx_builds_from_the_shipped_config():
    """`configs/model/unet_hpx.yaml` on `data=synthetic_hpx8` builds the
    same net on either side: the same flax parameter paths and shapes."""
    from dlwpbench_tpu.models import build_model as jbuild

    cfg = load_config(os.path.join(REPO, "configs"), overrides=["model=unet_hpx",
                                                                "data=synthetic_hpx8"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert isinstance(tmodel, tunet.UNetHPX) and tmodel.mesh == "healpix"
    assert tmodel.hidden_channels == (8, 16, 32, 64)
    const, pres, prog = _randn(0, 1, 1, 4, 12, 8, 8), _randn(1, 1, 2, 1, 12, 8, 8), _randn(
        2, 1, 2, 3, 12, 8, 8)
    jparams = jax.eval_shape(jbuild(dict(cfg.model)).init, jax.random.PRNGKey(0), const, pres,
                             prog)  # traced, not run: shapes only
    jshapes = {k: v.shape for k, v in weights.flatten_tree(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, a.dtype), jparams["params"])).items()}
    tshapes = {k: v.shape for k, v in weights.flatten_tree(weights.to_flax_tree(tmodel)).items()}
    assert tshapes == jshapes
    with torch.no_grad():
        out = tmodel(*map(torch.from_numpy, (const, pres, prog)))
    assert out.shape == (1, 1, 3, 12, 8, 8) and torch.isfinite(out).all()


# ---------------------------------------------------------------- a HEALPix run
SEQ = 4
RUN = ["model=unet_hpx", "model.hidden_channels=[4,8]", "data=synthetic_hpx8",
       "data.n_time=200", "training.epochs=1", "training.batch_size=8",
       "validation.batch_size=8", "validation.sequence_length=3", "verbose=false"]


@pytest.fixture(scope="module")
def hpx_run(tmp_path_factory):
    """A UNetHPX run the port's train CLI wrote on synthetic nside-8 data."""
    path = str(tmp_path_factory.mktemp("run_hpx") / "unet_hpx")
    res = train.main([*RUN, f"run_dir={path}", "--device", "cpu"])
    assert len(res["train_loss"]) == 1 and np.isfinite(res["val_loss"]).all()
    return path


def _metrics(cwd, name):
    with open(os.path.join(cwd, "outputs", name, "evaluation", "metrics.json")) as f:
        return json.load(f)


def test_build_baselines_remaps_healpix_as_jax(hpx_run, tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import build_baselines as jbuild  # scripts/build_baselines.py

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jbuild.main(["-c", hpx_run, "--sequence-length", str(SEQ)])
    monkeypatch.chdir(tmp_path / "torch")
    got = build_baselines.main(["-c", hpx_run, "--sequence-length", str(SEQ)])
    clim = [np.load(tmp_path / side / build_baselines.CLIMATOLOGY_NPZ)["outputs"]
            for side in ("torch", "jax")]
    np.testing.assert_allclose(*clim, rtol=0, atol=1e-6 * np.abs(clim[1]).max())
    assert clim[0].shape[1:] == (SEQ - 1, 3, 8, 8)  # on the data's 8 x 8 lat-lon grid
    for name in ("persistence", "climatology"):
        t, j = _metrics(tmp_path / "torch", name), _metrics(tmp_path / "jax", name)
        assert set(t) == set(j) and got[name]["rmse"] == t["rmse"]
        for key in ("rmse", "frobenius"):
            for v in t["variables"]:
                np.testing.assert_allclose(t[key][v], j[key][v], rtol=1e-5)


def test_evaluate_run_dir_remaps_healpix_as_jax(hpx_run, tmp_path, monkeypatch):
    """`evaluate -c` on the HEALPix run (ACC from the baselines'
    climatology): lat-lon files, and the RMSE JAX computes from the same
    forecasts through its remap and metrics."""
    monkeypatch.chdir(tmp_path)
    build_baselines.main(["-c", hpx_run, "--sequence-length", str(SEQ)])
    res = evaluate.main(["-c", hpx_run, "--sequence-length", str(SEQ), "--batch-size", "2",
                         "--device", "cpu"])["unet_hpx"]
    out_dir = os.path.join(hpx_run, "evaluation")
    data, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    names = res["variables"]
    assert data[names[0]].shape[1:] == (SEQ - 1, 8, 8)
    assert np.isfinite([res["acc"][v] for v in names]).all()

    cfg = load_saved_config(hpx_run)
    cfg.testing["sequence_length"] = SEQ
    model = registry.build_model(cfg.model, seed=0)
    model.load_state_dict(torch.load(os.path.join(hpx_run, "checkpoints", "unet_hpx_best.ckpt"),
                                     map_location="cpu", weights_only=True)["model"])
    _, _, test_ds, stats = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing, 1)
    test_ds.sequence_length = SEQ
    _, outputs, targets = E.rollout_dataset(model.eval(), test_ds, 2)
    assert outputs.shape[3:] == (12, 8, 8)
    rm = JRemap(8, 8, 8)
    outputs, targets = (np.asarray(rm.hpx2ll(E.denormalize(a, stats, names)))
                        for a in (outputs, targets))
    want = JE.compute_metrics(outputs, targets, LatLonGrid(8, 8).lats, names,
                              str(tmp_path / "jax"))
    for v in names:
        np.testing.assert_allclose(res["rmse"][v], want["rmse"][v], rtol=1e-5)
        want_v = outputs[:, :, names.index(v)]
        np.testing.assert_allclose(data[v], want_v, rtol=0, atol=1e-6 * np.abs(want_v).max())
