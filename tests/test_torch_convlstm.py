"""The port's ConvLSTM and ConvLSTMHPX against the JAX package on the CPU,
and the Navier-Stokes + ConvLSTM run through the train, build_baselines
and evaluate CLIs.

JAX parameters reach the port through `weights.load_flax_params`; inputs
come from numpy seeds.  Tolerances, fp32:
- rollouts and every parameter gradient: max|diff| <= 1e-4 x max|that
  tensor| (convolutions summed in other orders through up to 4 recurrent
  steps; measured <= 1e-6);
- remat on against off: 1e-6 of each tensor's max (the same ops
  recomputed);
- the bf16 trainer's step against JAX's: rtol 2e-3 of the loss, as
  `tests/test_torch_bf16.py` (bf16 keeps 8 significant bits; XLA and ATen
  round at other points);
- the CLI run: the files' targets are the raw solver vorticity within
  1e-5 of its max (normalised and back), and the RMSE of `metrics.json`
  is the lat-weighted RMSE on `LatLonGrid(n, n)` of the files' forecasts,
  rtol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu.models import convlstm as jconv
from dlwpbench_tpu.training import trainer as jtr
from dlwpbench_tpu_torch import build_baselines, evaluate, train, weights
from dlwpbench_tpu_torch.data import ns2d
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset
from dlwpbench_tpu_torch.evaluation import metrics as M
from dlwpbench_tpu_torch.grids.latlon import LatLonGrid
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models import convlstm as tconv
from dlwpbench_tpu_torch.training import trainer as ttr
from dlwpbench_tpu_torch.training.config import load_config
from dlwpbench_tpu_torch.utils import netcdf3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = 1e-4
LOSS_RTOL = 2e-3
# (mesh, context size, constants and prescribed channels): each value of
# each factor on each mesh
CASES = [("equirectangular", 1, True), ("equirectangular", 2, False),
         ("healpix", 2, True), ("healpix", 1, False)]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the solver's and the models' ops
    here are tiny, and the suite's workers share the cores (each extra
    thread only waits on the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close_per_tensor(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol * max(scale, 1e-6), (
            path, float(np.abs(g - w).max()), scale)


def _inputs(mesh, ctx, forcing, seed=0, B=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    spatial = (12, 4, 4) if mesh == "healpix" else (8, 16)
    T = ctx + 3
    const = f(B, 1, 2, *spatial) if forcing else None
    pres = f(B, T, 1, *spatial) if forcing else None
    return const, pres, f(B, T, 2, *spatial), f(B, T - ctx, 2, *spatial)


def _kw(mesh, ctx, forcing):
    return dict(constant_channels=2 if forcing else 0, prescribed_channels=1 if forcing else 0,
                prognostic_channels=2, hidden_sizes=(4, 6), context_size=ctx)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mesh, ctx, forcing", CASES)
def test_rollout_and_grads_match_jax(mesh, ctx, forcing):
    """Two cells (hidden 4, 6), batch 2, 3 closed-loop steps after the
    context; the port with and without per-step remat."""
    const, pres, prog, target = _inputs(mesh, ctx, forcing)
    jcls = jconv.ConvLSTMHPX if mesh == "healpix" else jconv.ConvLSTM
    jmodel = jcls(**_kw(mesh, ctx, forcing))
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), const, pres, prog)

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_grads = weights.flatten_tree(_np_tree(j_grads["params"]))

    results = []
    for remat in (True, False):
        tcls = tconv.ConvLSTMHPX if mesh == "healpix" else tconv.ConvLSTM
        tmodel = tcls(**_kw(mesh, ctx, forcing), remat=remat)
        assert tmodel.mesh == mesh
        weights.load_flax_params(tmodel, _np_tree(params))
        out = tmodel(*_t(const, pres, prog))
        assert out.shape == j_out.shape == target.shape
        loss = torch.mean((out - torch.from_numpy(target)) ** 2)
        loss.backward()
        grads = weights.flatten_tree(weights.to_flax_tree(
            tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))
        results.append((out.detach().numpy(), grads))
    (out, grads), (out_nr, grads_nr) = results
    _assert_close_per_tensor({"out": out}, {"out": j_out}, MODEL_TOL)
    _assert_close_per_tensor(grads, want_grads, MODEL_TOL)
    _assert_close_per_tensor({"out": out_nr, **grads_nr}, {"out": out, **grads}, 1e-6)


def test_closed_loop_ignores_ground_truth_past_the_context():
    """`tests/test_models_zoo.py::TestConvLSTMSemantics::test_reference_loop_parity`,
    mirrored: zeroing the ground truth from the context on changes no
    output (the closed loop feeds its own outputs)."""
    ctx = 2
    model = tconv.ConvLSTM(constant_channels=1, prescribed_channels=1, prognostic_channels=2,
                           hidden_sizes=(4,), context_size=ctx, seed=0)
    r = np.random.default_rng(0)
    const, pres, prog = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                         for s in ((1, 1, 1, 8, 16), (1, 5, 1, 8, 16), (1, 5, 2, 8, 16)))
    with torch.no_grad():
        got = model(const, pres, prog)
        prog2 = prog.clone()
        prog2[:, ctx:] = 0.0
        got2 = model(const, pres, prog2)
    torch.testing.assert_close(got[:, 1:], got2[:, 1:], rtol=0, atol=1e-6)


def test_ground_truth_within_the_context_matters():
    """`test_gt_change_within_context_matters`, mirrored."""
    model = tconv.ConvLSTM(constant_channels=0, prescribed_channels=0, prognostic_channels=1,
                           hidden_sizes=(4,), context_size=2, seed=0)
    prog = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 5, 1, 8, 16))
                            .astype(np.float32))
    with torch.no_grad():
        a = model(None, None, prog)
        prog2 = prog.clone()
        prog2[:, 0] += 1.0
        b = model(None, None, prog2)
    assert (a - b).abs().max().item() > 1e-6


@pytest.mark.parametrize("model_type, mesh", [("ConvLSTM", "equirectangular"),
                                              ("ConvLSTMHPX", "healpix")])
def test_shipped_config_loads_a_jax_init(model_type, mesh):
    """`configs/model/convlstm.yaml` (on NS data, and with `model.type=
    ConvLSTMHPX model.mesh=healpix` on `synthetic_hpx8`) builds on either
    side; the JAX init loads with every leaf landing.  The yaml's `mesh:
    equirectangular` overrides ConvLSTMHPX's default on either side."""
    data = "data=navier_stokes" if mesh == "equirectangular" else "data=synthetic_hpx8"
    cfg = load_config(os.path.join(REPO, "configs"), overrides=[
        "model=convlstm", data, f"model.type={model_type}", f"model.mesh={mesh}"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert type(tmodel).__name__ == model_type and tmodel.mesh == mesh
    assert tmodel.hidden_sizes == (16, 16)
    spatial = (12, 8, 8) if mesh == "healpix" else (64, 64)
    cc, cp, cq = (int(cfg.data[k]) for k in ("constant_channels", "prescribed_channels",
                                             "prognostic_channels"))
    rng = np.random.default_rng(0)
    const = rng.standard_normal((1, 1, cc, *spatial)).astype(np.float32) if cc else None
    pres = rng.standard_normal((1, 3, cp, *spatial)).astype(np.float32) if cp else None
    prog = rng.standard_normal((1, 3, cq, *spatial)).astype(np.float32)
    jparams = jax.jit(jbuild(dict(cfg.model)).init)(jax.random.PRNGKey(0), const, pres, prog)
    weights.load_flax_params(tmodel, _np_tree(jparams))
    with torch.no_grad():
        out = tmodel(*_t(const, pres, prog))
    assert out.shape == (1, 2, cq, *spatial) and torch.isfinite(out).all()
    cfg.model["mesh"] = "equirectangular"  # the yaml as shipped, on the HEALPix type too
    assert registry.build_model(cfg.model).mesh == "equirectangular"


def test_bf16_trainer_step_matches_jax():
    """One step of the bf16 trainer (bf16 compute over fp32 masters) from
    the same parameters and batch as JAX's bf16 trainer."""
    cfg = dict(type="ConvLSTM", **_kw("equirectangular", 1, True))
    rng = np.random.default_rng(0)
    T, H, W = 24, 8, 16
    ds = TDataset(prognostic=np.cumsum(0.3 * rng.standard_normal((T, 2, H, W)), axis=0)
                  .astype(np.float32),
                  prescribed=rng.standard_normal((T, 1, H, W)).astype(np.float32),
                  constants=rng.standard_normal((2, H, W)).astype(np.float32),
                  sequence_length=3, context_size=1)
    batch = next(ds.batches(4))
    tt = ttr.Trainer(registry.build_model(dict(cfg), seed=3), compute_dtype="bfloat16")
    tstate = tt.init()
    init = weights.to_flax_tree(tstate.model)
    jt = jtr.Trainer(jbuild(dict(cfg)), compute_dtype="bfloat16")
    params = jax.tree_util.tree_map(jnp.asarray, {"params": init})
    _, _, j_loss = jt._train_step(params, jt.tx.init(params),
                                  *(None if x is None else jnp.asarray(x) for x in batch),
                                  jnp.float32(1e-3), jax.random.PRNGKey(0))
    loss = tt.train_step(tstate, _t(*batch), 1e-3)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    for p in tstate.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


# ---------------------------------------------------------------- the NS run
NS = ["model=convlstm", "data=navier_stokes", "data.n=16", "data.n_trajectories=8",
      "data.record_steps=20", "data.inner_steps=5", "training.epochs=2",
      "validation.sequence_length=6", "verbose=false"]
SEQ = 6


def test_navier_stokes_run_through_the_clis(tmp_path, monkeypatch):
    """`train model=convlstm data=navier_stokes` at n 16 on the CPU, then
    `build_baselines -c` and `evaluate -c --device cpu` in one working
    directory: no latitude weights in training, the group statistic
    de-normalises the forecast files, the metrics on LatLonGrid(16, 16)'s
    latitudes, ACC against the baselines' climatology."""
    monkeypatch.chdir(tmp_path)
    run_dir = str(tmp_path / "runs" / "convlstm")
    built = []
    real = ttr.Trainer.__init__
    monkeypatch.setattr(ttr.Trainer, "__init__",
                        lambda self, *a, **k: built.append(k) or real(self, *a, **k))
    res = train.main([*NS, f"run_dir={run_dir}", "--device", "cpu"])
    assert built[0]["lat_weights"] is None
    assert len(res["train_loss"]) == 2 and np.isfinite(res["train_loss"] + res["val_loss"]).all()
    assert os.path.exists(os.path.join(run_dir, "checkpoints", "convlstm_best.ckpt"))

    base = build_baselines.main(["-c", run_dir, "--sequence-length", str(SEQ), "--device", "cpu"])
    got = evaluate.main(["-c", run_dir, "--sequence-length", str(SEQ), "--batch-size", "2",
                         "--device", "cpu"])["convlstm"]
    assert got["variables"] == ["var0"] and np.isfinite(got["acc"]["var0"]).all()
    assert len(base["persistence"]["rmse"]["var0"]) == len(got["rmse"]["var0"]) == SEQ - 1

    out_dir = os.path.join(run_dir, "evaluation")
    outputs, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    targets, _ = netcdf3.read_dataset(os.path.join(out_dir, "targets.nc"))
    o, t = outputs["var0"], targets["var0"]
    assert o.shape == t.shape == (len(o), SEQ - 1, 16, 16)
    # the targets in physical units: the solver's raw vorticity, test split
    traj = ns2d.generate_dataset(7, n=16, batch=8, record_steps=20, inner_steps=5, device="cpu")
    test_frames = traj[5 + 1 :].reshape(-1, 16, 16)  # 70 / 15 / 15 of 8 trajectories
    want = np.stack([test_frames[i * SEQ + 2 : i * SEQ + SEQ + 1] for i in range(len(t))])
    np.testing.assert_allclose(t, want, rtol=0, atol=1e-5 * np.abs(want).max())
    lats = LatLonGrid(16, 16).lats
    rmse = M.weighted_rmse(torch.from_numpy(o), torch.from_numpy(t), lats).numpy()
    np.testing.assert_allclose(got["rmse"]["var0"], rmse, rtol=1e-5)
    with open(os.path.join(out_dir, "metrics.json")) as f:
        assert json.load(f)["rmse"]["var0"] == got["rmse"]["var0"]
