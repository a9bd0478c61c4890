"""The port's DISTANA and DISTANAHPX against the JAX package on the CPU,
and a Navier-Stokes DISTANA run through the train and evaluate CLIs.

JAX parameters reach the port through `weights.load_flax_params`; inputs
come from numpy seeds.  Tolerances, fp32:
- the lateral exchange (`_neighbors_equirect`, `_neighbors_healpix`):
  bit for bit (rolls, zero rows and the HEALPix pad's gather);
- rollouts and every parameter gradient: max|diff| <= 1e-4 x max|that
  tensor| (Dense products summed in other orders through up to 4
  recurrent steps; measured <= 1e-6);
- remat on against off: 1e-6 of each tensor's max (the same ops
  recomputed);
- the bf16 trainer's step against JAX's: rtol 2e-3 of the loss, as
  `tests/test_torch_bf16.py` (bf16 keeps 8 significant bits; XLA and ATen
  round at other points).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu.models import distana as jdist
from dlwpbench_tpu.training import trainer as jtr
from dlwpbench_tpu_torch import evaluate, train, weights
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset
from dlwpbench_tpu_torch.models import distana as tdist
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training import trainer as ttr
from dlwpbench_tpu_torch.training.config import load_config

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


def _kw(ctx, forcing):
    return dict(constant_channels=2 if forcing else 0, prescribed_channels=1 if forcing else 0,
                prognostic_channels=2, hidden_size=4, layers=2, lateral_channels=2,
                context_size=ctx)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mesh", ["equirectangular", "healpix"])
def test_lateral_exchange_equals_jax(mesh):
    shape = (2, 12, 4, 4, 3) if mesh == "healpix" else (2, 8, 16, 3)
    field = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    jfn, tfn = ((jdist._neighbors_healpix, tdist._neighbors_healpix) if mesh == "healpix"
                else (jdist._neighbors_equirect, tdist._neighbors_equirect))
    want = np.asarray(jfn(jnp.asarray(field)))
    got = tfn(torch.from_numpy(field)).numpy()
    assert got.shape == want.shape == (*shape[:-1], 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh, ctx, forcing", CASES)
def test_rollout_and_grads_match_jax(mesh, ctx, forcing):
    """Two LSTM layers (hidden 4), 2 lateral channels, batch 2, 3
    closed-loop steps after the context; the port with and without
    per-step remat."""
    const, pres, prog, target = _inputs(mesh, ctx, forcing)
    jcls = jdist.DISTANAHPX if mesh == "healpix" else jdist.DISTANA
    jmodel = jcls(**_kw(ctx, forcing))
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), const, pres, prog)

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_grads = weights.flatten_tree(_np_tree(j_grads["params"]))

    results = []
    for remat in (True, False):
        tcls = tdist.DISTANAHPX if mesh == "healpix" else tdist.DISTANA
        tmodel = tcls(**_kw(ctx, forcing), remat=remat)
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


def test_lateral_information_propagates():
    """`tests/test_models_zoo.py::TestDISTANA::test_lateral_information_propagates`,
    mirrored: a point perturbation reaches its own cell in the first
    output and a neighbour by the second."""
    model = tdist.DISTANA(constant_channels=0, prescribed_channels=0, prognostic_channels=1,
                          hidden_size=4, layers=1, context_size=1, seed=0)
    prog = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 4, 1, 8, 16))
                            .astype(np.float32))
    with torch.no_grad():
        base = model(None, None, prog)
        pert = prog.clone()
        pert[0, 0, 0, 4, 8] += 1.0
        diff = (model(None, None, pert) - base).abs()
    assert diff[0, 0, 0, 4, 8] > 0
    assert diff[0, 1, 0, 4, 9] > 0 or diff[0, 1, 0, 3, 8] > 0


def test_closed_loop_ignores_ground_truth_past_the_context():
    """The ConvLSTM semantics test of `tests/test_models_zoo.py`, on
    DISTANA's own loop: zeroing the ground truth from the context on
    changes no output, and changing a context frame changes them."""
    ctx = 2
    model = tdist.DISTANA(constant_channels=1, prescribed_channels=1, prognostic_channels=2,
                          hidden_size=4, layers=2, context_size=ctx, seed=0)
    r = np.random.default_rng(0)
    const, pres, prog = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                         for s in ((1, 1, 1, 8, 16), (1, 5, 1, 8, 16), (1, 5, 2, 8, 16)))
    with torch.no_grad():
        got = model(const, pres, prog)
        prog2 = prog.clone()
        prog2[:, ctx:] = 0.0
        torch.testing.assert_close(got[:, 1:], model(const, pres, prog2)[:, 1:], rtol=0,
                                   atol=1e-6)
        prog3 = prog.clone()
        prog3[:, 0] += 1.0
        assert (got - model(const, pres, prog3)).abs().max().item() > 1e-6


@pytest.mark.parametrize("model_type, mesh", [("DISTANA", "equirectangular"),
                                              ("DISTANAHPX", "healpix")])
def test_shipped_config_loads_a_jax_init(model_type, mesh):
    """`configs/model/distana.yaml` (on NS data, and as DISTANAHPX on
    `synthetic_hpx8`) builds on either side; the JAX init loads with every
    leaf landing (`pk.Dense_0` .. `pk.Dense_5`)."""
    data = "data=navier_stokes" if mesh == "equirectangular" else "data=synthetic_hpx8"
    cfg = load_config(os.path.join(REPO, "configs"), overrides=[
        "model=distana", data, f"model.type={model_type}"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert type(tmodel).__name__ == model_type and tmodel.mesh == mesh
    assert (tmodel.hidden_size, tmodel.layers, tmodel.lateral_channels) == (16, 4, 1)
    spatial = (12, 8, 8) if mesh == "healpix" else (64, 64)
    cc, cp, cq = (int(cfg.data[k]) for k in ("constant_channels", "prescribed_channels",
                                             "prognostic_channels"))
    rng = np.random.default_rng(0)
    const = rng.standard_normal((1, 1, cc, *spatial)).astype(np.float32) if cc else None
    pres = rng.standard_normal((1, 3, cp, *spatial)).astype(np.float32) if cp else None
    prog = rng.standard_normal((1, 3, cq, *spatial)).astype(np.float32)
    jparams = jax.jit(jbuild(dict(cfg.model)).init)(jax.random.PRNGKey(0), const, pres, prog)
    assert sorted(jparams["params"]["pk"]) == [f"Dense_{i}" for i in range(6)]
    weights.load_flax_params(tmodel, _np_tree(jparams))
    with torch.no_grad():
        out = tmodel(*_t(const, pres, prog))
    assert out.shape == (1, 2, cq, *spatial) and torch.isfinite(out).all()


def test_bf16_trainer_step_matches_jax():
    """One step of the bf16 trainer (bf16 compute over fp32 masters) from
    the same parameters and batch as JAX's bf16 trainer."""
    cfg = dict(type="DISTANA", **_kw(1, True))
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


def test_navier_stokes_run_through_the_clis(tmp_path, monkeypatch):
    """`train model=distana data=navier_stokes` at n 16 on the CPU, then
    `evaluate -c --device cpu`: finite losses and RMSE, the forecast
    files on the 16 x 16 grid."""
    monkeypatch.chdir(tmp_path)
    run_dir = str(tmp_path / "runs" / "distana")
    res = train.main(["model=distana", "data=navier_stokes", "data.n=16",
                      "data.n_trajectories=8", "data.record_steps=20", "data.inner_steps=5",
                      "training.epochs=1", "validation.sequence_length=6", "verbose=false",
                      f"run_dir={run_dir}", "--device", "cpu"])
    assert len(res["train_loss"]) == 1 and np.isfinite(res["train_loss"] + res["val_loss"]).all()
    got = evaluate.main(["-c", run_dir, "--sequence-length", "6", "--batch-size", "4",
                         "--device", "cpu"])["distana"]
    assert np.isfinite(got["rmse"]["var0"]).all() and len(got["rmse"]["var0"]) == 5
    assert os.path.exists(os.path.join(run_dir, "evaluation", "outputs.nc"))
