"""The port's FNO2D and TFNO2D (`dlwpbench_tpu_torch/models/fno.py`)
against the JAX package on the CPU, and a TFNO run through the train and
evaluate CLIs.

JAX parameters, each moved by seeded noise (so that no weight sits at its
init's special values), reach the port through `weights.load_flax_params`;
inputs come from numpy seeds.  Tolerances, fp32:
- rollouts and every parameter gradient: max|diff| <= 1e-4 x max|that
  tensor| (the DFTs, the per-mode mixing and the Dense layers summed in
  other orders through 2 closed-loop steps);
- remat on against off: 1e-6 of each tensor's max (the same ops
  recomputed);
- the shipped configs' parameter counts and tree: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_ref as jax_ref
from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu_torch import build_baselines, evaluate, train, weights
from dlwpbench_tpu_torch.models import fno as tfno
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = 1e-4
SMALL = dict(hidden_channels=8, lifting_channels=16, projection_channels=16, n_layers=2)
# (type, fft_impl, modes, grid, context, constants and prescribed channels):
# both branches of both weight forms, the bands overlapping (2 m1 > H:
# the fft branch whatever fft_impl says), an odd grid
CASES = [
    ("TFNO2DModule", "matmul", (3, 4), (8, 16), 1, True),
    ("TFNO2DModule", "fft", (3, 4), (8, 16), 2, False),
    ("FNO2DModule", "matmul", (3, 4), (8, 16), 2, True),
    ("FNO2DModule", "fft", (3, 4), (8, 16), 1, False),
    ("FNO2DModule", "matmul", (6, 4), (8, 16), 1, True),
    ("TFNO2DModule", "matmul", (3, 5), (7, 11), 1, True),
]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores (each extra thread only waits on the
    others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        params)


def assert_grads_close(got: dict, want: dict, tol: float = MODEL_TOL):
    """Per tensor within tol x its max; a tensor whose exact value is 0
    (max under 1e-6 of the largest) within tol x the largest."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        assert got[path].shape == w.shape, path
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            scale = top
        err = float(np.abs(got[path] - w).max())
        assert err <= tol * scale, (path, err, scale)


def _inputs(H, W, ctx, forcing, seed=0, B=2, steps=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    T = ctx + steps
    const = f(B, 1, 2, H, W) if forcing else None
    pres = f(B, T, 1, H, W) if forcing else None
    return const, pres, f(B, T, 2, H, W), f(B, steps, 2, H, W)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _kw(model_type, fft_impl, modes, ctx, forcing):
    return dict(type=model_type, constant_channels=2 if forcing else 0,
                prescribed_channels=1 if forcing else 0, prognostic_channels=2,
                context_size=ctx, n_modes=list(modes), fft_impl=fft_impl, **SMALL)


def _torch_grads(model):
    return weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))


def check_against_jax(cfg: dict, grid, inputs, seed=0):
    """The JAX model's rollout and gradients against the port's, with and
    without remat."""
    const, pres, prog, target = inputs
    jmodel = jbuild(dict(cfg))
    params = _perturbed(_np_tree(jax_ref.init(jmodel, jax.random.PRNGKey(seed), const, pres, prog)))

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = weights.flatten_tree(_np_tree(j_grads["params"]))
    results = []
    for remat in (True, False):
        tmodel = registry.build_model({**cfg, "remat": remat}, grid_shape=grid)
        weights.load_flax_params(tmodel, params)
        out = tmodel(*_t(const, pres, prog))
        assert out.shape == j_out.shape == target.shape
        torch.mean((out - torch.from_numpy(target)) ** 2).backward()
        results.append((out.detach().numpy(), _torch_grads(tmodel)))
    (out, grads), (out_nr, grads_nr) = results
    assert_grads_close({"out": out}, {"out": np.asarray(j_out)})
    assert_grads_close(grads, want)
    assert_grads_close({"out": out_nr, **grads_nr}, {"out": out, **grads}, 1e-6)


@pytest.mark.parametrize("model_type, fft_impl, modes, grid, ctx, forcing", CASES)
def test_rollout_and_grads_match_jax(model_type, fft_impl, modes, grid, ctx, forcing):
    check_against_jax(_kw(model_type, fft_impl, modes, ctx, forcing), grid,
                      _inputs(*grid, ctx, forcing))


@pytest.mark.parametrize("model_type, n_params", [("TFNO2DModule", 1_786_408),
                                                  ("FNO2DModule", 2_385_832)])
def test_shipped_config_builds_jax_tree(model_type, n_params):
    """`configs/model/fno.yaml` (and its FNO2DModule type) on the 32 x 64
    synthetic grid: the JAX parameter tree, path for path and shape for
    shape, and its parameter count."""
    cfg = load_config(os.path.join(REPO, "configs"), overrides=[
        "model=fno", "data=synthetic", f"model.type={model_type}"])
    tmodel = registry.build_model(cfg.model, seed=1,
                                  grid_shape=registry.data_grid_shape(cfg.data))
    assert isinstance(tmodel, tfno.TFNO2DModule) == (model_type == "TFNO2DModule")
    assert sum(p.numel() for p in tmodel.parameters()) == n_params
    d = cfg.data
    const = np.empty((1, 1, d.constant_channels, 32, 64), np.float32)
    pres = np.empty((1, 2, d.prescribed_channels, 32, 64), np.float32)
    prog = np.empty((1, 2, d.prognostic_channels, 32, 64), np.float32)
    jparams = jax.eval_shape(jbuild(dict(cfg.model)).init, jax.random.PRNGKey(0),
                             const, pres, prog)
    jshapes = {k: v.shape for k, v in weights.flatten_tree(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, a.dtype), jparams["params"])).items()}
    tshapes = {k: v.shape for k, v in weights.flatten_tree(weights.to_flax_tree(tmodel)).items()}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == n_params


@pytest.mark.parametrize("model_type", ["FNO2DModule", "TFNO2DModule"])
def test_weights_round_trip(model_type):
    """flax tree -> port -> flax tree is the identity (the spectral leaves
    `weights{1,2}` or `weights{1,2}_core` and `_factor{0..3}` as they are)."""
    const, pres, prog, _ = _inputs(8, 16, 1, True)
    cfg = _kw(model_type, "matmul", (3, 4), 1, True)
    params = _perturbed(_np_tree(jbuild(dict(cfg)).init(jax.random.PRNGKey(2), const, pres,
                                                        prog)))
    tmodel = registry.build_model(cfg, grid_shape=(8, 16))
    weights.load_flax_params(tmodel, params)
    back = weights.flatten_tree(weights.to_flax_tree(tmodel))
    want = weights.flatten_tree(params["params"])
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def test_seeded_init_follows_jax_distributions():
    """The port's own init draws JAX's distributions: U(0, 1/(Cin Cout))
    dense spectral weights, N(0, 1)/(Cin Cout) Tucker cores, N(0, 1)/sqrt(r)
    factors, lecun-normal Dense kernels with zero biases."""
    dense = tfno.FNO2DModule(hidden_channels=16, n_modes=(4, 4), grid_shape=(8, 16), seed=3)
    w = dense.FNOCore_0.SpectralConv2d_0.weights1
    assert 0.0 <= w.min().item() and w.max().item() <= 1 / 256
    assert abs(w.mean().item() - 0.5 / 256) < 0.05 / 256
    tucker = tfno.TFNO2DModule(hidden_channels=16, n_modes=(4, 4), grid_shape=(8, 16),
                               seed=3).FNOCore_0
    core, f0 = tucker.SpectralConv2d_0.weights1_core, tucker.SpectralConv2d_0.weights1_factor0
    assert abs(core.std().item() * 256 - 1.0) < 0.1
    assert abs(f0.std().item() * np.sqrt(f0.shape[1]) - 1.0) < 0.2
    assert tucker.Dense_2.bias.abs().max().item() == 0.0
    k = tucker.Dense_0.weight
    assert abs(k.std().item() * np.sqrt(k.shape[1]) - 1.0) < 0.2


def test_tfno_run_through_the_clis(tmp_path, monkeypatch):
    """`train model=fno` at the shipped modes (12 x 12) on an 8 x 16 grid,
    where JAX keeps 8 x 9 of them (the entry points pass the data's grid),
    then `build_baselines -c` and `evaluate -c --device cpu`: finite losses,
    RMSE and ACC, the forecast files on the grid."""
    monkeypatch.chdir(tmp_path)
    run_dir = str(tmp_path / "runs" / "tfno")
    res = train.main(["model=fno", "data=synthetic", "data.height=8", "data.width=16",
                      "data.n_time=120", "model.hidden_channels=8",
                      "model.lifting_channels=16", "model.projection_channels=16",
                      "model.n_layers=2", "training.epochs=1", "training.batch_size=8",
                      "validation.batch_size=4", "validation.sequence_length=4",
                      "verbose=false", f"run_dir={run_dir}", "--device", "cpu"])
    assert np.isfinite(res["train_loss"] + res["val_loss"]).all()
    conv = res["state"].model.FNOCore_0.SpectralConv2d_0
    assert (conv.m1, conv.m2) == (8, 9) and conv.weights1_factor2.shape[0] == 8
    build_baselines.main(["-c", run_dir, "--sequence-length", "4"])
    got = evaluate.main(["-c", run_dir, "--sequence-length", "4", "--batch-size", "4",
                         "--device", "cpu"])["tfno"]
    assert np.isfinite(got["rmse"]["var0"]).all() and np.isfinite(got["acc"]["var0"]).all()
    assert os.path.exists(os.path.join(run_dir, "evaluation", "outputs.nc"))


def test_unknown_fft_impl_raises():
    with pytest.raises(ValueError, match="fft_impl"):
        tfno.FNO2DModule(fft_impl="dft", grid_shape=(8, 16))
