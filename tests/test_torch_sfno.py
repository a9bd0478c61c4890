"""The port's SFNO (`dlwpbench_tpu_torch/models/sfno.py`) against the JAX
package on the CPU.

JAX parameters, each moved by seeded noise (the position embedding starts
at zero), reach the port through `weights.load_flax_params`; inputs come
from numpy seeds.  Tolerances, fp32:
- rollouts and every parameter gradient, on both `fft_impl` branches and
  both SHT grids: max|diff| <= 1e-4 x max|that tensor| (the SHTs, the
  per-degree mixing and the Dense layers summed in other orders through 2
  closed-loop steps);
- remat on against off: 1e-6 of each tensor's max (the same ops
  recomputed);
- the shipped config's parameter count (18,756,872) and tree: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_child import one_rank_mesh
from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.models import sfno as tsfno
from dlwpbench_tpu_torch.training.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = 1e-4
SMALL = dict(type="SFNO2DModule", embed_dim=8, num_layers=2, height=8, width=16)
# (fft_impl, SHT grid, context, constants and prescribed channels, options)
CASES = [
    ("matmul", "equiangular", 1, True, {}),
    ("fft", "equiangular", 2, False, {}),
    ("matmul", "legendre-gauss", 1, False, {}),
    ("fft", "legendre-gauss", 1, True, {}),
    ("matmul", "equiangular", 1, True, dict(use_mlp=False, big_skip=False, pos_embed=False)),
    ("matmul", "equiangular", 1, True, dict(scale_factor=2, hard_thresholding_fraction=0.5)),
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


def _inputs(ctx, forcing, seed=0, B=2, steps=2, H=8, W=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    T = ctx + steps
    const = f(B, 1, 2, H, W) if forcing else None
    pres = f(B, T, 1, H, W) if forcing else None
    return const, pres, f(B, T, 2, H, W), f(B, steps, 2, H, W)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _kw(fft_impl, grid, ctx, forcing, options):
    return dict(SMALL, constant_channels=2 if forcing else 0,
                prescribed_channels=1 if forcing else 0, prognostic_channels=2,
                context_size=ctx, fft_impl=fft_impl, grid=grid, **options)


def _torch_grads(model):
    return weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))


@pytest.mark.parametrize("fft_impl, grid, ctx, forcing, options", CASES)
def test_rollout_and_grads_match_jax(fft_impl, grid, ctx, forcing, options):
    """Two layers, embed 8, batch 2, 2 closed-loop steps; the port with and
    without per-step remat."""
    cfg = _kw(fft_impl, grid, ctx, forcing, options)
    const, pres, prog, target = _inputs(ctx, forcing)
    jmodel = jbuild(dict(cfg))
    params = _perturbed(_np_tree(jmodel.init(jax.random.PRNGKey(0), const, pres, prog)))

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (_, j_out), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    want = weights.flatten_tree(_np_tree(j_grads["params"]))
    results = []
    for remat in (True, False):
        tmodel = registry.build_model({**cfg, "remat": remat})
        weights.load_flax_params(tmodel, params)
        out = tmodel(*_t(const, pres, prog))
        assert out.shape == j_out.shape == target.shape
        torch.mean((out - torch.from_numpy(target)) ** 2).backward()
        results.append((out.detach().numpy(), _torch_grads(tmodel)))
    (out, grads), (out_nr, grads_nr) = results
    assert_grads_close({"out": out}, {"out": np.asarray(j_out)})
    assert_grads_close(grads, want)
    assert_grads_close({"out": out_nr, **grads_nr}, {"out": out, **grads}, 1e-6)


def test_shipped_config_builds_jax_tree():
    """`configs/model/sfno.yaml` on the 32 x 64 synthetic grid: the JAX
    parameter tree, path for path and shape for shape (lmax 32, the zero
    position embedding [1, 32, 64, 256]), 18,756,872 parameters."""
    cfg = load_config(os.path.join(REPO, "configs"), overrides=["model=sfno", "data=synthetic"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert isinstance(tmodel, tsfno.SFNO2DModule)
    assert sum(p.numel() for p in tmodel.parameters()) == 18_756_872
    assert tmodel.SphericalConv_0.weight.shape == (256, 256, 32, 2)
    assert tmodel.pos_embed.abs().max().item() == 0.0
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


@pytest.mark.parametrize("use_mlp", [True, False])
def test_weights_round_trip(use_mlp):
    """flax tree -> port -> flax tree is the identity (`pos_embed` and each
    `SphericalConv_i/weight` as they are; the Dense names in call order)."""
    cfg = _kw("matmul", "equiangular", 1, True, dict(use_mlp=use_mlp))
    const, pres, prog, _ = _inputs(1, True)
    params = _perturbed(_np_tree(jbuild(dict(cfg)).init(jax.random.PRNGKey(2), const, pres,
                                                        prog)))
    tmodel = registry.build_model(cfg)
    weights.load_flax_params(tmodel, params)
    back = weights.flatten_tree(weights.to_flax_tree(tmodel))
    want = weights.flatten_tree(params["params"])
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def test_branches_agree():
    """`fft_impl="matmul"` against `"fft"` on one set of weights (the
    counterpart of `tests/test_sht.py::test_sfno_matmul_path_matches_fft`)."""
    cfg = _kw("matmul", "equiangular", 1, True, {})
    a = registry.build_model(cfg, seed=4)
    b = registry.build_model({**cfg, "fft_impl": "fft"}, seed=5)
    b.load_state_dict(a.state_dict())
    const, pres, prog, _ = _t(*_inputs(1, True))
    ya, yb = a(const, pres, prog), b(const, pres, prog)
    torch.testing.assert_close(yb, ya, rtol=1e-5, atol=2e-5)
    (ya ** 2).mean().backward()
    (yb ** 2).mean().backward()
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        scale = max(1e-3, pa.grad.abs().max().item())
        assert (pa.grad - pb.grad).abs().max().item() / scale < 1e-4, n


def test_unported_and_unknown_schedules_raise():
    """The mesh branches build on a one-rank mesh and agree with the
    single-device model (several ranks: `tests/test_torch_spectral_dist.py`);
    "fused" without a mesh is the per-conv tree, as in JAX; an unknown
    schedule and a grid the model was not built for raise."""
    kw = dict(embed_dim=8, num_layers=1, height=8, width=16, constant_channels=0,
              prescribed_channels=0, prognostic_channels=1)
    prog = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, 1, 8, 16)).astype(np.float32))
    single = tsfno.SFNO2DModule(**kw)
    want = single(None, None, prog)
    with one_rank_mesh() as mesh:
        for schedule in ("per_conv", "fused"):
            meshed = tsfno.SFNO2DModule(**kw, spmd_mesh=mesh, dist_schedule=schedule)
            if schedule == "per_conv":
                meshed.load_state_dict(single.state_dict())
            else:
                assert "blocks_0_spec" in dict(meshed.named_parameters())
            out = meshed(None, None, prog)
            assert out.shape == want.shape and torch.isfinite(out).all()
            if schedule == "per_conv":
                assert (out - want).abs().max() <= MODEL_TOL * want.abs().max()
        conv = tsfno.SphericalConv(4, 4, 8, 16, spmd_mesh=mesh)
        x = torch.randn(2, 8, 16, 4, generator=torch.Generator().manual_seed(0))
        want_conv = tsfno.SphericalConv(4, 4, 8, 16)(x)
        assert (conv(x) - want_conv).abs().max() <= MODEL_TOL * want_conv.abs().max()
    assert ({n for n, _ in tsfno.SFNO2DModule(**kw, dist_schedule="fused").named_parameters()}
            == {n for n, _ in single.named_parameters()})
    with pytest.raises(ValueError, match="dist_schedule"):
        tsfno.SFNO2DModule(embed_dim=8, num_layers=1, dist_schedule="pipelined")
    model = tsfno.SFNO2DModule(embed_dim=8, num_layers=1, height=8, width=16,
                               constant_channels=0, prescribed_channels=0,
                               prognostic_channels=1)
    with pytest.raises(ValueError, match="8x16"):
        model(None, None, torch.zeros(1, 2, 1, 16, 32))
