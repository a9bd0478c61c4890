"""The port's FourCastNet and FourCastNetv2 (`dlwpbench_tpu_torch/models/
fourcastnet.py`) against the JAX package on the CPU.

JAX parameters, each moved by seeded noise (the AFNO weights' 0.02 init
would leave most of the spectrum inside softshrink's dead band), reach the
port through `weights.load_flax_params`; inputs come from numpy seeds.
Tolerances, fp32:
- rollouts and every parameter gradient, each filter ("AFNO2D" on both
  `fft_impl` branches, "SFNO", "FNO2D"): max|diff| <= 1e-4 x max|that
  tensor| (the DFTs, LayerNorm and the Dense layers summed in other orders
  through 2 closed-loop steps); a gradient that is 0 in exact arithmetic
  is held to 1e-4 of the largest;
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

from _torch_dist_child import one_rank_mesh
import _jax_ref as jax_ref
from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu_torch import train, weights
from dlwpbench_tpu_torch.models import fourcastnet as tfcn
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = 1e-4
SMALL = dict(embed_dim=16, depth=2, mlp_ratio=2.0, num_blocks=4, n_modes=[3, 4])
# (filter, fft_impl, patch, grid, context, constants and prescribed channels)
CASES = [
    ("AFNO2D", "matmul", (1, 1), (8, 16), 1, True),
    ("AFNO2D", "fft", (1, 1), (8, 16), 2, False),
    ("AFNO2D", "matmul", (2, 2), (8, 16), 1, False),
    ("AFNO2D", "matmul", (1, 1), (7, 11), 1, True),
    ("SFNO", "matmul", (1, 1), (8, 16), 1, True),
    ("SFNO", "matmul", (2, 2), (16, 32), 2, False),
    ("FNO2D", "matmul", (1, 1), (8, 16), 1, True),
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


def _kw(filt, fft_impl, patch, grid, ctx, forcing):
    return dict(type="FourCastNet", img_height=grid[0], img_width=grid[1],
                patch_size=list(patch), constant_channels=2 if forcing else 0,
                prescribed_channels=1 if forcing else 0, prognostic_channels=2,
                context_size=ctx, filter=filt, fft_impl=fft_impl, **SMALL)


def _torch_grads(model):
    return weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))


@pytest.mark.parametrize("filt, fft_impl, patch, grid, ctx, forcing", CASES)
def test_rollout_and_grads_match_jax(filt, fft_impl, patch, grid, ctx, forcing):
    """Two blocks, embed 16, 4 AFNO blocks, batch 2, 2 closed-loop steps;
    the port with and without per-step remat."""
    cfg = _kw(filt, fft_impl, patch, grid, ctx, forcing)
    const, pres, prog, target = _inputs(*grid, ctx, forcing)
    jmodel = jbuild(dict(cfg))
    params = _perturbed(_np_tree(jax_ref.init(jmodel, jax.random.PRNGKey(0), const, pres, prog)))

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = weights.flatten_tree(_np_tree(j_grads["params"]))
    results = []
    for remat in (True, False):
        tmodel = registry.build_model({**cfg, "remat": remat})
        assert type(tmodel.AFNOBlock_0.filter).__name__ == {
            "AFNO2D": "AFNO2DFilter", "SFNO": "SphericalConv", "FNO2D": "FNOCore"}[filt]
        weights.load_flax_params(tmodel, params)
        out = tmodel(*_t(const, pres, prog))
        assert out.shape == j_out.shape == target.shape
        torch.mean((out - torch.from_numpy(target)) ** 2).backward()
        results.append((out.detach().numpy(), _torch_grads(tmodel)))
    (out, grads), (out_nr, grads_nr) = results
    assert_grads_close({"out": out}, {"out": np.asarray(j_out)})
    assert_grads_close(grads, want)
    assert_grads_close({"out": out_nr, **grads_nr}, {"out": out, **grads}, 1e-6)


@pytest.mark.parametrize("name, n_params", [("fourcastnet", 283_264),
                                            ("fourcastnetv2", 1_314_432)])
def test_shipped_config_builds_jax_tree(name, n_params):
    """`configs/model/{fourcastnet,fourcastnetv2}.yaml` on the 32 x 64
    synthetic grid: the JAX parameter tree, path for path and shape for
    shape (no final LayerNorm on either side), and its parameter count."""
    cfg = load_config(os.path.join(REPO, "configs"), overrides=[f"model={name}",
                                                                "data=synthetic"])
    tmodel = registry.build_model(cfg.model, seed=1)
    assert isinstance(tmodel, tfcn.FourCastNet)
    assert tmodel.AFNOBlock_0.filter_type == ("SFNO" if name.endswith("v2") else "AFNO2D")
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
    assert not any("LayerNorm" in k and not k.startswith("AFNOBlock") for k in tshapes)


@pytest.mark.parametrize("filt", ["AFNO2D", "SFNO", "FNO2D"])
def test_weights_round_trip(filt):
    """flax tree -> port -> flax tree is the identity: `pos_embed`, AFNO's
    `w1`, `b1`, `w2`, `b2`, `SphericalConv`'s `weight` and the FNO mixer's
    spectral weights as they are, the patch conv HWIO <-> OIHW."""
    cfg = _kw(filt, "matmul", (2, 2), (8, 16), 1, True)
    const, pres, prog, _ = _inputs(8, 16, 1, True)
    params = _perturbed(_np_tree(jbuild(dict(cfg)).init(jax.random.PRNGKey(2), const, pres,
                                                        prog)))
    tmodel = registry.build_model(cfg)
    weights.load_flax_params(tmodel, params)
    back = weights.flatten_tree(weights.to_flax_tree(tmodel))
    want = weights.flatten_tree(params["params"])
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def test_seeded_init_follows_jax_distributions():
    """trunc-normal 0.02 for the Dense kernels and the position embedding,
    0.02 N(0, 1) for the AFNO weights, N(0, 1)/sqrt(Cin Cout) for the
    spherical convolution, lecun-normal for the FNO mixer's Dense layers."""
    m = tfcn.FourCastNet(embed_dim=32, depth=1, num_blocks=4, seed=0)
    assert abs(m.pos_embed.std().item() - 0.02 * 0.88) < 0.002
    assert m.pos_embed.abs().max().item() <= 0.04 + 1e-7
    assert abs(m.AFNOBlock_0.filter.w1.std().item() - 0.02) < 0.004
    v2 = tfcn.FourCastNet(embed_dim=32, depth=1, filter="SFNO", seed=0)
    assert abs(v2.AFNOBlock_0.filter.weight.std().item() * 32 - 1.0) < 0.05
    f = tfcn.FourCastNet(embed_dim=32, depth=1, filter="FNO2D", seed=0).AFNOBlock_0.filter
    assert abs(f.Dense_0.weight.std().item() * np.sqrt(32) - 1.0) < 0.2


def test_unported_options_raise():
    """Every filter builds with a mesh (one rank here, several in
    `tests/test_torch_spectral_dist.py`) and agrees with the single-device
    model: AFNO2D and SFNO over the distributed transforms, FNO2D on the
    token rows gathered from the ranks.  An unknown filter raises."""
    kw = dict(img_height=8, img_width=16, embed_dim=16, depth=1, num_blocks=4,
              constant_channels=0, n_modes=(3, 4))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 2, 1, 8, 16)).astype(np.float32))
    with one_rank_mesh() as mesh:
        for filt in ("AFNO2D", "SFNO", "FNO2D"):
            single = tfcn.FourCastNet(**kw, filter=filt)
            meshed = tfcn.FourCastNet(**kw, filter=filt, spmd_mesh=mesh)
            meshed.load_state_dict(single.state_dict())
            want = single(None, None, x)
            assert (meshed(None, None, x) - want).abs().max() <= MODEL_TOL * want.abs().max()
    with pytest.raises(ValueError, match="unknown filter"):
        tfcn.FourCastNet(embed_dim=16, depth=1, num_blocks=4, filter="GNO")


def test_cli_trains_fourcastnetv2_on_cpu(tmp_path):
    """`train model=fourcastnetv2` (the SFNO mixer) on an 8 x 16 grid:
    finite losses, the best and last checkpoints."""
    res = train.main(["model=fourcastnetv2", "data=synthetic", "data.height=8",
                      "data.width=16", "data.n_time=120", "model.embed_dim=16",
                      "model.depth=2", "training.epochs=1", "training.batch_size=8",
                      "validation.batch_size=4", "validation.sequence_length=4",
                      "verbose=false", f"run_dir={tmp_path}", "--device", "cpu"])
    assert np.isfinite(res["train_loss"] + res["val_loss"]).all()
    assert res["state"].model.AFNOBlock_0.filter.tables.nlat == 8
    for kind in ("best", "last"):
        assert (tmp_path / "checkpoints" / f"fourcastnetv2_{kind}.ckpt").exists()
