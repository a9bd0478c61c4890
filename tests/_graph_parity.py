"""Shared parity helpers of the graph-model tests (`test_torch_graphcast.py`,
`test_torch_mgn.py`): JAX's model and the port's on the same perturbed
weights and numpy inputs, rollouts and every gradient, with remat on and
off; the shipped config's parameter tree against `jax.eval_shape`'s."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dlwpbench_tpu.models import build_model as jbuild
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import registry

MODEL_TOL = 1e-4
REMAT_TOL = 1e-6
# The onehot form rounds its operands to bf16 on both sides.  Where an
# fp32 operand lies within the two sides' fp32 rounding of a bf16 rounding
# boundary, JAX and the port round it to adjacent bf16 values: one bf16
# ulp, 2^-8 of that value.  Measured on GraphCast at mesh level 1 (this
# file's inputs, seeds 0 to 2): outputs within 5.8e-4 of their max (21 and
# 31 of 1,024 outputs past 1e-4 in two seeds, none in the third),
# gradients within 1.9e-3; JAX's own onehot against gather form 2.2e-3.
# Op by op, on equal inputs, the onehot form agrees within 1e-6
# (`test_torch_graph_ops.py`).
ONEHOT_TOL = 2.0**-8


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(params, seed=0, scale=0.05):
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


def inputs(H, W, ctx, forcing=True, seed=0, B=2, steps=2):
    """(constants, prescribed, prognostic, target) from a numpy seed: 2
    constant, 1 prescribed and 2 prognostic channels."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    T = ctx + steps
    const = f(B, 1, 2, H, W) if forcing else None
    pres = f(B, T, 1, H, W) if forcing else None
    return const, pres, f(B, T, 2, H, W), f(B, steps, 2, H, W)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def check_against_jax(cfg: dict, jcfg: dict, inputs, seed=0, tol=MODEL_TOL):
    """JAX's model built from `jcfg` and the port's from `cfg`: the rollout
    and every parameter gradient of a mean-squared loss within `tol` of
    each tensor's max, the port with remat on and off within REMAT_TOL of
    each other."""
    const, pres, prog, target = inputs
    jmodel = jbuild(dict(jcfg))
    params = perturbed(np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), const, pres,
                                                    prog)))

    def loss_fn(p):
        out = jmodel.apply(p, const, pres, prog)
        return jnp.mean((out - target) ** 2), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = weights.flatten_tree(np_tree(j_grads["params"]))
    results = []
    for remat in (True, False):
        tmodel = registry.build_model({**cfg, "remat": remat})
        weights.load_flax_params(tmodel, params)
        out = tmodel(*_t(const, pres, prog))
        assert out.shape == j_out.shape == target.shape
        torch.mean((out - torch.from_numpy(target)) ** 2).backward()
        results.append((out.detach().numpy(), weights.flatten_tree(weights.to_flax_tree(
            tmodel, {n: p.grad for n, p in tmodel.named_parameters()}))))
    (out, grads), (out_nr, grads_nr) = results
    assert_grads_close({"out": out}, {"out": np.asarray(j_out)}, tol)
    assert_grads_close(grads, want, tol)
    assert_grads_close({"out": out_nr, **grads_nr}, {"out": out, **grads}, REMAT_TOL)


def jax_tree_shapes(cfg, tmodel, batch: int = 1):
    """({flax path: shape} of the port's model, the same of JAX's model
    built from `cfg.model`, by `jax.eval_shape` on the data's grid: no
    compute)."""
    d = cfg.data
    H, W = int(d.height), int(d.width)
    ctx = int(cfg.model.context_size)
    const = np.empty((batch, 1, d.constant_channels, H, W), np.float32)
    pres = np.empty((batch, ctx + 1, d.prescribed_channels, H, W), np.float32)
    prog = np.empty((batch, ctx + 1, d.prognostic_channels, H, W), np.float32)
    jparams = jax.eval_shape(jbuild(dict(cfg.model)).init, jax.random.PRNGKey(0),
                             const, pres, prog)
    jshapes = {k: v.shape for k, v in weights.flatten_tree(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, a.dtype), jparams["params"])).items()}
    tshapes = {k: v.shape for k, v in weights.flatten_tree(weights.to_flax_tree(tmodel)).items()}
    return tshapes, jshapes
