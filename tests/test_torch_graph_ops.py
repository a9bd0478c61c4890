"""The port's graph ops (`dlwpbench_tpu_torch/ops/graph_ops.py`) against the
JAX package's on the CPU: the gather form, the onehot form, the stencil
movement, and `MeshGraphMLP`, `MeshEdgeBlock` and `MeshNodeBlock` on JAX's
weights (moved by seeded noise), forward and gradients.

Inputs come from numpy seeds; gradients are the vector-Jacobian products
of one seeded cotangent.  Tolerances, fp32:
- the gather form, the stencil movement and the onehot form: max|diff| <=
  1e-6 x max|that tensor| (the same sums in other orders; the onehot
  operands are rounded to bf16 on both sides, the gathers exactly);
- the MLP and the blocks: 1e-5 x each tensor's max (Dense layers and
  LayerNorm in other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from dlwpbench_tpu.ops import graph_ops as jg
from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.ops import graph_ops as tg

MOVE_TOL = 1e-6
BLOCK_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread per test: the ops here are small, and the
    suite's workers share the cores (each extra thread only waits on the
    others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_close(got: dict, want: dict, tol: float):
    """Per tensor within tol x its max (a tensor whose exact value is 0:
    within tol x the largest)."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-6 * top)
        err = float(np.abs(np.asarray(got[k]) - w).max())
        assert err <= tol * scale, (k, err, scale)


def _graph(E=57, N=13, M=11, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N, E).astype(np.int32), rng.integers(0, M, E).astype(np.int32),
            N, M, rng)


def _vjp_jax(fn, *args):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    ct = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))], ct


def _vjp_torch(fn, ct, *args):
    xs = [torch.from_numpy(np.asarray(a)).requires_grad_(True) for a in args]
    out = fn(*xs)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("impl", ["gather", "auto", "onehot"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("which", ["src", "dst"])
def test_gather_matches_jax(which, lead, impl):
    src, dst, N, M, rng = _graph()
    n = N if which == "src" else M
    x = rng.standard_normal((*lead, n, 5)).astype(np.float32)
    jmv = jg.EdgeMovement(src, dst, N, M, "gather" if impl == "auto" else impl)
    tmv = tg.EdgeMovement(src, dst, N, M, impl)
    jfn, tfn = getattr(jmv, f"gather_{which}"), getattr(tmv, f"gather_{which}")
    want, (wgrad,), ct = _vjp_jax(jfn, x)
    got, (ggrad,) = _vjp_torch(tfn, ct, x)
    assert_close({"out": got, "grad": ggrad}, {"out": want, "grad": wgrad}, MOVE_TOL)


@pytest.mark.parametrize("impl", ["gather", "onehot"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_aggregate_matches_jax(lead, mode, impl):
    """Sums and means onto the destinations (one destination has no edge:
    its mean divides by 1), forward and gradient, for any leading dims."""
    src, dst, N, M, rng = _graph()
    dst = np.where(dst == 4, 5, dst).astype(np.int32)  # node 4 receives nothing
    e = rng.standard_normal((*lead, src.size, 6)).astype(np.float32)
    jmv, tmv = jg.EdgeMovement(src, dst, N, M, impl), tg.EdgeMovement(src, dst, N, M, impl)
    want, (wgrad,), ct = _vjp_jax(lambda a: jmv.aggregate(a, mode), e)
    got, (ggrad,) = _vjp_torch(lambda a: tmv.aggregate(a, mode), ct, e)
    assert got.shape == (*lead, M, 6) and np.all(got[..., 4, :] == 0)
    assert_close({"out": got, "grad": ggrad}, {"out": want, "grad": wgrad}, MOVE_TOL)


def test_onehot_rounds_its_operand_to_bf16():
    """The onehot form's forward is the gather of x rounded to bf16 once
    (exact 0/1 products), cast back to x's dtype."""
    src, dst, N, M, rng = _graph()
    x = torch.from_numpy(rng.standard_normal((2, N, 4)).astype(np.float32))
    got = tg.EdgeMovement(src, dst, N, M, "onehot").gather_src(x)
    want = x.to(torch.bfloat16).float().index_select(-2, torch.from_numpy(src).long())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    x16 = x.to(torch.bfloat16)
    assert tg.EdgeMovement(src, dst, N, M, "onehot").aggregate(x16[:, src]).dtype == torch.bfloat16


def test_unknown_impl_and_aggregation_raise():
    with pytest.raises(ValueError, match="impl"):
        tg.EdgeMovement(np.zeros(2, np.int32), np.zeros(2, np.int32), 1, 1, "dense")
    with pytest.raises(ValueError, match="aggregation"):
        tg.MeshNodeBlock(4, 2, 2, 1, "max")


DIRS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
DIRS8 = DIRS4 + ((-1, 1), (1, 1), (1, -1), (-1, -1))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dirs", [DIRS4, DIRS8], ids=["4", "8"])
def test_stencil_movement_matches_jax(dirs, periodic, mode):
    """The gathers [..., D, H, W, F] and the masked aggregation, forward
    and gradients, with a batch dim, on an odd grid."""
    H, W, D = 5, 7, len(dirs)
    rng = np.random.default_rng(11)
    n = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    e = rng.standard_normal((2, D, H, W, 3)).astype(np.float32)
    jmv, tmv = jg.StencilMovement(H, W, dirs, periodic), tg.StencilMovement(H, W, dirs, periodic)
    np.testing.assert_array_equal(tmv.valid("cpu")[..., 0].numpy(), jmv.valid)
    for name in ("gather_src", "gather_dst"):
        want, (wg,), ct = _vjp_jax(getattr(jmv, name), n)
        got, (gg,) = _vjp_torch(getattr(tmv, name), ct, n)
        assert_close({"out": got, "grad": gg}, {"out": want, "grad": wg}, MOVE_TOL)
    want, (wg,), ct = _vjp_jax(lambda a: jmv.aggregate(a, mode), e)
    got, (gg,) = _vjp_torch(lambda a: tmv.aggregate(a, mode), ct, e)
    assert_close({"out": got, "grad": gg}, {"out": want, "grad": wg}, MOVE_TOL)


def _perturbed(params, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _check_module(jmod, tmod, args, seed=0):
    """The flax module on perturbed init weights against the port's module
    with those weights: the output, each input's gradient and every
    parameter's gradient for one seeded cotangent."""
    params = _perturbed(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), *args)), seed)
    weights.load_flax_params(tmod, params)
    out, vjp = jax.vjp(lambda p, *a: jmod.apply(p, *a), params,
                       *(jnp.asarray(a) for a in args))
    ct = np.random.default_rng(seed + 1).standard_normal(out.shape).astype(np.float32)
    jp_grad, *jx_grad = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tout = tmod(*xs)
    tout.backward(torch.from_numpy(ct))
    got = {"out": tout.detach().numpy(), **{f"x{i}": x.grad.numpy() for i, x in enumerate(xs)},
           **weights.flatten_tree(weights.to_flax_tree(
               tmod, {n: p.grad for n, p in tmod.named_parameters()}))}
    want = {"out": np.asarray(out), **{f"x{i}": np.asarray(g) for i, g in enumerate(jx_grad)},
            **weights.flatten_tree(jax.tree_util.tree_map(np.asarray, jp_grad["params"]))}
    assert_close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("hidden_layers", [0, 1, 2])
def test_mesh_graph_mlp_matches_jax(hidden_layers, norm):
    """`hidden_layers == 0` is one Dense without LayerNorm whatever `norm`
    says; else Dense -> SiLU layers, a Dense and LayerNorm (eps 1e-5)."""
    x = np.random.default_rng(1).standard_normal((2, 9, 5)).astype(np.float32)
    tmod = tg.MeshGraphMLP(5, 6, 7, hidden_layers, norm=norm)
    assert (tmod.LayerNorm_0 is not None) == (norm and hidden_layers > 0)
    _check_module(jg.MeshGraphMLP(6, 7, hidden_layers, norm=norm), tmod, [x])


def test_mesh_graph_mlp_relu_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    _check_module(jg.MeshGraphMLP(4, 8, 2, activation=fnn.relu),
                  tg.MeshGraphMLP(5, 4, 8, 2, activation=F.relu), [x])


class _JaxEdge(fnn.Module):
    mv: object
    hidden_layers: int = 1

    @fnn.compact
    def __call__(self, e, ns, nd):
        return jg.MeshEdgeBlock(6, 8, self.hidden_layers)(e, ns, nd, movement=self.mv)


class _JaxNode(fnn.Module):
    mv: object
    aggregation: str = "sum"

    @fnn.compact
    def __call__(self, e, n):
        return jg.MeshNodeBlock(6, 8, 1, self.aggregation)(e, n, movement=self.mv)


class _TorchEdge(torch.nn.Module):
    def __init__(self, mv, fin, hidden_layers=1):
        super().__init__()
        self.mv = mv
        self.MeshEdgeBlock_0 = tg.MeshEdgeBlock(fin, 6, 8, hidden_layers)

    def forward(self, e, ns, nd):
        return self.MeshEdgeBlock_0(e, ns, nd, self.mv)


class _TorchNode(torch.nn.Module):
    def __init__(self, mv, fin, aggregation="sum"):
        super().__init__()
        self.mv = mv
        self.MeshNodeBlock_0 = tg.MeshNodeBlock(fin, 6, 8, 1, aggregation)

    def forward(self, e, n):
        return self.MeshNodeBlock_0(e, n, self.mv)


@pytest.mark.parametrize("hidden_layers", [1, 2])
@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_edge_block_matches_jax(impl, hidden_layers):
    """A bipartite edge block (src and dst node sets of other sizes and
    widths): cat(e, src[src], dst[dst]) through the MLP plus e."""
    src, dst, N, M, rng = _graph()
    e = rng.standard_normal((2, src.size, 6)).astype(np.float32)
    ns = rng.standard_normal((2, N, 4)).astype(np.float32)
    nd = rng.standard_normal((2, M, 3)).astype(np.float32)
    _check_module(_JaxEdge(jg.EdgeMovement(src, dst, N, M, impl), hidden_layers),
                  _TorchEdge(tg.EdgeMovement(src, dst, N, M, impl), 13, hidden_layers),
                  [e, ns, nd])


@pytest.mark.parametrize("aggregation", ["sum", "mean"])
@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_node_block_matches_jax(impl, aggregation):
    src, dst, N, M, rng = _graph()
    e = rng.standard_normal((2, src.size, 5)).astype(np.float32)
    n = rng.standard_normal((2, M, 6)).astype(np.float32)
    _check_module(_JaxNode(jg.EdgeMovement(src, dst, N, M, impl), aggregation),
                  _TorchNode(tg.EdgeMovement(src, dst, N, M, impl), 11, aggregation), [e, n])


@pytest.mark.parametrize("aggregation", ["sum", "mean"])
def test_blocks_on_the_stencil_match_jax(aggregation):
    """Both blocks on the 8-stencil's [..., D, H, W, F] layout."""
    H, W = 4, 6
    rng = np.random.default_rng(12)
    jmv, tmv = jg.StencilMovement(H, W, DIRS8), tg.StencilMovement(H, W, DIRS8)
    n = rng.standard_normal((2, H, W, 6)).astype(np.float32)
    e = rng.standard_normal((2, 8, H, W, 6)).astype(np.float32)
    _check_module(_JaxEdge(jmv), _TorchEdge(tmv, 18), [e, n, n])
    _check_module(_JaxNode(jmv, aggregation), _TorchNode(tmv, 12, aggregation), [e, n])
