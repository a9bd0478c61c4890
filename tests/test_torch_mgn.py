"""The port's MeshGraphNet (`dlwpbench_tpu_torch/models/mgn.py`) against the
JAX package on the CPU.

JAX parameters, each moved by seeded noise, reach the port through
`weights.load_flax_params`; inputs come from numpy seeds.  Tolerances,
fp32:
- rollouts and every parameter gradient: max|diff| <= 1e-4 x max|that
  tensor| (Dense layers, LayerNorms and the per-node sums in other orders
  through 2 closed-loop steps);
- remat on against off: 1e-6 of each tensor's max;
- the port's stencil form against its own edge list: the same 1e-4 (the
  same sums, in rolls or by index; the stencil's also run over the dead
  slots' zeros);
- the shipped config's parameter tree and count: exact.
"""

import os

import numpy as np
import pytest
import torch

from dlwpbench_tpu_torch import weights
from dlwpbench_tpu_torch.models import mgn as tmgn
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_config
from _graph_parity import assert_grads_close, check_against_jax, inputs, jax_tree_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(type="MeshGraphNet", processor_size=2, hidden_dim_processor=8,
             hidden_dim_node_encoder=8, hidden_dim_edge_encoder=8, hidden_dim_node_decoder=8,
             constant_channels=2, prescribed_channels=1, prognostic_channels=2)
# (graph type, movement, aggregation, periodic, context)
CASES = [
    ("grid_2d", "auto", "sum", True, 1),
    ("grid_2d", "edge_list", "mean", False, 1),
    ("grid_2d_8stencil", "auto", "mean", False, 1),
    ("grid_2d_8stencil", "edge_list", "sum", True, 2),
    ("delaunay", "auto", "sum", True, 1),
    ("delaunay", "auto", "mean", False, 2),
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


@pytest.mark.parametrize("graph_type, impl, aggregation, periodic, ctx", CASES)
def test_rollout_and_grads_match_jax(graph_type, impl, aggregation, periodic, ctx):
    cfg = dict(SMALL, graph_type=graph_type, movement_impl=impl, aggregation=aggregation,
               periodic=periodic, context_size=ctx)
    check_against_jax(cfg, cfg, inputs(8, 16, ctx))


@pytest.mark.parametrize("aggregation", ["sum", "mean"])
@pytest.mark.parametrize("graph_type", ["grid_2d", "grid_2d_8stencil"])
def test_stencil_matches_edge_list(graph_type, aggregation):
    """The stencil form against the edge list on one set of weights: the
    same parameter tree, rollout and gradients, on an odd grid."""
    const, pres, prog, target = (torch.from_numpy(a) for a in inputs(5, 7, 1, seed=4))
    got = {}
    for impl in ("auto", "edge_list"):
        model = registry.build_model(dict(SMALL, graph_type=graph_type, movement_impl=impl,
                                          aggregation=aggregation, seed=2))
        assert model.stencil == (impl == "auto")
        out = model(const, pres, prog)
        torch.mean((out - target) ** 2).backward()
        got[impl] = {"out": out.detach().numpy(), **weights.flatten_tree(weights.to_flax_tree(
            model, {n: p.grad for n, p in model.named_parameters()}))}
    assert_grads_close(got["auto"], got["edge_list"])


@pytest.mark.parametrize("graph_type, n_params, edge_in",
                         [("delaunay", 50_452, 2), ("grid_2d", 50_452, 2),
                          ("grid_2d_8stencil", 50_484, 3)])
def test_shipped_config_builds_jax_tree(graph_type, n_params, edge_in):
    """`configs/model/meshgraphnet.yaml` (Delaunay) and its stencil graph
    types on the 32 x 64 synthetic grid: the JAX parameter tree, path for
    path and shape for shape, and its count.  The 8-stencil's edge encoder
    takes 3 features where the yaml says `input_dim_edges: 2`: flax sizes
    the Dense from the graph, and so does the port."""
    cfg = load_config(os.path.join(REPO, "configs"), overrides=[
        "model=meshgraphnet", "data=synthetic", f"model.graph_type={graph_type}"])
    assert int(cfg.model.input_dim_edges) == 2
    tmodel = registry.build_model(cfg.model, seed=1,
                                  grid_shape=registry.data_grid_shape(cfg.data))
    assert isinstance(tmodel, tmgn.MeshGraphNet)
    assert sum(p.numel() for p in tmodel.parameters()) == n_params
    assert tmodel.MeshGraphMLP_1.Dense_0.in_features == edge_in
    tshapes, jshapes = jax_tree_shapes(cfg, tmodel)
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == n_params


def test_unknown_options_raise():
    with pytest.raises(ValueError, match="graph_type"):
        registry.build_model(dict(SMALL, graph_type="icosahedral"))
    with pytest.raises(ValueError, match="movement_impl"):
        registry.build_model(dict(SMALL, movement_impl="onehot"))
