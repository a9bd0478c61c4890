"""The port's GraphCastNet (`dlwpbench_tpu_torch/models/graphcast.py`)
against the JAX package on the CPU, and a small run through the train,
build_baselines and evaluate CLIs.

JAX parameters, each moved by seeded noise (so that no weight sits at its
init's special values), reach the port through `weights.load_flax_params`;
inputs come from numpy seeds.  Tolerances, fp32:
- rollouts and every parameter gradient: max|diff| <= 1e-4 x max|that
  tensor| (Dense layers, LayerNorms and the per-node sums in other orders
  through 2 closed-loop steps); with the onehot form 2^-8 (one bf16 ulp:
  it rounds its operands to bf16 on both sides, and an operand at a
  rounding boundary may land on either neighbour, `_graph_parity.
  ONEHOT_TOL`);
- remat on against off: 1e-6 of each tensor's max (the same ops
  recomputed);
- the shipped config's parameter tree and count: exact.
"""

import os

import numpy as np
import pytest
import torch

from dlwpbench_tpu_torch import build_baselines, evaluate, train
from dlwpbench_tpu_torch.models import graphcast as tgc
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.training.config import load_config
from _graph_parity import MODEL_TOL, ONEHOT_TOL, check_against_jax, inputs, jax_tree_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(type="GraphCastNet", input_height=8, input_width=16, mesh_level=1,
             hidden_dim=16, processor_layers=2, constant_channels=2, prescribed_channels=1,
             prognostic_channels=2)
# (grid convention, movement, aggregation, node-feature unit, hidden layers, context)
CASES = [
    ("cell_centers", "gather", "sum", "rad", 1, 1),
    ("pole_inclusive", "gather", "sum", "deg_quirk", 1, 2),
    ("cell_centers", "onehot", "sum", "rad", 1, 1),
    ("pole_inclusive", "onehot", "mean", "rad", 2, 1),
    ("cell_centers", "auto", "mean", "rad", 0, 1),
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


@pytest.mark.parametrize("convention, impl, aggregation, unit, hidden_layers, ctx", CASES)
def test_rollout_and_grads_match_jax(convention, impl, aggregation, unit, hidden_layers, ctx):
    cfg = dict(SMALL, grid_convention=convention, movement_impl=impl, aggregation=aggregation,
               node_feat_unit=unit, hidden_layers=hidden_layers, context_size=ctx)
    jcfg = dict(cfg, movement_impl="gather" if impl == "auto" else impl)
    check_against_jax(cfg, jcfg, inputs(8, 16, ctx),
                      tol=ONEHOT_TOL if impl == "onehot" else MODEL_TOL)


def test_shipped_config_builds_jax_tree():
    """`configs/model/graphcast.yaml` on the 32 x 64 synthetic grid: the
    JAX parameter tree (names in JAX's creation order), path for path and
    shape for shape, and its 35,232,264 parameters, without computing."""
    cfg = load_config(os.path.join(REPO, "configs"), overrides=["model=graphcast",
                                                                "data=synthetic"])
    tmodel = registry.build_model(cfg.model, seed=1,
                                  grid_shape=registry.data_grid_shape(cfg.data))
    assert isinstance(tmodel, tgc.GraphCastNet)
    assert sum(p.numel() for p in tmodel.parameters()) == 35_232_264
    tshapes, jshapes = jax_tree_shapes(cfg, tmodel)
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in jshapes.values()) == 35_232_264


def test_mesh_and_grid_mismatch_raise():
    with pytest.raises(NotImplementedError, match="item 16"):
        tgc.GraphCastNet(**{k: v for k, v in SMALL.items() if k != "type"}, spmd_mesh=object())
    model = registry.build_model(dict(SMALL))
    args = [torch.zeros(1, t, c, 16, 32) for t, c in ((1, 2), (2, 1), (2, 2))]
    with pytest.raises(ValueError, match="8 x 16"):
        model(*args)
    with pytest.raises(ValueError, match="grid_convention"):
        registry.build_model(dict(SMALL, grid_convention="corners"))
    with pytest.raises(ValueError, match="aggregation"):
        registry.build_model(dict(SMALL, aggregation="max"))
    with pytest.raises(ValueError, match="impl"):
        registry.build_model(dict(SMALL, movement_impl="dense"))


def test_graph_tables_are_built_once_and_shared():
    """Two models on one graph share their movements (and so their device
    tables); the onehot form has its own."""
    a, b = registry.build_model(dict(SMALL)), registry.build_model(dict(SMALL, seed=3))
    assert a.movements is b.movements
    c = registry.build_model(dict(SMALL, movement_impl="onehot"))
    assert c.movements is not a.movements and c.movements[1].impl == "onehot"


def test_graphcast_run_through_the_clis(tmp_path, monkeypatch):
    """`train model=graphcast` at mesh level 1 on an 8 x 16 grid, then
    `build_baselines -c` and `evaluate -c --device cpu`: finite losses,
    RMSE and ACC, the forecast files on the grid."""
    monkeypatch.chdir(tmp_path)
    run_dir = str(tmp_path / "runs" / "graphcast")
    res = train.main(["model=graphcast", "data=synthetic", "data.height=8", "data.width=16",
                      "data.n_time=120", "model.mesh_level=1", "model.hidden_dim=16",
                      "model.processor_layers=2", "training.epochs=1", "training.batch_size=8",
                      "validation.batch_size=4", "validation.sequence_length=4",
                      "verbose=false", f"run_dir={run_dir}", "--device", "cpu"])
    assert np.isfinite(res["train_loss"] + res["val_loss"]).all()
    assert res["state"].model.grid_shape == (8, 16)
    build_baselines.main(["-c", run_dir, "--sequence-length", "4"])
    got = evaluate.main(["-c", run_dir, "--sequence-length", "4", "--batch-size", "4",
                         "--device", "cpu"])["graphcast"]
    assert np.isfinite(got["rmse"]["var0"]).all() and np.isfinite(got["acc"]["var0"]).all()
    assert os.path.exists(os.path.join(run_dir, "evaluation", "outputs.nc"))
