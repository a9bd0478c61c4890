"""The port's multi-process layer (`dlwpbench_tpu_torch/parallel/`, the
trainer's data parallelism, the train CLI's `data_parallel` and
`multihost`) against the JAX package's, on the CPU.

In this process: the launch specs, host sharding of `batches` (bit for
bit, noise included), the partition plan (array for array) and the
refusal of `data_parallel` without a job.
Two module-scoped spawns of gloo ranks (`tests/_torch_dist_child.py`) run
the rest, each case below reading one rank's results:
- suite "mesh", 4 ranks (JAX tests these 4- and 8-way): the halo and its
  gradient (`tests/test_parallel.py::TestHalo`, `:332`), partitioned
  message passing (`:217`), the sharded HEALPix pad at nside 4 with pad 1
  and 2 (`:262`), the partitioned GraphCast's rollout, gradients and
  closed-loop rollout (`:708-790`), each with gradients where JAX has a
  function to differentiate, a trainer step of the partitioned
  GraphCast against the single-device one, and the U-Net on latitude
  rows (`benchmark_scaling --spatial`) against JAX's single-device one;
- suite "train", 2 ranks: three data-parallel steps of a small Swin
  against JAX's `Trainer` on the global batch (fp32 with and without
  accumulation, with remat, a batch that does not split evenly, bf16),
  three multihost steps (each rank its shard of the epoch) against JAX's
  `Trainer` on the hosts' batches concatenated, a diffusion step with its
  EMA under data_parallel and under multihost, the train CLI under
  `training.multihost=true` and `continue_training`, and under
  `training.data_parallel=2` against the single-process CLI.

Tolerances, fp32: the exchanges within 1e-6 of JAX (they move values, the
sums are the same few terms); the models within 1e-4 of each tensor's max
(`_graph_parity.MODEL_TOL`); the trainer as `tests/test_torch_trainer.py`
holds it: losses rtol 1e-5, every parameter within lr / 100 after three
steps; bf16 losses within 2e-3 of JAX's bf16 losses and of the port's
single-process bf16 steps on the same global batches
(`tests/test_torch_bf16.py`'s LOSS_RTOL: a half batch rounds its bf16
sums at other points, and Adam moves a weight whose gradient rounds to the
other sign by about the learning rate), the first step's loss within
1e-5 of the single-process one.  The two ranks' parameters are equal bit
for bit in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from _graph_parity import MODEL_TOL, assert_grads_close, np_tree, perturbed
from _torch_dist_child import start_ranks
import _jax_ref as jax_ref
from dlwpbench_tpu.data.dataset import WindowedWeatherDataset as JDataset
from dlwpbench_tpu.models import graphcast as jgc
from dlwpbench_tpu.models import modern_unet as jmu
from dlwpbench_tpu.models import swin as jswin
from dlwpbench_tpu.models import unet as junet
from dlwpbench_tpu.ops.padding import cylinder_pad, healpix_pad
from dlwpbench_tpu.parallel.graph_partition import (
    partition_graph_nodewise,
    partitioned_message_passing,
)
from dlwpbench_tpu.parallel.halo import sharded_cylinder_pad
from dlwpbench_tpu.parallel.healpix_sharded import make_sharded_healpix_pad
from dlwpbench_tpu.parallel.mesh import make_mesh
from dlwpbench_tpu.training import trainer as jtr
from dlwpbench_tpu_torch import train, weights
from dlwpbench_tpu_torch.data.dataset import WindowedWeatherDataset as TDataset
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.training import trainer as ttr
from dlwpbench_tpu_torch.training.losses import latitude_weights

MESH_RANKS, TRAIN_RANKS = 4, 2
EXCHANGE_TOL = dict(rtol=1e-6, atol=1e-6)
LR = 1e-3
PARAM_ATOL = LR / 100
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 2e-3
SWIN_CFG = dict(img_height=4, img_width=8, constant_channels=2, prescribed_channels=1,
                prognostic_channels=2, embed_dim=8, depths=(2, 2), num_heads=(2, 2),
                use_flash_attention=False)
# the U-Net on latitude rows: 16 rows over 4 ranks, 4 a rank at the top
# level and 2 at the second (`benchmark_scaling --spatial`)
UNET_KW = dict(constant_channels=1, prescribed_channels=1, prognostic_channels=2,
               hidden_channels=(8, 16), context_size=1)
GC_KW = dict(input_height=8, input_width=16, constant_channels=0, prescribed_channels=0,
             prognostic_channels=2, mesh_level=1, processor_layers=2, hidden_dim=16,
             context_size=1)
HPX = [(4, 1), (4, 2)]
MH_BATCH, MH_ACCUM = 3, 2  # rows each host reads a step, accumulation
TINY = ["model=swintransformer", "data=synthetic", "data.height=4", "data.width=8",
        "data.n_time=200", "model.embed_dim=8", "model.depths=[2,2]",
        "model.num_heads=[2,2]", "training.epochs=1", "training.batch_size=8",
        "validation.batch_size=4", "verbose=false"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread in this process, the spawns' fixtures
    included: the ranks already keep cores busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- launch


@pytest.mark.parametrize("env, want", [
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "RANK": "3", "WORLD_SIZE": "8"},
     {"init_method": "tcp://10.0.0.1:29500", "world_size": 8, "rank": 3}),
    ({"MASTER_ADDR": "h", "RANK": "0", "WORLD_SIZE": "2"},  # the reference's default port
     {"init_method": "tcp://h:12355", "world_size": 2, "rank": 0}),
    ({"SLURM_PROCID": "5", "SLURM_NPROCS": "16", "SLURM_LAUNCH_NODE_IPADDR": "10.1.2.3"},
     {"init_method": "tcp://10.1.2.3:12355", "world_size": 16, "rank": 5}),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4", "MASTER_ADDR": "n0",
      "MASTER_PORT": "2222"},
     {"init_method": "tcp://n0:2222", "world_size": 4, "rank": 1}),
    ({"SLURM_PROCID": "5", "SLURM_NPROCS": "16", "SLURM_LAUNCH_NODE_IPADDR": "10.1.2.3",
      "DLWPBENCH_AUTO_DISTRIBUTED": "0"}, None),
    ({}, None),
], ids=["torch", "torch-default-port", "slurm", "openmpi", "auto-off", "none"])
def test_spec_parsing(env, want):
    assert launch.discover_spec(env) == want


def test_initialize_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize() is False
    assert launch.initialize({"init_method": "tcp://h:1", "world_size": 1, "rank": 0}) is False
    assert launch.host_info() == (0, 1)
    assert launch.rank_device(torch.device("cpu")) == torch.device("cpu")


def test_data_parallel_without_a_job_raises(tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train.main([*TINY, f"run_dir={tmp_path}", "training.data_parallel=2", "--device", "cpu"])


# ---------------------------------------------------------------- host sharding


def _ds_arrays(T=120, noise=0.05):
    rng = np.random.default_rng(0)
    prog = np.cumsum(0.3 * rng.standard_normal((T, 2, 4, 8)), axis=0).astype(np.float32)
    pres = rng.standard_normal((T, 1, 4, 8)).astype(np.float32)
    const = rng.standard_normal((2, 4, 8)).astype(np.float32)
    return dict(prognostic=prog, prescribed=pres, constants=const, sequence_length=3,
                context_size=1, noise=noise, seed=4)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("n_hosts", [2, 3])
def test_host_sharded_batches_match_jax_bit_for_bit(n_hosts, drop_last):
    """Two epochs of every host's shuffled shard, noise on: equal to
    JAX's array for array, and the hosts' windows together the epoch."""
    for host in range(n_hosts):
        jds, tds = JDataset(**_ds_arrays()), TDataset(**_ds_arrays())
        for epoch in range(2):
            kw = dict(shuffle=True, drop_last=drop_last, host_id=host, n_hosts=n_hosts,
                      epoch=epoch)
            jb, tb = list(jds.batches(7, **kw)), list(tds.batches(7, **kw))
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            if drop_last:
                assert all(b[2].shape[0] == 7 for b in tb)
    ds = TDataset(**_ds_arrays(noise=0.0))
    firsts = [np.concatenate([b[2][:, 0] for b in ds.batches(4, host_id=h, n_hosts=n_hosts)])
              for h in range(n_hosts)]
    whole = np.concatenate([b[2][:, 0] for b in ds.batches(4)])
    usable = len(ds) - len(ds) % n_hosts
    got = np.stack([f[i] for i in range(usable // n_hosts) for f in firsts])
    np.testing.assert_array_equal(got, whole[:usable])


def test_host_sharding_errors_match_jax():
    for ds in (JDataset(**_ds_arrays()), TDataset(**_ds_arrays())):
        with pytest.raises(ValueError, match="epoch"):
            next(ds.batches(4, shuffle=True, host_id=0, n_hosts=2))
        with pytest.raises(ValueError, match="host_id"):
            next(ds.batches(4, host_id=2, n_hosts=2))


# ---------------------------------------------------------------- mesh suite


def _jax_mesh(n=MESH_RANKS):
    return make_mesh(n, data=1, x=n)


def _halo_refs(inp):
    mesh = _jax_mesh()
    x = jnp.asarray(inp["halo_x"])
    ref = {}
    for p in (1, 2):
        f = shard_map(lambda a, p=p: sharded_cylinder_pad(a, p, "x"), mesh=mesh,
                      in_specs=P("x", None), out_specs=P("x", None))
        xs = jax.device_put(x, NamedSharding(mesh, P("x", None)))
        H, W = x.shape
        ref[p] = (np.asarray(jax.jit(f)(xs)).reshape(MESH_RANKS, H // MESH_RANKS + 2 * p,
                                                     W + 2 * p),
                  np.asarray(cylinder_pad(x, p)))
    k = jnp.asarray(inp["halo_kernel"])

    def conv_valid(yp):
        H, W = yp.shape[-2] - 2, yp.shape[-1] - 2
        return sum(k[i, j] * yp[..., i:i + H, j:j + W] for i in range(3) for j in range(3))

    ref["grad"] = np.asarray(jax.grad(
        lambda a: (conv_valid(cylinder_pad(a, 1)) ** 2).sum())(jnp.asarray(inp["halo_grad_x"])))
    return ref


@pytest.mark.parametrize("graph", ["random-2", "random-3", "healpix-4"])
def test_partition_plan_equals_jax(graph):
    """The port's copy of `partition_graph_nodewise` against JAX's, array
    for array: a random bipartite graph on 2 and 3 ranks, the nside-4
    HEALPix pad's gather (pad 2) on 4."""
    from dlwpbench_tpu_torch.grids.healpix import build_pad_indices
    from dlwpbench_tpu_torch.parallel import graph_partition as tgp

    kind, n = graph.split("-")
    if kind == "random":
        rng = np.random.default_rng(int(n))
        args = (rng.integers(0, 37, 200), rng.integers(0, 29, 200), 37, 29, int(n))
    else:
        idx, _ = build_pad_indices(4, 2)
        args = (idx.reshape(-1), np.repeat(np.arange(idx.size // 2), 2), 12 * 16,
                idx.size // 2, 4)
    want, got = partition_graph_nodewise(*args), tgp.partition_graph_nodewise(*args)
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            assert g == w, field


def _graph_refs(g):
    part = partition_graph_nodewise(g["src"], g["dst"], g["n_src"], g["n_dst"], MESH_RANKS)
    sc, dc = part.src_chunk, part.dst_chunk
    F = g["src_feat"].shape[1]
    src_pad = np.zeros((MESH_RANKS * sc, F), np.float32)
    src_pad[: g["n_src"]] = g["src_feat"]
    ef = np.zeros((MESH_RANKS, part.n_edges_max, F), np.float32)
    for r in range(MESH_RANKS):
        e_ids = np.nonzero((g["dst"] // dc) == r)[0]
        ef[r, : len(e_ids)] = g["edge_feat"][e_ids]
    f = shard_map(lambda s_, e_: partitioned_message_passing(part, s_, e_[0], "x")[None],
                  mesh=_jax_mesh(), in_specs=(P("x", None), P("x", None, None)),
                  out_specs=P("x", None, None))
    blocks = np.asarray(jax.jit(f)(jnp.asarray(src_pad), jnp.asarray(ef)))

    def loss(src, edge):
        msgs = src[g["src"]] * edge
        return (jax.ops.segment_sum(msgs, g["dst"], num_segments=g["n_dst"]) * g["weight"]).sum()

    dsrc, dedge = jax.grad(loss, argnums=(0, 1))(jnp.asarray(g["src_feat"]),
                                                  jnp.asarray(g["edge_feat"]))
    return blocks, np.asarray(dsrc), np.asarray(dedge)


@pytest.fixture(scope="module")
def mesh_suite(tmp_path_factory):
    """(JAX references, each rank's results) of the "mesh" suite."""
    rng = np.random.default_rng(0)
    inp = {"halo_x": rng.standard_normal((16, 24)).astype(np.float32),
           "halo_grad_x": np.random.default_rng(6).standard_normal((16, 24)).astype(np.float32),
           "halo_kernel": (np.arange(9, dtype=np.float32).reshape(3, 3) / 10.0)}
    g_rng = np.random.default_rng(0)
    n_src, n_dst, E, F = 37, 29, 200, 8
    inp["graph"] = dict(src=g_rng.integers(0, n_src, E), dst=g_rng.integers(0, n_dst, E),
                        n_src=n_src, n_dst=n_dst,
                        src_feat=g_rng.standard_normal((n_src, F)).astype(np.float32),
                        edge_feat=g_rng.standard_normal((E, F)).astype(np.float32),
                        weight=g_rng.standard_normal((n_dst, F)).astype(np.float32))
    inp["hpx"] = {}
    for nside, pad in HPX:
        inp["hpx"][(nside, pad)] = (
            rng.standard_normal((12, nside, nside, 3)).astype(np.float32),
            rng.standard_normal((12, nside + 2 * pad, nside + 2 * pad, 3)).astype(np.float32))
    jmodel = jgc.GraphCastNet(**GC_KW)
    prog = np.random.default_rng(13).standard_normal((2, 3, 2, 8, 16)).astype(np.float32)
    prog4 = np.random.default_rng(21).standard_normal((1, 4, 2, 8, 16)).astype(np.float32)
    params = perturbed(np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), None, None, prog)),
                       3)
    target = np.random.default_rng(17).standard_normal((2, 2, 2, 8, 16)).astype(np.float32)
    inp["graphcast"] = dict(kw=GC_KW, params=weights.flatten_tree(params["params"]),
                            prog=prog, prog4=prog4, target=target, lr=LR)
    urng = np.random.default_rng(23)
    uarrays = [urng.standard_normal(s).astype(np.float32)
               for s in ((2, 1, 1, 16, 24), (2, 3, 1, 16, 24), (2, 3, 2, 16, 24))]
    juinit = perturbed(np_tree(jax.jit(junet.UNet(**UNET_KW).init)(jax.random.PRNGKey(2),
                                                                     *uarrays)), 4)
    inp["unet"] = dict(kw=UNET_KW, params=weights.flatten_tree(juinit["params"]),
                       arrays=uarrays)
    results = start_ranks("mesh", MESH_RANKS, str(tmp_path_factory.mktemp("mesh")), inp)

    # the references while the ranks run
    ref = {"halo": _halo_refs(inp), "graph": _graph_refs(inp["graph"]), "hpx": {}}
    for (nside, pad), (x, w) in inp["hpx"].items():
        oracle = lambda a, pad=pad: jnp.moveaxis(  # noqa: E731
            healpix_pad(jnp.moveaxis(a, -1, 0), pad), 0, -1)
        jsharded = make_sharded_healpix_pad(_jax_mesh(), nside, pad)
        ref["hpx"][(nside, pad)] = (
            np.asarray(oracle(jnp.asarray(x))), np.asarray(jax.jit(jsharded)(jnp.asarray(x))),
            np.asarray(jax.grad(lambda a: (oracle(a) * w).sum())(jnp.asarray(x))))

    def loss(p):
        out = jmodel.apply(p, None, None, prog)
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref["graphcast"] = (np.asarray(out), weights.flatten_tree(np_tree(grads["params"])))
    ref["graphcast_rollout"] = np.asarray(jax.jit(jmodel.apply)(params, None, None, prog4))

    def uloss(p):
        out = junet.UNet(**UNET_KW).apply(p, *uarrays)
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(uloss, has_aux=True))(juinit)
    ref["unet"] = (np.asarray(out), weights.flatten_tree(np_tree(grads["params"])))
    return ref, results()


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_rejoin_is_idempotent(mesh_suite, rank):
    res = mesh_suite[1][rank]
    assert res["rejoined"] is True and res["host_info"] == (rank, MESH_RANKS)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
@pytest.mark.parametrize("p", [0, 1, 2])
def test_halo_matches_jax(mesh_suite, p, rank):
    """Each rank's padded block: JAX's sharded block and the rows of the
    single-device `cylinder_pad`; pad 0 is the identity."""
    ref, results = mesh_suite
    got = results[rank][f"halo_{p}"]
    hl = 16 // MESH_RANKS
    if p == 0:
        x = np.random.default_rng(0).standard_normal((16, 24)).astype(np.float32)
        np.testing.assert_array_equal(got, x[rank * hl:(rank + 1) * hl])
        return
    jblocks, want = ref["halo"][p]
    np.testing.assert_allclose(got, jblocks[rank], **EXCHANGE_TOL)
    np.testing.assert_allclose(got, want[rank * hl: rank * hl + hl + 2 * p], **EXCHANGE_TOL)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_halo_gradient_matches_jax(mesh_suite, rank):
    """The mirrored exchange adds each neighbour's cotangent into the rows
    it was sent: each rank's block of JAX's single-device gradient."""
    ref, results = mesh_suite
    hl = 16 // MESH_RANKS
    np.testing.assert_allclose(results[rank]["halo_grad"],
                               ref["halo"]["grad"][rank * hl:(rank + 1) * hl], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_partitioned_message_passing_matches_jax(mesh_suite, rank):
    ref, results = mesh_suite
    blocks, dsrc, dedge = ref["graph"]
    res = results[rank]
    np.testing.assert_allclose(res["graph_local"], blocks[rank], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["graph_dsrc"], dsrc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["graph_dedge"], dedge, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
@pytest.mark.parametrize("nside, pad", HPX)
def test_sharded_healpix_pad_matches_jax(mesh_suite, nside, pad, rank):
    """The padded faces on every rank: JAX's 4-way sharded pad and its
    single-device `healpix_pad`; the gradient of a weighted sum against
    the single-device pad's."""
    ref, results = mesh_suite
    oracle, jsharded, dx = ref["hpx"][(nside, pad)]
    out, grad = results[rank][f"hpx_{nside}_{pad}"]
    np.testing.assert_allclose(out, jsharded, **EXCHANGE_TOL)
    np.testing.assert_allclose(out, oracle, **EXCHANGE_TOL)
    np.testing.assert_allclose(grad, dx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_partitioned_graphcast_matches_jax_single_device(mesh_suite, rank):
    """GraphCastNet(spmd_mesh=...) on 4 ranks: the 2-step rollout and every
    parameter gradient (summed over the ranks) on every rank."""
    ref, results = mesh_suite
    out, grads = results[rank]["graphcast"]
    j_out, j_grads = ref["graphcast"]
    assert_grads_close({"out": out}, {"out": j_out}, MODEL_TOL)
    assert_grads_close(grads, j_grads, MODEL_TOL)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_partitioned_graphcast_closed_loop_rollout(mesh_suite, rank):
    """Three closed-loop steps with the features partitioned inside each
    step (JAX `:750`): the whole forecast on every rank."""
    ref, results = mesh_suite
    assert_grads_close({"out": results[rank]["graphcast_rollout"]},
                       {"out": ref["graphcast_rollout"]}, MODEL_TOL)


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_trainer_sums_partitioned_graphcast_gradients(mesh_suite, rank):
    """One trainer step of the partitioned GraphCast on 4 ranks (the
    trainer sums each rank's share of the gradients over the partition)
    against the same step of the single-device model: the loss, the
    gradients it stepped on and every parameter."""
    results = mesh_suite[1][rank]
    loss, grads, params = results["graphcast_step_part"]
    s_loss, s_grads, s_params = results["graphcast_step_single"]
    np.testing.assert_allclose(loss, s_loss, rtol=LOSS_RTOL)
    assert_grads_close(grads, s_grads, MODEL_TOL)
    assert params.keys() == s_params.keys()
    for path, g in params.items():
        assert np.abs(g - s_params[path]).max() <= PARAM_ATOL, path


@pytest.mark.parametrize("rank", range(MESH_RANKS))
def test_row_sharded_unet_matches_jax_single_device(mesh_suite, rank):
    """The U-Net with `spmd_mesh` on 4 ranks, each on its latitude rows (the
    3x3 convs' rows above and below by the halo exchange, the poles zero):
    the rollout and every parameter gradient summed over the ranks against
    JAX's single-device U-Net, which JAX's GSPMD-sharded one equals; a row
    count that does not stay even at every level raises."""
    ref, results = mesh_suite
    out, grads = results[rank]["unet"]
    assert out.shape == ref["unet"][0].shape == (2, 2, 2, 16, 24)
    assert_grads_close({"out": out}, {"out": ref["unet"][0]}, MODEL_TOL)
    assert_grads_close(grads, ref["unet"][1], MODEL_TOL)
    msg = results[rank]["unet_rows"]
    assert msg is not None and "even at every level" in msg


# ---------------------------------------------------------------- train suite


def _lat_w():
    h = SWIN_CFG["img_height"]
    return latitude_weights(np.linspace(-90 + 180 / h / 2, 90 - 180 / h / 2, h))[:, None]


def _trainer_arrays(T=64):
    return {**_ds_arrays(T, noise=0.0)}


DP_CASES = [  # (name, accumulation, batch, compute dtype, remat)
    ("fp32", 1, 4, None, False),
    ("accum2-rem-remat", 2, 5, None, True),
    ("ragged", 1, 5, None, False),
    ("bf16", 1, 4, "bfloat16", False),
]


def _jax_state(jt, init):
    """JAX's train state on the shared init: the trainer's own `init`
    would compile and run the model's init only to be overwritten."""
    return jtr.TrainState(params=init, opt_state=jt.tx.init(init), ema_params=None)


def _jax_steps(jt, jstate, batches, lr):
    params, opt_state, losses = jstate.params, jstate.opt_state, []
    for b in batches:
        params, opt_state, loss = jt._train_step(
            params, opt_state, *(None if x is None else jnp.asarray(x) for x in b),
            jnp.float32(lr), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, weights.flatten_tree(np_tree(params["params"]))


DIFF_CFG = dict(constant_channels=2, prescribed_channels=1, prognostic_channels=2,
                hidden_channels=(8, 16), context_size=2, norm=True, sampler="mean")
# (accumulation, rows each host reads): data_parallel, a batch of 4 read by
# every rank in two micro-batches of 2, each split over the 2 ranks;
# multihost, a batch of 2 on each host, the global batch of 4 in one go
DIFF_CASES = {"data_parallel": (2, 4), "multihost": (1, 2)}


def _diffusion_cases():
    """For each of DIFF_CASES: a diffusion step's JAX trainer, weights,
    global batch and key, and the port's inputs (the same weights, JAX's
    own k and noise, the batch each rank reads)."""
    arrays = {**_trainer_arrays(24), "context_size": 2, "sequence_length": 3}
    jmodel = jmu.DiffModernUNet(**DIFF_CFG)
    c, p, g, t = next(iter(JDataset(**arrays).batches(1)))
    params = jax_ref.init(jmodel, jax.random.PRNGKey(0), c, p[:, :2], g[:, :2], t,
                          jnp.zeros((1,), jnp.int32), method=jmodel.single_forward)
    params = perturbed(np_tree(params), 0)
    refs, inputs = {}, {}
    for name, (accum, rows) in DIFF_CASES.items():
        jt = jtr.Trainer(jmodel, learning_rate=LR, epochs=5, gradient_accumulation_steps=accum,
                         training_type="diffusion", num_refinement_steps=1000, seed=1234)
        if name == "multihost":
            local = [next(TDataset(**arrays).batches(rows, host_id=h, n_hosts=TRAIN_RANKS))
                     for h in range(TRAIN_RANKS)]
            batch = _concat(local)
        else:
            local = batch = next(TDataset(**arrays).batches(rows))
        key = jax.random.PRNGKey(11)
        kk, kn = jax.random.split(key)  # JAX's draws (`trainer.py:184-187`)
        k = int(jax.random.randint(kk, (), 0, 1000))
        micro = (batch[3].shape[0] // accum, *batch[3].shape[1:])
        noise = np.array(jax.random.normal(kn, micro, jnp.float32))
        refs[name] = (jt, params, batch, key)
        inputs[name] = dict(cfg=DIFF_CFG, seed=1234, init=weights.flatten_tree(params["params"]),
                            accum=accum, batch=local, k=k, noise=noise)
    return refs, inputs


def _concat(host_batches):
    """The global batch of the hosts' batches, host after host."""
    return tuple(None if parts[0] is None else np.concatenate(parts)
                 for parts in zip(*host_batches))


def _diffusion_ref(jt, params, batch, key, lr):
    """JAX's loss, parameters and EMA (d 0.995) after the step."""
    new, _, loss = jt._train_step(params, jt.tx.init(params),
                                  *(jnp.asarray(x) for x in batch), jnp.float32(lr), key)
    d = 0.995
    flat0 = weights.flatten_tree(params["params"])
    flat1 = weights.flatten_tree(np_tree(new["params"]))
    return float(loss), flat1, {n: flat0[n] * d + flat1[n] * (1.0 - d) for n in flat0}


@pytest.fixture(scope="module")
def train_suite(tmp_path_factory):
    """(JAX references, each rank's results, the single-process CLI run)."""
    work = tmp_path_factory.mktemp("train")
    lr = ttr.cosine_lr(0, LR, 5)
    jmodel = jswin.SwinTransformer(**SWIN_CFG)
    jds = JDataset(**_trainer_arrays())
    init = np_tree(jax_ref.init(jmodel, jax.random.PRNGKey(0), *next(iter(jds.batches(1)))[:3]))
    inp = {"swin_cfg": SWIN_CFG, "swin_init": weights.flatten_tree(init["params"]),
           "lr": LR, "step_lr": lr, "lat_w": _lat_w(), "dp_cases": [], "dir": str(work),
           "tiny": TINY}
    cases = []
    for name, accum, batch, dtype, remat in DP_CASES:
        batches = list(TDataset(**_trainer_arrays()).batches(batch))[:3]
        cases.append((name, accum, dtype, batches))
        inp["dp_cases"].append(dict(name=name, accum=accum, dtype=dtype, remat=remat,
                                    batches=batches))
    # multihost: each host's first batches of epoch 0, the global batch
    # theirs concatenated (JAX's global array, host after host)
    hosts = [list(TDataset(**_trainer_arrays()).batches(MH_BATCH, shuffle=True, host_id=h,
                                                         n_hosts=TRAIN_RANKS, epoch=0))[:3]
             for h in range(TRAIN_RANKS)]
    inp["multihost"] = dict(accum=MH_ACCUM, batches=hosts)
    diffusion, inp["diffusion"] = _diffusion_cases()
    results = start_ranks("train", TRAIN_RANKS, str(work), inp, timeout=420)

    # the references while the ranks run
    ref = {}
    for name, accum, dtype, batches in cases:
        jt = jtr.Trainer(jmodel, learning_rate=LR, epochs=5, gradient_accumulation_steps=accum,
                         lat_weights=_lat_w(), compute_dtype=dtype)
        ref[name] = _jax_steps(jt, _jax_state(jt, init), batches, lr)
    jt = jtr.Trainer(jmodel, learning_rate=LR, epochs=5, gradient_accumulation_steps=MH_ACCUM,
                     lat_weights=_lat_w())
    ref["multihost"] = _jax_steps(jt, _jax_state(jt, init), [_concat(b) for b in zip(*hosts)],
                                  lr)
    for name, case in diffusion.items():
        ref[f"diffusion_{name}"] = _diffusion_ref(*case, lr)
    single = train.main([*TINY, f"run_dir={work / 'single'}", "training.save_model=false",
                         "--device", "cpu"])
    return ref, results(), single, work


@pytest.mark.parametrize("rank", range(TRAIN_RANKS))
@pytest.mark.parametrize("case", [c[0] for c in DP_CASES])
def test_data_parallel_steps_match_jax_global_batch(train_suite, case, rank):
    """Three steps on 2 ranks, each taking its rows of the global batch:
    the losses and every parameter against JAX's single-device trainer,
    and the two ranks' parameters equal bit for bit."""
    ref, results, _, _ = train_suite
    losses, params = results[rank][f"{case}_dp"]
    j_losses, j_params = ref[case]
    assert params.keys() == j_params.keys()
    if case == "bf16":
        # the port's single-process bf16 steps on the same global batches:
        # the first step's loss (one forward on equal parameters) within
        # fp32 rounding, the later ones within LOSS_RTOL of bf16
        s_losses, _ = results[rank][f"{case}_single"]
        np.testing.assert_allclose(losses, j_losses, rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(losses, s_losses, rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(losses[0], s_losses[0], rtol=LOSS_RTOL)
        assert all(g.dtype == np.float32 for g in params.values())  # fp32 masters
    else:
        np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
        for path, g in params.items():
            assert np.abs(g - j_params[path]).max() <= PARAM_ATOL, path
    other = results[1 - rank][f"{case}_dp"][1]
    for path, g in params.items():
        np.testing.assert_array_equal(g, other[path])


@pytest.mark.parametrize("rank", range(TRAIN_RANKS))
def test_data_parallel_diffusion_step_and_ema_match_jax(train_suite, rank):
    """k and the global micro-batch's noise the same on both ranks, each
    keeping its rows: JAX's loss, parameters and EMA after one step."""
    ref, results, _, _ = train_suite
    loss, params, ema = results[rank]["diffusion_data_parallel"]
    j_loss, j_params, j_ema = ref["diffusion_data_parallel"]
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    for got, want in ((params, j_params), (ema, j_ema)):
        assert got.keys() == want.keys()
        for path, g in got.items():
            assert np.abs(g - want[path]).max() <= PARAM_ATOL, path


@pytest.mark.parametrize("rank", range(TRAIN_RANKS))
def test_multihost_steps_match_jax_global_batch(train_suite, rank):
    """Three multihost steps on 2 ranks, each reading its own shard of the
    epoch (3 rows, two micro-batches and a remainder row): the losses and
    every parameter against JAX's trainer on the hosts' batches
    concatenated (6 rows, two micro-batches of 3), the ranks equal bit
    for bit."""
    ref, results, _, _ = train_suite
    losses, params = results[rank]["multihost"]
    j_losses, j_params = ref["multihost"]
    assert params.keys() == j_params.keys()
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    for path, g in params.items():
        assert np.abs(g - j_params[path]).max() <= PARAM_ATOL, path
        np.testing.assert_array_equal(g, results[1 - rank]["multihost"][1][path])


@pytest.mark.parametrize("rank", range(TRAIN_RANKS))
def test_multihost_diffusion_step_and_ema_match_jax(train_suite, rank):
    """A multihost diffusion step, each rank its host's 2 rows and its rows
    of the global batch's noise: JAX's loss, parameters and EMA on the
    global batch of 4."""
    ref, results, _, _ = train_suite
    loss, params, ema = results[rank]["diffusion_multihost"]
    j_loss, j_params, j_ema = ref["diffusion_multihost"]
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    for got, want in ((params, j_params), (ema, j_ema)):
        assert got.keys() == want.keys()
        for path, g in got.items():
            assert np.abs(g - want[path]).max() <= PARAM_ATOL, path


def test_cli_multihost_writes_on_rank_0_and_resumes_on_both(train_suite):
    """`training.multihost=true` on 2 ranks: each rank its shard of the
    epoch, the same parameters on both, one writer (one metrics line an
    epoch), and `continue_training` resuming epoch 1 -> 2 on both."""
    _, results, _, work = train_suite
    first = [r["cli_first"] for r in results]
    assert [f["rank"] for f in first] == [0, 1]
    assert all(f["ckpt"] for f in first)
    assert first[0]["train_loss"] == first[1]["train_loss"]
    for n, p in first[0]["params"].items():
        np.testing.assert_array_equal(p, first[1]["params"][n])
    metrics = (work / "multihost" / "metrics.jsonl").read_text().splitlines()
    assert len(metrics) == 2  # epoch 1, then the resumed epoch 2: rank 0 alone
    resumed = [r["cli_resumed"] for r in results]
    assert [r["epoch"] for r in resumed] == [2, 2]
    assert len(resumed[0]["train_loss"]) == 1
    assert resumed[0]["train_loss"] == resumed[1]["train_loss"]


@pytest.mark.parametrize("rank", range(TRAIN_RANKS))
def test_cli_data_parallel_matches_single_process(train_suite, rank):
    """`training.data_parallel=2` inside a 2-rank job against the same CLI
    run in one process: the epoch's loss, validation and parameters."""
    _, results, single, _ = train_suite
    dp = results[rank]["cli_dp"]
    np.testing.assert_allclose(dp["train_loss"], single["train_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(dp["val_loss"], single["val_loss"], rtol=LOSS_RTOL)
    for n, p in single["state"].model.named_parameters():
        assert np.abs(dp["params"][n] - p.detach().numpy()).max() <= PARAM_ATOL, n
