"""One rank of the port's multi-process tests (`tests/test_torch_parallel.py`,
`tests/test_torch_ring_attention.py`, `tests/test_torch_spectral_dist.py`),
the counterpart of `tests/_distributed_child.py`.

The parent computes the JAX references in its own process, writes the
inputs (numpy arrays, flax weights as flat dicts) to `<dir>/inputs.pkl`
and starts N copies of this script through `start_ranks`, each with the
torch-style variables (MASTER_ADDR, MASTER_PORT on a free port, RANK,
WORLD_SIZE).  Each rank joins a gloo group through
`parallel.launch.initialize`, runs every check of its suite on the CPU,
asserts that no JAX module was imported, and writes its results to
`<dir>/rank<r>.pkl` for the parent to hold against JAX.

    python tests/_torch_dist_child.py SUITE DIR  (SUITE: ring, mesh, train, spectral)
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDEZVOUS_S = 60  # a rendezvous that hangs fails its suite, not the test run


def start_ranks(suite: str, n: int, work_dir: str, inputs: dict, timeout: float = 300):
    """Write `inputs` and start `n` ranks of `suite` on a free port;
    returns a function that waits for them and returns each rank's results
    (raising with a failing rank's output), so the caller can compute its
    references while the ranks run."""
    with open(os.path.join(work_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, work_dir],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]

    def results() -> list:
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"{suite} rank {r} exited {p.returncode}:\n{out[-6000:]}"
        res = []
        for r in range(n):
            with open(os.path.join(work_dir, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        return res

    return results


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank gloo group in this process and its ("data", "x")
    `DeviceMesh`, the group destroyed on exit: the `spmd_mesh` branches
    run every exchange on one rank."""
    import torch.distributed as dist

    from dlwpbench_tpu_torch.parallel import launch

    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        yield launch.global_mesh(data=1, x=1)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the rank's side
# ----------------------------------------------------------------------


def _grads_flax(model):
    from dlwpbench_tpu_torch import weights

    return weights.flatten_tree(weights.to_flax_tree(
        model, {n: p.grad for n, p in model.named_parameters()}))


def _model_out_and_grads(model, params, prog):
    """The rollout and the flax-path gradients of mean(out^2)."""
    return _model_out_and_grads_of(model, params, None, None, prog)


def _model_out_and_grads_of(model, params, *arrays):
    """The rollout of (constants, prescribed, prognostic) `arrays` (None for
    an absent group) and the flax-path gradients of mean(out^2)."""
    import torch

    from dlwpbench_tpu_torch import weights

    from dlwpbench_tpu_torch.parallel import launch

    weights.load_flax_params(model, weights.unflatten_tree(params))
    out = model(*(None if a is None else torch.from_numpy(a) for a in arrays))
    (out ** 2).mean().backward()
    if model.partition_group is not None:  # each rank's nodes' share, summed
        launch.all_reduce_([p.grad for p in model.parameters()], model.partition_group)
    return out.detach().numpy(), _grads_flax(model)


def suite_ring(inp, mesh):
    """Ring attention on its own and inside the Swin and Pangu."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from dlwpbench_tpu_torch.models import pangu, swin
    from dlwpbench_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded,
        ring_window_attention,
        shard_ring_operands,
    )

    t = lambda a: torch.from_numpy(a)  # noqa: E731
    res = {}
    for name in ("plain", "grouped"):
        q, k, v, b = map(t, inp[name])
        res[name] = ring_attention_sharded(q, k, v, b, mesh, axis="x").numpy()
    # the local entry: this rank's operands, its rows of the output
    local = shard_ring_operands(*map(t, inp["plain"]), mesh, axis="x")
    res["local"] = ring_window_attention(*local, mesh.get_group("x")).numpy()
    mesh2d = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "h"))
    q, k, v, b = map(t, inp["2d"])
    res["2d"] = ring_attention_sharded(q, k, v, b, mesh2d, axis="x", head_axis="h").numpy()
    ops = [t(a).requires_grad_() for a in inp["grads"]]
    w = torch.cos(torch.arange(ops[0].shape[-1], dtype=torch.float32))
    (ring_attention_sharded(*ops, mesh, axis="x") * w).sum().backward()
    res["grads"] = [o.grad.numpy() for o in ops]
    res["swin"] = _model_out_and_grads(
        swin.SwinTransformer(**inp["swin_kw"], spmd_mesh=mesh, dist_axis="x"),
        inp["swin_params"], inp["swin_prog"])
    res["pangu"] = _model_out_and_grads(
        pangu.PanguWeather(**inp["pangu_kw"], use_flash_attention=True, spmd_mesh=mesh),
        inp["pangu_params"], inp["pangu_prog"])
    return res


def suite_mesh(inp, mesh):
    """The halo, partitioned message passing, the sharded HEALPix pad, the
    partitioned GraphCast and the U-Net on latitude rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlwpbench_tpu_torch import weights
    from dlwpbench_tpu_torch.models import graphcast, unet
    from dlwpbench_tpu_torch.parallel import graph_partition as gp
    from dlwpbench_tpu_torch.parallel import halo, healpix_sharded, launch
    from dlwpbench_tpu_torch.training import trainer as ttr

    r, n = dist.get_rank(), dist.get_world_size()
    res = {"rejoined": launch.initialize(), "host_info": launch.host_info()}

    # the halo: each rank's padded block, and d(sum of local valid-conv^2)
    for p in (0, 1, 2):
        x = torch.from_numpy(inp["halo_x"])
        hl = x.shape[0] // n
        res[f"halo_{p}"] = halo.sharded_cylinder_pad(x[r * hl:(r + 1) * hl], p).numpy()
    x = torch.from_numpy(inp["halo_grad_x"])
    hl = x.shape[0] // n
    xl = x[r * hl:(r + 1) * hl].clone().requires_grad_()
    kern = torch.from_numpy(inp["halo_kernel"])
    yp = halo.sharded_cylinder_pad(xl, 1)
    H, W = yp.shape[-2] - 2, yp.shape[-1] - 2
    y = sum(kern[i, j] * yp[..., i:i + H, j:j + W] for i in range(3) for j in range(3))
    (y ** 2).sum().backward()
    res["halo_grad"] = xl.grad.numpy()

    # partitioned message passing: the local sums, and gradients of a
    # weighted total of the gathered sums w.r.t. the replicated inputs
    g = inp["graph"]
    part = gp.partition_graph_nodewise(g["src"], g["dst"], g["n_src"], g["n_dst"], n)
    sc = part.src_chunk
    src_pad = np.zeros((n * sc, g["src_feat"].shape[1]), np.float32)
    src_pad[: g["n_src"]] = g["src_feat"]
    src = torch.from_numpy(src_pad).requires_grad_()
    ef = torch.from_numpy(g["edge_feat"]).requires_grad_()
    # the edges in the plan's rank-major slots, each rank its own
    ids, mask = torch.from_numpy(part.edge_ids.reshape(-1)), torch.from_numpy(part.edge_mask)
    ef_slots = launch.scatter_to_ranks(ef[ids] * mask.reshape(-1, 1), 0)
    local = gp.partitioned_message_passing(part, launch.scatter_to_ranks(src, 0), ef_slots)
    res["graph_local"] = local.detach().numpy()
    full = launch.gather_from_ranks(local, 0)[: g["n_dst"]]
    (full * torch.from_numpy(g["weight"])).sum().backward()
    res["graph_dsrc"], res["graph_dedge"] = src.grad[: g["n_src"]].numpy(), ef.grad.numpy()

    # the sharded HEALPix pad, forward and d(sum(out * w))
    for (nside, pad), (x, w) in inp["hpx"].items():
        xt = torch.from_numpy(x).requires_grad_()
        out = healpix_sharded.make_sharded_healpix_pad(mesh, nside, pad)(xt)
        (out * torch.from_numpy(w)).sum().backward()
        res[f"hpx_{nside}_{pad}"] = (out.detach().numpy(), xt.grad.numpy())

    # the partitioned GraphCast: rollout and gradients, then an in/out rollout
    gc = inp["graphcast"]
    res["graphcast"] = _model_out_and_grads(
        graphcast.GraphCastNet(**gc["kw"], spmd_mesh=mesh), gc["params"], gc["prog"])
    model = graphcast.GraphCastNet(**gc["kw"], spmd_mesh=mesh)
    weights.load_flax_params(model, weights.unflatten_tree(gc["params"]))
    with torch.no_grad():
        res["graphcast_rollout"] = model(None, None, torch.from_numpy(gc["prog4"])).numpy()

    # the U-Net on latitude rows; 12 rows do not stay even over 4 ranks
    u = inp["unet"]
    res["unet"] = _model_out_and_grads_of(unet.UNet(**u["kw"], spmd_mesh=mesh), u["params"],
                                          *u["arrays"])
    try:
        unet.UNet(**u["kw"], spmd_mesh=mesh)(*(torch.from_numpy(a[..., :12, :])
                                               for a in u["arrays"]))
        res["unet_rows"] = None
    except ValueError as e:
        res["unet_rows"] = str(e)

    # a trainer step of the partitioned GraphCast (the trainer sums its
    # gradients over the partition) and of the single-device one
    batch = (None, None, torch.from_numpy(gc["prog"]), torch.from_numpy(gc["target"]))
    for key, kw in (("part", {"spmd_mesh": mesh}), ("single", {})):
        tt = ttr.Trainer(graphcast.GraphCastNet(**gc["kw"], **kw), learning_rate=gc["lr"],
                         epochs=5, clip_gradients=False)
        st = tt.init(params=weights.unflatten_tree(gc["params"]))
        loss = tt.train_step(st, batch, gc["lr"]).item()
        res[f"graphcast_step_{key}"] = (loss, _grads_flax(st.model),
                                        weights.flatten_tree(weights.to_flax_tree(st.model)))
    return res


def _swin_trainer(inp, group, **kw):
    from dlwpbench_tpu_torch import weights
    from dlwpbench_tpu_torch.models import swin
    from dlwpbench_tpu_torch.training import trainer as ttr

    model = swin.SwinTransformer(**inp["swin_cfg"], remat=kw.pop("remat", False))
    tt = ttr.Trainer(model, learning_rate=inp["lr"], epochs=5, lat_weights=inp["lat_w"],
                     data_group=group, **kw)
    return tt, tt.init(params=weights.unflatten_tree(inp["swin_init"]))


def suite_train(inp, mesh):
    """Data-parallel steps against the global batch, diffusion with its
    EMA, and the train CLI under multihost and data_parallel."""
    import torch
    import torch.distributed as dist

    from dlwpbench_tpu_torch import train, weights
    from dlwpbench_tpu_torch.models import modern_unet
    from dlwpbench_tpu_torch.training import trainer as ttr

    group = mesh.get_group("data")
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}
    for case in inp["dp_cases"]:
        name, accum, dtype, remat = case["name"], case["accum"], case["dtype"], case["remat"]
        runs = {"dp": group} if dtype is None else {"dp": group, "single": None}
        for key, grp in runs.items():
            tt, st = _swin_trainer(inp, grp, gradient_accumulation_steps=accum,
                                   compute_dtype=dtype, remat=remat)
            losses = [tt.train_step(st, tt._to_device(b), inp["step_lr"]).item()
                      for b in case["batches"]]
            res[f"{name}_{key}"] = (losses, weights.flatten_tree(weights.to_flax_tree(st.model)))

    # multihost: each rank its own shard's batches, the global batch both
    mh = inp["multihost"]
    tt, st = _swin_trainer(inp, group, gradient_accumulation_steps=mh["accum"], host_id=rank,
                           n_hosts=world)
    losses = [tt.train_step(st, tt._to_device(b), inp["step_lr"]).item()
              for b in mh["batches"][rank]]
    res["multihost"] = (losses, weights.flatten_tree(weights.to_flax_tree(st.model)))

    for name, d in inp["diffusion"].items():  # data_parallel, then multihost
        hosts = (rank, world) if name == "multihost" else (0, 1)
        model = modern_unet.DiffModernUNet(**d["cfg"])
        tt = ttr.Trainer(model, learning_rate=inp["lr"], epochs=5,
                         gradient_accumulation_steps=d["accum"], training_type="diffusion",
                         num_refinement_steps=1000, seed=d["seed"], data_group=group,
                         host_id=hosts[0], n_hosts=hosts[1])
        st = tt.init(params=weights.unflatten_tree(d["init"]))
        batch = d["batch"][rank] if name == "multihost" else d["batch"]
        loss = tt.train_step(st, tt._to_device(batch), inp["step_lr"], k=d["k"],
                             noise=torch.from_numpy(d["noise"]))
        tt._update_ema(st)
        res[f"diffusion_{name}"] = (loss.item(),
                                    weights.flatten_tree(weights.to_flax_tree(st.model)),
                                    weights.flatten_tree(weights.to_flax_tree(model, st.ema)))

    # the CLI: multihost for one epoch, then continue_training to epoch 2
    run_dir = os.path.join(inp["dir"], "multihost")
    argv = [*inp["tiny"], f"run_dir={run_dir}", "training.multihost=true"]
    first = train.main([*argv, "--device", "cpu"])
    dist.barrier()
    ckpt = os.path.join(run_dir, "checkpoints", "swin_last.ckpt")
    res["cli_first"] = {"rank": first["rank"], "ckpt": os.path.exists(ckpt),
                        "train_loss": first["train_loss"],
                        "params": {n: p.detach().numpy().copy() for n, p
                                   in first["state"].model.named_parameters()}}
    dist.barrier()
    again = train.main([*argv, "training.epochs=2", "training.continue_training=true",
                        "--device", "cpu"])
    res["cli_resumed"] = {"epoch": again["state"].epoch, "train_loss": again["train_loss"]}

    # training.data_parallel=2 inside the job: the global batch split
    dp = train.main([*inp["tiny"], f"run_dir={os.path.join(inp['dir'], 'dp')}",
                     "training.data_parallel=2", "training.save_model=false", "--device", "cpu"])
    res["cli_dp"] = {"train_loss": dp["train_loss"], "val_loss": dp["val_loss"],
                     "params": {n: p.detach().numpy().copy() for n, p
                                in dp["state"].model.named_parameters()}}
    return res


def suite_spectral(inp, mesh):
    """The distributed rFFT2 and SHT, the spectral layers and the models
    with `spmd_mesh` (`tests/test_torch_spectral_dist.py`); weight
    gradients are each rank's share until summed over the mesh.  Then the
    analysis entries' audits on these ranks: the spherical conv's byte
    tally and the ring's schedule audit."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from dlwpbench_tpu_torch import weights
    from dlwpbench_tpu_torch.models import fourcastnet, sfno
    from dlwpbench_tpu_torch.ops.sht import sht_tables
    from dlwpbench_tpu_torch.ops.spectral import AFNO2DFilter
    from dlwpbench_tpu_torch.parallel import fft, launch, sht_dist
    from dlwpbench_tpu_torch.parallel import spectral_dist as sd
    from dlwpbench_tpu_torch.parallel.ring_attention import (
        ring_window_attention,
        shard_ring_operands,
    )
    from dlwpbench_tpu_torch.training import trainer as ttr

    t = torch.from_numpy
    group = mesh.get_group("x")
    res = {}

    def leaf(a):
        return t(a).clone().requires_grad_()

    def summed(grads, grp=group):  # every rank's share of the weight gradients
        launch.all_reduce_(grads, grp)
        return [g.numpy() for g in grads]

    # the rFFT2: the padded spectrum and the round trip, 2D and batched
    fwd, inv = fft.make_dist_rfft2(mesh)
    X = fwd(t(inp["fft_x"]))
    res["fft"] = (X.numpy(), inv(X, inp["fft_x"].shape[-1]).numpy())
    res["fft_batched"] = inv(fwd(t(inp["fft_xb"])), inp["fft_xb"].shape[-1]).numpy()

    # the SHT on both grids; channel chunks, bf16 exchanges, gradients
    for grid in ("legendre-gauss", "equiangular"):
        tab = sht_tables(16, 32, grid=grid)
        fwd, inv = sht_dist.make_dist_sht(mesh, tab)
        a = fwd(t(inp["sht_x"]))
        res[f"sht_{grid}"] = (a.numpy(), inv(a).numpy())
    tab = sht_tables(16, 32)
    for k, cd in ((1, None), (2, None), (3, None), (8, None), (2, torch.bfloat16)):
        fwd, inv = sht_dist.make_dist_sht(mesh, tab, pipeline_chunks=k, comm_dtype=cd)
        a = fwd(t(inp["sht_xc"]))
        res[f"sht_chunks_{k}_{'bf16' if cd else 'fp32'}"] = (a.numpy(), inv(a).numpy())
    for key, x, k in (("sht_grad", inp["sht_xg"], 1), ("sht_grad_c1", inp["sht_xc"], 1),
                      ("sht_grad_c3", inp["sht_xc"], 3)):
        x = leaf(x)
        a = sht_dist.make_dist_sht(mesh, tab, pipeline_chunks=k)[0](x)
        (a.abs() ** 2).sum().backward()
        res[key] = x.grad.numpy()

    # the spherical convolution: plain and pipelined, the weight's gradient
    for key in ("conv", "conv_piped"):
        c = inp[key]
        x, w = t(c["x"]), leaf(c["w"])
        y = sd.make_dist_spherical_conv(mesh, tab, pipeline_chunks=c["chunks"])(
            x, torch.complex(w[..., 0], w[..., 1]))
        (y ** 2).sum().backward()
        res[key] = (y.detach().numpy(), summed([w.grad])[0])

    # the AFNO filter: the function, and the layer with spmd_mesh
    c = inp["afno"]
    ws = {n: leaf(c[n]) for n in ("w1", "b1", "w2", "b2")}
    f = sd.make_dist_afno_filter(mesh, hard_thresholding_fraction=0.7)
    res["afno_fn"] = f(t(c["x"]), *ws.values()).detach().numpy()
    layer = AFNO2DFilter(8, 4, hard_thresholding_fraction=0.7, spmd_mesh=mesh)
    weights.load_flax_params(layer, c["params"])
    y = layer(t(c["x"]))
    (y ** 2).sum().backward()
    res["afno_layer"] = (y.detach().numpy(), dict(zip(
        ("w1", "b1", "w2", "b2"), summed([p.grad for p in (layer.w1, layer.b1, layer.w2,
                                                             layer.b2)]))))

    # the fused block stack, 1D and 2D: outputs, bf16 exchanges, gradients
    mesh2d = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "c"))
    fz = inp["fused"]
    x = t(fz["x"])
    layers = [{k: t(v) for k, v in L.items()} for L in fz["layers"]]
    for k in (1, 3, 6):
        res[f"fused_{k}"] = sd.make_dist_sfno_blocks(mesh, tab, pipeline_chunks=k)(
            x, layers).numpy()
    res["fused_bf16"] = sd.make_dist_sfno_blocks(mesh, tab, pipeline_chunks=3,
                                                 comm_dtype=torch.bfloat16)(x, layers).numpy()
    for k in (1, 3):
        res[f"fused2d_{k}"] = sd.make_dist_sfno_blocks_2d(mesh2d, tab, pipeline_chunks=k)(
            x, layers).numpy()
    for key, make, grp in (("fused_grad", lambda: sd.make_dist_sfno_blocks(
            mesh, tab, pipeline_chunks=3), group), ("fused2d_grad", lambda: sd.
            make_dist_sfno_blocks_2d(mesh2d, tab, pipeline_chunks=3), None)):
        xg = leaf(fz["x"])
        lg = [{k: leaf(v) for k, v in fz["layers"][0].items()}]
        (make()(xg, lg) ** 2).sum().backward()
        names = sorted(lg[0])
        res[key] = (xg.grad.numpy(), dict(zip(names, summed([lg[0][n].grad for n in names],
                                                            grp))))

    # the models with spmd_mesh: rollouts and summed gradients
    for key in ("sfno", "sfno_fused_4", "sfno_fused_1", "fourcastnet", "fourcastnetv2"):
        m = inp[key]
        cls = sfno.SFNO2DModule if key.startswith("sfno") else fourcastnet.FourCastNet
        model = cls(**m["kw"], spmd_mesh=mesh)
        res[key] = _model_out_and_grads(model, m["params"], m["prog"])
        if key == "sfno_fused_4":
            res["fused_tree"] = weights.flatten_tree(weights.to_flax_tree(model))

    # a trainer step of the meshed SFNO (the trainer sums its gradients
    # over the partition) and of the single-device one
    m = inp["sfno"]
    batch = (None, None, t(m["prog"]), t(m["target"]))
    for key, kw in (("part", {"spmd_mesh": mesh}), ("single", {})):
        tt = ttr.Trainer(sfno.SFNO2DModule(**m["kw"], **kw), learning_rate=m["lr"], epochs=5,
                         clip_gradients=False)
        st = tt.init(params=weights.unflatten_tree(m["params"]))
        loss = tt.train_step(st, batch, m["lr"]).item()
        res[f"sfno_step_{key}"] = (loss, _grads_flax(st.model),
                                   weights.flatten_tree(weights.to_flax_tree(st.model)))

    # the byte tally of the spherical conv's forward and backward (the
    # microbench's audit; the parent holds it against JAX's HLO bytes), and
    # the schedule audit's ring on these ranks
    from dlwpbench_tpu_torch import collective_microbench, schedule_audit

    res["bytes"] = {shape: collective_microbench.byte_audit(*shape, mesh, "cpu")
                    for shape in inp["byte_shapes"]}
    ring_ops = shard_ring_operands(*(t(a) for a in inp["ring_audit"]), mesh)

    def ring():
        with torch.no_grad():
            return ring_window_attention(*ring_ops, group)

    res["ring_audit"] = schedule_audit.audit(ring, torch.device("cpu"))

    # shapes that do not split over the ranks raise
    res["raises"] = {}
    for name, build in (
            ("sht_rows", lambda: sht_dist.make_dist_sht(mesh, sht_tables(6, 12))[0](
                torch.zeros(6, 12))),
            ("fourcastnet_rows", lambda: fourcastnet.FourCastNet(
                img_height=6, img_width=8, embed_dim=8, depth=1, num_blocks=4,
                spmd_mesh=mesh)(None, None, torch.zeros(1, 2, 1, 6, 8))),
            ("sfno_rows", lambda: sfno.SFNO2DModule(
                constant_channels=0, prescribed_channels=0, prognostic_channels=1,
                num_layers=1, embed_dim=4, height=6, width=12, spmd_mesh=mesh)(
                    None, None, torch.zeros(1, 2, 1, 6, 12)))):
        try:
            build()
            res["raises"][name] = None
        except ValueError as e:
            res["raises"][name] = str(e)
    return res


SUITES = {"ring": suite_ring, "mesh": suite_mesh, "train": suite_train,
          "spectral": suite_spectral}


def main(suite: str, work_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from dlwpbench_tpu_torch.parallel import launch

    with open(os.path.join(work_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    assert launch.initialize(backend="gloo", timeout_s=RENDEZVOUS_S)
    rank, world = launch.host_info()
    mesh = launch.global_mesh(data=world, x=1) if suite == "train" else launch.global_mesh(
        data=1, x=world)
    res = SUITES[suite](inp, mesh)
    for name in ("jax", "jaxlib", "flax", "dlwpbench_tpu"):
        assert name not in sys.modules, f"{name} was imported"
    with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
