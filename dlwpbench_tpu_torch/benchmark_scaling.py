"""Data-parallel scaling of a U-Net train step over the port's ranks
(counterpart of `scripts/benchmark_scaling.py`).

The U-Net (4 constant + 1 prescribed + 8 prognostic channels, hidden
(64, 128, 256), context 1) on 32 x 64, trained with MSE and AdamW at lr
1e-3 (optax's default weight decay 1e-4, no clipping) through the port's
`Trainer` with a data group: every rank reads the same global batch
(`--per-device-batch` rows a rank, `--steps` + 1 time steps), computes
its rows and sums the gradients in one flat all-reduce, JAX's mean over
the global batch.  Each rank count of `--devices` is its own job of that
many ranks (`launch.spawn_local`); one untimed step, then the median of 5
steps on the host clock, each ending in a read of the loss.

    python -m dlwpbench_tpu_torch.benchmark_scaling --devices 1,2,4 [--backend nccl]
    python -m dlwpbench_tpu_torch.benchmark_scaling --devices 1,2 --backend gloo   # one card
    python -m dlwpbench_tpu_torch.benchmark_scaling --device cpu --devices 1,2
    python -m dlwpbench_tpu_torch.benchmark_scaling --devices 1,2,4 --spatial 2

Writes `--out` (default `outputs/scaling.json`): a row per rank count with JAX's keys
(`mesh`, `step_s`, `gridpoints_per_s`, `efficiency` against the first
count's per-rank rate) and `device`, `power_limit_w`, `backend`,
`ranks_per_card` and the attention kernels' launches; where ranks share a
card, its `note` says so (their times are a shared card's, as JAX's
virtual-mesh times are a shared host's).  A count that fails is recorded
as `{"error": ...}`.  `--spatial N` puts N ranks on the mesh's `x` for
each count that N divides: each group of them runs the U-Net on its
latitude rows (the halo exchange between neighbours, `UNet(spmd_mesh=)`),
the groups split the batch (per-device batch x count / N rows), as JAX
shards rows over "x" and the batch over "data"; a count whose rows do not
stay even at every level over N ranks fails its row.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

MODULE = "dlwpbench_tpu_torch.benchmark_scaling"
T_CHANNELS = (4, 1, 8)  # constant, prescribed, prognostic
GRID = (32, 64)
HIDDEN = (64, 128, 256)
TIMED = 5


def measure(r, per_device_batch: int, steps: int, spatial: int = 1) -> dict:
    """This rank's share of the step: the row of its job.  With `spatial`
    ranks on the mesh's `x` (when the job's rank count is a multiple), each
    group of them runs the U-Net on its latitude rows (`spmd_mesh`) and the
    groups split the batch, JAX's `make_mesh(n, x=spatial)`."""
    from dlwpbench_tpu_torch.models.unet import UNet
    from dlwpbench_tpu_torch.ops import kernel_launches, launches_since
    from dlwpbench_tpu_torch.parallel import launch
    from dlwpbench_tpu_torch.training.trainer import Trainer

    T, (Cc, Cp, Cq), (H, W) = steps + 1, T_CHANNELS, GRID
    x_dim = spatial if r.world % spatial == 0 and r.world >= spatial else 1
    B = per_device_batch * (r.world // x_dim)
    rng = np.random.default_rng(0)  # JAX's draws, in its order
    const = rng.standard_normal((B, 1, Cc, H, W)).astype(np.float32)
    pres = rng.standard_normal((B, T, Cp, H, W)).astype(np.float32)
    prog = rng.standard_normal((B, T, Cq, H, W)).astype(np.float32)
    target = rng.standard_normal((B, T - 1, Cq, H, W)).astype(np.float32)
    batch = tuple(torch.from_numpy(a).to(r.device) for a in (const, pres, prog, target))
    mesh = launch.global_mesh(data=r.world // x_dim, x=x_dim) if r.world > 1 else None
    model = UNet(constant_channels=Cc, prescribed_channels=Cp, prognostic_channels=Cq,
                 hidden_channels=HIDDEN, context_size=1,
                 spmd_mesh=mesh if x_dim > 1 else None).to(r.device)
    data = r.world // x_dim > 1
    trainer = Trainer(model, learning_rate=1e-3, weight_decay=1e-4, clip_gradients=False,
                      data_group=launch.axis(mesh, "data")[0] if data else None)
    state = trainer.init()
    before = kernel_launches()
    float(trainer.train_step(state, batch, 1e-3))  # the first call
    times = []
    for _ in range(TIMED):
        r.barrier()
        t0 = time.perf_counter()
        float(trainer.train_step(state, batch, 1e-3))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {"mesh": f"{r.world // x_dim}x{x_dim}", "step_s": dt,
            "gridpoints_per_s": B * steps * H * W / dt,
            "global_batch": B, "attention_launches": launches_since(before), **r.record()}


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.parallel import entry, launch
    from dlwpbench_tpu_torch.utils.device import entry_device, no_tf32

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default=None, help="comma list of rank counts, e.g. 1,2,4,8")
    ap.add_argument("--spatial", type=int, default=1, help="spatial shard dim")
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default="outputs/scaling.json")
    ap.add_argument("--row-out", default=None, help=argparse.SUPPRESS)  # a rank's row file
    entry.add_flags(ap)
    args = ap.parse_args(argv)
    if launch.discover_spec() is not None:  # one rank of one count's job
        r = entry.start_or_join(MODULE, args, argv, 0, "benchmark_scaling")
        try:
            no_tf32()
            row = measure(r, args.per_device_batch, args.steps, args.spatial)
        finally:
            entry.leave()
        if r.rank == 0:
            with open(args.row_out, "w") as f:
                json.dump(row, f)
        return row

    device = entry_device(args.device, "benchmark_scaling")
    counts = ([int(d) for d in args.devices.split(",")] if args.devices else
              [d for d in (1, 2, 4, 8) if d <= max(1, torch.cuda.device_count())]
              if device.type == "cuda" else [1, 2])
    passed = list(sys.argv[1:] if argv is None else argv)
    results, base = {}, None
    with tempfile.TemporaryDirectory(prefix="benchmark_scaling_") as work:
        for nd in counts:
            backend = launch.entry_backend(args.backend, device, nd)
            row_out = os.path.join(work, f"row{nd}.json")
            try:
                launch.spawn_local(MODULE, nd, [*passed, "--row-out", row_out], backend)
                with open(row_out) as f:
                    row = json.load(f)
            except RuntimeError as e:
                results[nd] = {"error": str(e)[-2000:]}
                print(f"{nd} ranks: FAILED {str(e)[-400:]}", flush=True)
                continue
            if base is None:
                base = row["gridpoints_per_s"] / nd
            row["efficiency"] = row["gridpoints_per_s"] / (nd * base)
            if (row["ranks_per_card"] or 1) > 1:
                row["note"] = (f"{row['ranks_per_card']} ranks share each card over "
                               f"{row['backend']}: the step times are a shared card's, not "
                               "scaling across cards. " + row.get("note", ""))
            results[nd] = row
            print(f"{nd} ranks (mesh {row['mesh']}, {row['backend']}, {row['device']}): "
                  f"{row['step_s'] * 1e3:8.1f} ms/step, {row['gridpoints_per_s'] / 1e6:8.3f} M "
                  f"gp/s, efficiency {row['efficiency']:.2%}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    return json.loads(json.dumps(results))


if __name__ == "__main__":
    main()
