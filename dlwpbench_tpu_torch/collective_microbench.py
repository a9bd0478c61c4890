"""The collectives' bytes and times on the port's ranks (counterpart of
`scripts/collective_microbench.py`).

Two checks of the scaling model's communication terms
(`scaling_model.py`):

1. **Byte audit**: one forward and backward of the distributed spherical
   convolution (`parallel/spectral_dist.py::make_dist_spherical_conv`,
   SFNO's hot layer) with the loss sum(conv(x, w)^2), its collectives
   tallied on each rank (`launch.count_bytes`: the bytes of each call's
   result on the rank, as JAX sums the result shapes of the per-device
   HLO).  The model claims four transposes (the SHT, its inverse and their
   adjoints), each moving this rank's share of the complex spectrum [C,
   nlat, m_pad] at 8 bytes an element: `4 * C * nlat * m_pad * 8 // P`,
   m_pad the order count padded to a multiple of P.
2. **Timing fit**: `launch.all_to_all_single` of 1, 4, 16 and 64 MB (the
   global array [P^2, n/P^2], each rank its P rows) timed over 5 calls
   after one untimed call, the card synchronised, and fitted as
   t = a + bytes / bw with its R^2.

    python -m dlwpbench_tpu_torch.collective_microbench --devices 2 --backend gloo
    python -m dlwpbench_tpu_torch.collective_microbench --devices 4   # NCCL, 4 cards
    python -m dlwpbench_tpu_torch.collective_microbench --device cpu --devices 2

Writes `--out` (default `outputs/collective_microbench.json`) with JAX's
keys (`devices`, `channels`, `grid`, `timing`), its `hlo_audit` as
`byte_audit` (the port audits no HLO), and `device`, `power_limit_w`,
`backend`, `ranks_per_card` (and a `note` where gloo stages the card's
tensors through the host), keeping the sections other entries own
(`schedule_audit`).  On gloo with CUDA tensors the bandwidth is the host
staging's, not NVLink's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

MODULE = "dlwpbench_tpu_torch.collective_microbench"
PAYLOADS_MB = (1, 4, 16, 64)
REPS = 5


def byte_audit(C: int, nlat: int, nlon: int, mesh, device) -> dict:
    """The collectives of one forward and backward of the distributed
    spherical convolution on this rank, against the model's claim."""
    from dlwpbench_tpu_torch.ops.sht import sht_tables
    from dlwpbench_tpu_torch.parallel import launch
    from dlwpbench_tpu_torch.parallel.fft import padded
    from dlwpbench_tpu_torch.parallel.spectral_dist import make_dist_spherical_conv

    P = mesh.size()
    t = sht_tables(nlat, nlon, grid="equiangular")
    rng = np.random.default_rng(0)  # JAX's draws, in its order
    x = torch.from_numpy(rng.standard_normal((1, C, nlat, nlon)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((C, C, t.lmax, 2)) @ np.array([1, 1j]))
                         .astype(np.complex64))
    x, w = x.to(device).requires_grad_(), w.to(device)
    conv = make_dist_spherical_conv(mesh, t)
    with launch.count_bytes() as tally:
        (conv(x, w) ** 2).sum().backward()
    m_pad = padded(t.mmax, P)
    claim = 4 * (1 * C * nlat * m_pad * 8) // P
    a2a = tally.bytes.get("all-to-all", 0)
    return {"collective_bytes_per_device": dict(tally.bytes),
            "collective_calls_per_device": dict(tally.calls),
            "all_to_all_bytes_per_device": a2a,
            "model_claim_bytes_per_device": claim,
            "ratio_vs_model": a2a / claim if claim else None}


def time_all_to_all(r, group, device) -> dict:
    """`all_to_all_single` on each payload, timed on every rank; the rows
    and the fit t = a + bytes / bw (JAX's least squares)."""
    from dlwpbench_tpu_torch.parallel import launch
    from dlwpbench_tpu_torch.utils.device import sync

    P = r.world
    rng = np.random.default_rng(1)
    rows = []
    for mb in PAYLOADS_MB:
        n = mb * (1 << 20) // 4
        # the global [P^2, n/P^2]; this rank's P rows (the tiled all_to_all
        # needs the local split axis divisible by P)
        arr = rng.standard_normal((P * P, n // (P * P))).astype(np.float32)
        local = torch.from_numpy(arr[r.rank * P:(r.rank + 1) * P]).to(device)
        launch.all_to_all_single(local, group)
        sync(device)
        r.barrier()
        t0 = time.perf_counter()
        for _ in range(REPS):
            launch.all_to_all_single(local, group)
        sync(device)
        dt = (time.perf_counter() - t0) / REPS
        rows.append({"payload_mb": mb, "time_s": dt})
        if r.rank == 0:
            print(f"all_to_all {mb:3d} MB: {dt * 1e3:8.3f} ms", flush=True)
    xs = np.array([row["payload_mb"] * (1 << 20) for row in rows], float)
    ys = np.array([row["time_s"] for row in rows], float)
    A = np.stack([np.ones_like(xs), xs], axis=1)
    coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
    ss_res = float(((ys - A @ coef) ** 2).sum())
    ss_tot = float(((ys - ys.mean()) ** 2).sum())
    return {"rows": rows, "latency_s": float(coef[0]),
            "effective_bw_gbps": float(1.0 / coef[1] / 1e9) if coef[1] > 0 else None,
            "r2_linear_in_bytes": 1 - ss_res / ss_tot if ss_tot > 0 else None}


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.ops import kernel_launches, launches_since
    from dlwpbench_tpu_torch.parallel import entry, launch
    from dlwpbench_tpu_torch.utils.device import no_tf32

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="ranks")
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--nlat", type=int, default=32)
    ap.add_argument("--nlon", type=int, default=64)
    ap.add_argument("--out", default="outputs/collective_microbench.json")
    entry.add_flags(ap)
    args = ap.parse_args(argv)

    r = entry.start_or_join(MODULE, args, argv, args.devices, "collective_microbench")
    if r is None:
        return entry.read_json(args.out)
    try:
        no_tf32()
        mesh = launch.global_mesh(data=1, x=r.world)
        group = launch.axis(mesh, "x")[0]
        C, nlat, nlon = args.channels, args.nlat, args.nlon
        before = kernel_launches()
        audit = byte_audit(C, nlat, nlon, mesh, r.device)
        audit["all_to_all_bytes_by_rank"] = r.gather(audit["all_to_all_bytes_per_device"])
        timing = time_all_to_all(r, group, r.device)
        launches = launches_since(before)
    finally:
        entry.leave()
    results = {"devices": r.world, "channels": C, "grid": f"{nlat}x{nlon}",
               "byte_audit": audit, "timing": timing, **r.record(),
               "attention_launches": launches}
    if r.rank == 0:
        a2a, claim = audit["all_to_all_bytes_per_device"], audit["model_claim_bytes_per_device"]
        print(f"byte audit (per rank): all-to-all {a2a / 1e6:.4f} MB vs model {claim / 1e6:.4f} "
              f"MB (ratio {audit['ratio_vs_model']:.4f}); every collective: "
              f"{ {k: v / 1e6 for k, v in audit['collective_bytes_per_device'].items()} } MB; "
              f"ranks {audit['all_to_all_bytes_by_rank']}", flush=True)
        bw = timing["effective_bw_gbps"]
        print(f"fit: latency {timing['latency_s'] * 1e3:.4f} ms, bw "
              f"{'n/a' if bw is None else f'{bw:.4f}'} GB/s ({r.backend}, {results['device']}), "
              f"R^2 {timing['r2_linear_in_bytes']}", flush=True)
        entry.merge_write(args.out, results)
        print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
