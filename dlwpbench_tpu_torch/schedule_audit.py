"""Which compute the port issues inside each collective's window
(counterpart of `scripts/schedule_audit.py`).

JAX's audit is structural: for each collective of the compiled HLO it
counts the dot-class instructions that are neither ancestors nor
descendants of it, the compute a latency-hiding scheduler could place in
its window.  The port has no compiler schedule: its collectives are
explicit calls, most of them blocking (on gloo every one stages through
the host).  So this audit reads the program as it was ISSUED, from a
`torch.profiler` trace of one call on each rank (`audit_events`):

- a collective's window runs from its post to its wait: an `Exchange`
  (`launch.py`) posts its sends and receives in one range and waits in
  another; every other collective blocks, its window empty;
- `independent_compute_ops`: the compute launches issued inside the
  window;
- `descendant_compute_ops`: the compute launches after the wait up to
  the next collective's wait (a blocking collective's wait is its call;
  a post does not end the count, as the ring posts the next round's
  exchange before the launch that reads this one's).  JAX follows the
  data; the profiler records no tensor identity on these events, so the
  count stands in for the launches that read the result;
- `overlapped_device_us`: the card's kernel time inside the window (from
  the post's start to the wait's end; copies and NCCL's kernels left
  out), None on the CPU.
Compute launches are the dot-class ATen operators (products and
convolutions, JAX's "dot" and "convolution") and the registered attention
operators (`dlwpbench_torch::*`, one launch each, whatever runs inside).

The programs are JAX's:
- ring attention's forward at B 2, H 4, N 512, D 32, one bias group, on
  each rank's operands (`shard_ring_operands` into `ring_window_attention`,
  the sharded-in, sharded-out program JAX compiles): each round posts its
  kv exchange before its flash forward (on the card the kernel of
  `ops/csrc/flash_window_attention.cu`), so each window is expected to
  hold one launch;
- the fused SFNO block stack (nlat 32, nlon 64, C 64, K 4, L 2),
  forward and backward on each rank's rows;
and `fused_step_time_s`, the stack's forward at K 1 and K 8 (CUDA events
on the card, the host clock on the CPU; JAX's
`fused_step_time_virtual_mesh_s`).

    python -m dlwpbench_tpu_torch.schedule_audit --devices 2 --backend gloo
    python -m dlwpbench_tpu_torch.schedule_audit --device cpu --devices 2

Merges its results into `--out` (default
`outputs/collective_microbench.json`) under `schedule_audit`, beside the
sections the microbench owns.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dlwpbench_tpu_torch.parallel.launch import RANGE_PREFIX

MODULE = "dlwpbench_tpu_torch.schedule_audit"
DOT_OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::addbmm",
                     "aten::mv", "aten::addmv", "aten::dot", "aten::vdot", "aten::convolution",
                     "aten::convolution_backward"})
NOT_COMPUTE_KERNELS = ("Memcpy", "Memset", "nccl", RANGE_PREFIX)
TIMING_REPS = 10


def is_compute(name: str) -> bool:
    return name in DOT_OPS or name.startswith("dlwpbench_torch::")


def _within(inner: dict, outer: dict) -> bool:
    return (inner is not outer and inner.get("thread") == outer.get("thread")
            and outer["start_us"] <= inner["start_us"] and inner["end_us"] <= outer["end_us"])


def audit_events(events, device_events=None) -> dict:
    """The overlap audit of one traced program.

    `events`: the host events in issue order, each a dict with `name`,
    `start_us`, `end_us` and optionally `thread`; collectives are the
    `launch.py` ranges
    (`dlwpbench.collective.<kind>`, an exchange's `.post` and `.wait`
    paired in order).  `device_events`: the card's kernels (`name`,
    `start_us`, `end_us`), or None where there is no card.  Returns JAX's
    summary keys and a row per collective."""
    colls = [e for e in events if e["name"].startswith(RANGE_PREFIX)]
    compute = [e for e in events if is_compute(e["name"])
               and not any(_within(e, c) for c in colls)]
    compute = [e for e in compute if not any(_within(e, o) for o in compute)]

    # each collective: (name, first event, last event), in issue order
    rows, open_posts = [], {}
    for e in colls:
        kind = e["name"][len(RANGE_PREFIX):]
        if kind.endswith(".post"):
            open_posts.setdefault(kind[:-5], []).append(e)
        elif kind.endswith(".wait"):
            post = open_posts[kind[:-5]].pop(0)
            rows.append((kind[:-5], post, e))
        else:
            rows.append((kind, e, e))
    rows.sort(key=lambda r: r[1]["start_us"])
    out = []
    for i, (kind, post, wait) in enumerate(rows):
        indep = [c for c in compute if post is not wait
                 and c["start_us"] >= post["end_us"] and c["end_us"] <= wait["start_us"]]
        nxt = min((r[2]["start_us"] for r in rows[i + 1:] if r[2]["start_us"] >= wait["end_us"]),
                  default=float("inf"))
        desc = [c for c in compute if wait["end_us"] <= c["start_us"] < nxt]
        overlap = None
        if device_events is not None:
            lo, hi = post["start_us"], wait["end_us"]
            overlap = sum(max(0.0, min(hi, d["end_us"]) - max(lo, d["start_us"]))
                          for d in device_events if not d["name"].startswith(NOT_COMPUTE_KERNELS))
        out.append({"name": kind, "independent_compute_ops": len(indep),
                    "descendant_compute_ops": len(desc), "overlapped_device_us": overlap})
    indep = [r["independent_compute_ops"] for r in out]
    overlaps = [r["overlapped_device_us"] for r in out if r["overlapped_device_us"] is not None]
    return {
        "n_collectives": len(out),
        "n_compute_ops": len(compute),
        "n_collectives_with_zero_overlap_window": sum(1 for n in indep if n == 0),
        "min_independent_compute": min(indep, default=None),
        "median_independent_compute": float(np.median(indep)) if indep else None,
        "overlapped_device_us": sum(overlaps) if device_events is not None else None,
        "collectives": out,
    }


def events_from_profile(prof) -> tuple[list, list | None]:
    """(host events in issue order, the card's kernels or None) of a
    `torch.profiler.profile`, as `audit_events` reads them."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.events():
        rec = {"name": e.name, "start_us": float(e.time_range.start),
               "end_us": float(e.time_range.end), "thread": e.thread}
        if e.device_type == DeviceType.CPU:
            host.append(rec)
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device.append(rec)
    host.sort(key=lambda e: (e["start_us"], -e["end_us"]))
    return host, (device if torch.cuda.is_available() and device else None)


def audit(program, device) -> dict:
    """`program()` once untraced, then once under the profiler; the audit
    of the traced call, with the attention launches of both calls."""
    from torch.profiler import ProfilerActivity, profile

    from dlwpbench_tpu_torch.ops import kernel_launches, launches_since
    from dlwpbench_tpu_torch.utils.device import sync

    before = kernel_launches()
    program()
    sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        program()
        sync(device)
    res = audit_events(*events_from_profile(prof))
    if device.type == "cuda" and res["overlapped_device_us"] is None:
        res["overlapped_device_us_note"] = "the trace holds no kernel of the card"
    res["attention_launches"] = launches_since(before)
    return res


def sfno_layers(rng, C: int, lmax: int, L: int, device) -> list:
    """JAX's `mk_layer` draws, in its order."""
    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    layers = []
    for _ in range(L):
        layers.append({"spec": f32(C, C, lmax, 2) / C,
                       "skip_k": f32(C, C) / np.float32(np.sqrt(C)),
                       "skip_b": torch.zeros(C),
                       "mlp1_k": f32(C, 2 * C) / np.float32(np.sqrt(C)),
                       "mlp1_b": torch.zeros(2 * C),
                       "mlp2_k": f32(2 * C, C) / np.float32(np.sqrt(2 * C)),
                       "mlp2_b": torch.zeros(C)})
    return [{k: v.to(device) for k, v in L_.items()} for L_ in layers]


def time_forward(fn, r, device) -> float:
    """Seconds of one `fn()` over TIMING_REPS calls after one untimed call:
    CUDA events on the card, the host clock on the CPU."""
    from dlwpbench_tpu_torch.utils.device import sync

    fn()
    sync(device)
    r.barrier()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / TIMING_REPS
    t0 = time.perf_counter()
    for _ in range(TIMING_REPS):
        fn()
    return (time.perf_counter() - t0) / TIMING_REPS


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.ops.sht import sht_tables
    from dlwpbench_tpu_torch.parallel import entry, launch
    from dlwpbench_tpu_torch.parallel.ring_attention import (
        ring_window_attention,
        shard_ring_operands,
    )
    from dlwpbench_tpu_torch.parallel.spectral_dist import dist_sfno_blocks
    from dlwpbench_tpu_torch.utils.device import no_tf32

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="ranks")
    ap.add_argument("--out", default="outputs/collective_microbench.json")
    entry.add_flags(ap)
    args = ap.parse_args(argv)

    r = entry.start_or_join(MODULE, args, argv, args.devices, "schedule_audit")
    if r is None:
        return entry.read_json(args.out)["schedule_audit"]
    dev = r.device
    try:
        no_tf32()
        mesh = launch.global_mesh(data=1, x=r.world)
        group = launch.axis(mesh, "x")[0]
        rng = np.random.default_rng(0)
        out = {}

        # ---- ring attention: forward at a swin-like geometry ----
        B, H, N, D, G = 2, 4, 512, 32, 1
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32))
                   for _ in range(3))
        bias = torch.from_numpy(rng.standard_normal((G, H, N, N)).astype(np.float32))
        local = [t.to(dev) for t in shard_ring_operands(q, k, v, bias, mesh)]

        def ring():
            with torch.no_grad():
                return ring_window_attention(*local, group)

        ring_res = audit(ring, dev)
        out["ring_attention"] = {"geometry": {"B": B, "H": H, "N": N, "D": D, "devices": r.world,
                                              "round_q": [B, H, N // r.world, D],
                                              "round_bias": [G, H, N // r.world, N // r.world]},
                                 **{k_: v_ for k_, v_ in ring_res.items() if k_ != "collectives"},
                                 "windows": ring_res["collectives"]}

        # ---- fused SFNO block stack: forward + backward ----
        nlat, nlon, C, K, L = 32, 64, 64, 4, 2
        t = sht_tables(nlat, nlon, grid="equiangular")
        x = rng.standard_normal((1, nlat, nlon, C)).astype(np.float32)
        layers = sfno_layers(rng, C, t.lmax, L, dev)
        rows = nlat // r.world
        x_local = torch.from_numpy(x[:, r.rank * rows:(r.rank + 1) * rows]).to(dev)

        def sfno():
            xl = x_local.clone().requires_grad_()
            (dist_sfno_blocks(xl, layers, t, group, pipeline_chunks=K) ** 2).sum().backward()

        sfno_res = audit(sfno, dev)
        out["fused_sfno"] = {"geometry": {"nlat": nlat, "nlon": nlon, "C": C, "chunks": K,
                                          "layers": L, "devices": r.world},
                             **{k_: v_ for k_, v_ in sfno_res.items() if k_ != "collectives"}}

        # ---- K=1 vs K=8 forward step time ----
        timings = {}
        for K_t in (1, 8):
            def fwd(K_t=K_t):
                with torch.no_grad():
                    return dist_sfno_blocks(x_local, layers, t, group, pipeline_chunks=K_t)

            timings[f"K{K_t}"] = time_forward(fwd, r, dev)
        out["fused_step_time_s"] = timings
        by_rank = r.gather({"ring": ring_res["n_collectives"], "sfno": sfno_res["n_collectives"]})
    finally:
        entry.leave()
    out["n_collectives_by_rank"] = by_rank
    out.update(r.record())
    out["note"] = (
        "Audit of the issued program, not a compiler's schedule: for each collective, the "
        "compute launches issued between its post and its wait (an exchange's window; a "
        "blocking collective has none) and, on the card, the device time of the kernels that "
        "ran inside that window (overlapped_device_us), from a torch.profiler trace of one "
        "call on each rank. " + out.get("note", ""))
    if r.rank == 0:
        for name in ("ring_attention", "fused_sfno"):
            s = out[name]
            print(f"{name}: {s['n_collectives']} collectives, {s['n_compute_ops']} compute "
                  f"launches, min independent compute {s['min_independent_compute']}, "
                  f"zero-window {s['n_collectives_with_zero_overlap_window']}, overlapped "
                  f"device us {s['overlapped_device_us']}, attention launches "
                  f"{ {k_: v_ for k_, v_ in s['attention_launches'].items() if v_} }",
                  flush=True)
        print(f"fused step ({out['device']}): {timings}", flush=True)
        entry.merge_write(args.out, {"schedule_audit": out})
        print(f"-> {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
