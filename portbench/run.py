"""Runs one cell of the port's benchmark on the card and prints its result.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`dlwpbench_tpu_torch`).
The run loads and warms up (its set-up, `setup_s`), measures for
`--seconds`, checks what the window produced against the plain reference
(`correct`), and prints one JSON line last on standard output: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a profiled stretch after the window and from the
window's spans.  The numbers compared with the reference are printed
with their limits as the last lines on standard error and under `checks`,
the last key of the line.

It exits non-zero and prints no result when the card is missing or there
are fewer cards than the cell asks for, and when JAX or the JAX package
has been loaded by the end of the run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "dlwpbench_tpu")
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIRS = {  # fixed, inside the checkout: only a checkout's first run builds
    "TORCH_EXTENSIONS_DIR": os.path.join(CHECKOUT, "build", "portbench", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(CHECKOUT, "build", "portbench", "triton"),
    "CUDA_CACHE_PATH": os.path.join(CHECKOUT, "build", "portbench", "nv"),
}


def seconds_since_process_start() -> float:
    """Seconds from this process's start to now (the kernel's start time of
    the process, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def count_work(cell) -> tuple[int, list]:
    """The benchmark's own count of one unit of the cell's work (a training
    step's rollout, or a forecast batch), from its reference on meta
    tensors at the cell's shapes: (forward FLOPs, attention calls)."""
    import torch

    from portbench import work
    from portbench.reference import reference_class

    cfg, tr = cell.config, cell.traffic
    B, T = int(tr["batch_size"]), int(tr["sequence_length"])
    d = cfg["data"]
    H, W = int(d["height"]), int(d["width"])
    cc, cp, cq = (int(d[k]) for k in ("constant_channels", "prescribed_channels",
                                      "prognostic_channels"))
    with torch.device("meta"):
        ref = reference_class(cfg["family"])(**cfg["model"])
        inputs = (torch.empty(B, 1, cc, H, W) if cc else None,
                  torch.empty(B, T, cp, H, W) if cp else None,
                  torch.empty(B, T, cq, H, W))
    return work.forward_work(ref, inputs)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, seconds_before: float = 0.0,
             root: str | None = None) -> dict:
    """Set up, measure, trace and check `cell` on `device`; the result's
    line as a dict.  `seconds_before`: what the process spent before this
    call, counted into `setup_s`; `root`: the benchmark folder whose
    metric readers to use."""
    import torch

    from portbench import cells, check, work
    from portbench.kinds.common import Context

    t_call = time.perf_counter()
    ctx = Context(config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device)
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    out = kind.run(ctx)
    setup_s = seconds_before + (out.t_window_start - t_call)
    phases = {"start": seconds_before, **out.phases}
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.2f} s, window {out.window_s:.2f} s "
          f"({out.units} units); " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()),
          file=sys.stderr)
    correct, checks = check.verdict(out.numbers, cell.limits)
    correct = correct and out.failed == 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
                "count": int(cell.chips), "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.units), "failed": int(out.failed)}
    if not trace:
        tp = cell.traffic["throughput"]
        result["metrics"] = {
            tp["name"]: {"value": out.rows / out.window_s, "unit": tp["unit"]},
            "peak_mem": {"value": out.memory_peak_bytes / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:  # the work counts serve only the per-layer metrics: after the window and the check
        flops, calls = count_work(cell)
        record = {"kind": out.kind, "window_s": out.window_s, "units": out.units,
                  "summary": out.summary, "dtype": cell.config["dtype"],
                  "peaks": work.peaks(name), "forward_flops": flops, "attention_calls": calls,
                  **out.record}
        metrics = {}
        for mname, reader in cells.metric_readers(root or cells.ROOT).items():
            value = reader.read(record)
            if value is not None:
                metrics[mname] = {"value": float(value), "unit": reader.UNIT}
        result["metrics"] = metrics
        if out.summary is not None:
            dev_info.update(busy_s=out.summary.busy_s, window_s=out.summary.window_s)
            result["breakdown"] = {"device_ops": out.summary.device_ops,
                                   "idle_gaps": out.summary.idle_gaps}
    result["device"] = dev_info
    result["checks"] = checks
    return result


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=False)
        return proc.stdout.strip() or proc.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell: portbench/workloads/<name>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    importlib.import_module("dlwpbench_tpu_torch")  # the program under test, in this checkout
    from portbench import cells

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    for var, path in CACHE_DIRS.items():
        os.environ[var] = path
    print(f"portbench: card {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      seconds_before=seconds_since_process_start())
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for cname, c in result["checks"].items():
        print(f"check {cname}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
