"""Profile one zoo model: a `torch.profiler` trace, step percentiles and a
FLOP count (counterpart of `scripts/profile_model.py:24-163`).

    python -m dlwpbench_tpu_torch.profile_model --model fourcastnet [--batch 8]
        [--seq 15] [--grid 32x64] [--steps 8] [--train] [--dtype bfloat16]
        [--out-dir outputs/profile/<model>_<mode>] [--device cpu]

Writes a TensorBoard-loadable trace (`*.pt.trace.json`, through
`utils/profiling.trace`) and `profile.json` into `--out-dir`:
`StepTimer`'s `steps`, `mean_s`, `median_s`, `p90_s`, `total_s` over
`--steps` steps after a warm-up step (each step ends in a synchronisation
of the card); `flops_per_step`, counted by
`torch.utils.flop_counter.FlopCounterMode` over one more step, and
`achieved_tflops` = flops_per_step / median_s / 1e12;
`attention_flops_per_step`, the part of the count in the attention
kernels' registered operators (each has a FLOP formula); on the card
`max_memory_allocated_mb`, the peak of the timed steps, where JAX reports
XLA's memory plan.  The count is an eager one over every rollout step, so
JAX's factor for a `scan` body counted once (its `trips`) has no
counterpart.  It counts the products and convolutions
(`torch.utils.flop_counter`'s registry), not the elementwise ops XLA's
cost model counts too.

`--train` profiles the trainer's step (`training.trainer.Trainer`: the
MSE loss, the backward, AdamW at 1e-3 with optax's default weight decay
1e-4, no clipping) with remat on where the model has it, `--dtype
bfloat16` its bf16 compute; without it the rollout under `no_grad`.  The
inputs are drawn from a numpy seed, the weights from the model's own seed.
`--device` is the card unless it is `cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from dlwpbench_tpu_torch.benchmark_models import model_zoo
from dlwpbench_tpu_torch.utils.device import entry_device, no_tf32, sync

ATTENTION_OPS = ("flash_window_attention", "window_attention_qkv", "packed_window_attention")


def attention_flops(counts: dict) -> int:
    """The FLOPs a `FlopCounterMode`'s `get_flop_counts()` gives the
    attention kernels' registered operators (`dlwpbench_torch::*`)."""
    return sum(n for op, n in counts.get("Global", {}).items()
               if str(op).startswith(tuple(f"dlwpbench_torch.{a}" for a in ATTENTION_OPS)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="unet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=15)
    ap.add_argument("--grid", default="32x64")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="profile the trainer's step (remat on) instead of the rollout")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--dtype", default=None, choices=(None, "bfloat16"),
                    help="bf16 compute in the train step")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    from torch.utils.flop_counter import FlopCounterMode

    from dlwpbench_tpu_torch.training.trainer import Trainer
    from dlwpbench_tpu_torch.utils import profiling

    device = entry_device(args.device, "profile_model")
    no_tf32()
    card = device.type == "cuda"
    B, T = args.batch, args.seq
    H, W = (int(x) for x in args.grid.split("x"))
    Cc, Cp, Cq = 4, 1, 8
    zoo = model_zoo(B, H, W, Cc, Cp, Cq)
    if args.model not in zoo:
        raise SystemExit(f"profile_model: unknown --model {args.model!r}; one of {sorted(zoo)}")
    model = zoo[args.model]().to(device)

    r = np.random.default_rng(0)
    const, pres, prog = (torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(device)
                         for s in ((B, 1, Cc, H, W), (B, T, Cp, H, W), (B, T, Cq, H, W)))

    if args.train:
        if hasattr(model, "remat"):
            model.remat = True
        trainer = Trainer(model, learning_rate=1e-3, weight_decay=1e-4, clip_gradients=False,
                          compute_dtype=args.dtype)
        state = trainer.init()
        with torch.no_grad():  # the target: the rollout's steps of the prognostic field
            steps_out = model(const, pres, prog).shape[1]
        batch = (const, pres, prog, prog[:, T - steps_out:])

        def run():
            trainer.train_step(state, batch, 1e-3)
            sync(device)
    else:
        model.eval()

        def run():
            with torch.no_grad():
                model(const, pres, prog)
            sync(device)

    run()  # kernel builds and first-call work outside the trace

    out_dir = args.out_dir or os.path.join(
        "outputs", "profile", args.model + ("_train" if args.train else "_infer"))
    os.makedirs(out_dir, exist_ok=True)
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    timer = profiling.StepTimer(skip=0, sync=card)
    with profiling.trace(out_dir):
        for _ in range(args.steps):
            with timer, profiling.span(f"{args.model}_step"):
                run()
    summary = timer.summary()
    info = {"model": args.model, "batch": B, "seq": T, "grid": args.grid,
            "mode": "train" if args.train else "infer", "dtype": args.dtype or "float32",
            "device": torch.cuda.get_device_name(device) if card else "cpu", **summary}
    if card:
        info["max_memory_allocated_mb"] = torch.cuda.max_memory_allocated(device) / 1e6

    counter = FlopCounterMode(display=False)
    with counter:
        run()
    info["flops_per_step"] = float(counter.get_total_flops())
    info["attention_flops_per_step"] = float(attention_flops(counter.get_flop_counts()))
    if summary.get("median_s"):
        info["achieved_tflops"] = info["flops_per_step"] / summary["median_s"] / 1e12

    with open(os.path.join(out_dir, "profile.json"), "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps(info))
    print(f"-> {out_dir} (TensorBoard-loadable trace + profile.json)")
    return info


if __name__ == "__main__":
    main(sys.argv[1:])
