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


def model_zoo(B: int, H: int, W: int, Cc: int = 4, Cp: int = 1, Cq: int = 8) -> dict:
    """The JAX benchmark zoo (`scripts/benchmark_models.py:23-80`) at its
    widths: each entry a function that builds the port's model."""
    from dlwpbench_tpu_torch.models.convlstm import ConvLSTM
    from dlwpbench_tpu_torch.models.distana import DISTANA
    from dlwpbench_tpu_torch.models.fno import FNO2DModule, TFNO2DModule
    from dlwpbench_tpu_torch.models.fourcastnet import FourCastNet
    from dlwpbench_tpu_torch.models.graphcast import GraphCastNet
    from dlwpbench_tpu_torch.models.mgn import MeshGraphNet
    from dlwpbench_tpu_torch.models.modern_unet import DiffModernUNet, ModernUNet
    from dlwpbench_tpu_torch.models.pangu import PanguWeather
    from dlwpbench_tpu_torch.models.sfno import SFNO2DModule
    from dlwpbench_tpu_torch.models.swin import SwinTransformer
    from dlwpbench_tpu_torch.models.unet import UNet

    kw = dict(constant_channels=Cc, prescribed_channels=Cp, prognostic_channels=Cq)
    return {
        "convlstm": lambda: ConvLSTM(hidden_sizes=(64, 64), **kw),
        "unet": lambda: UNet(hidden_channels=(64, 128, 256), **kw),
        "modernunet": lambda: ModernUNet(hidden_channels=(64, 128, 256), norm=True, **kw),
        "fno2d": lambda: FNO2DModule(hidden_channels=32, n_layers=4, grid_shape=(H, W), **kw),
        "tfno2d": lambda: TFNO2DModule(hidden_channels=32, n_layers=4, rank=0.8,
                                       grid_shape=(H, W), **kw),
        "fourcastnet": lambda: FourCastNet(img_height=H, img_width=W, patch_size=(1, 1),
                                           embed_dim=128, depth=6, num_blocks=8, **kw),
        "sfno2d": lambda: SFNO2DModule(embed_dim=128, num_layers=4, height=H, width=W, **kw),
        # heads chosen so that head_dim is 32 (the flash kernel's) at both stages
        "swin": lambda: SwinTransformer(img_height=H, img_width=W, embed_dim=96, depths=(4, 4),
                                        num_heads=(3, 6), use_flash_attention=True, **kw),
        "pangu": lambda: PanguWeather(embed_dim=96, num_heads=(6, 12, 12, 6), patch_size=(1, 1),
                                      n_lat=H, n_lon=W, **kw),
        "mgn": lambda: MeshGraphNet(
            processor_size=4, hidden_dim_processor=64, hidden_dim_node_encoder=64,
            hidden_dim_edge_encoder=64, hidden_dim_node_decoder=64, graph_type="delaunay", **kw),
        "graphcast": lambda: GraphCastNet(input_height=H, input_width=W, mesh_level=3,
                                          processor_layers=4, hidden_dim=128, **kw),
        "distana": lambda: DISTANA(hidden_size=64, layers=4, **kw),
        # the reference's `diffusion_modernunet.yaml` width; its rollout runs
        # the whole refinement loop (num_refinement_step + 1 forwards a step)
        "diffusion": lambda: DiffModernUNet(
            hidden_channels=(64, 128, 256, 1024), context_size=2, num_refinement_step=5,
            norm=True, use_scale_shift_norm=True, **kw),
    }


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

    device = torch.device(args.device)
    card = device.type == "cuda"
    if card and not torch.cuda.is_available():
        raise SystemExit("profile_model: no CUDA card; pass --device cpu to profile the CPU")
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

    def sync():
        if card:
            torch.cuda.synchronize(device)

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
            sync()
    else:
        model.eval()

        def run():
            with torch.no_grad():
                model(const, pres, prog)
            sync()

    run()  # kernel builds and first-call work outside the trace

    out_dir = args.out_dir or os.path.join(
        "outputs", "profile", args.model + ("_train" if args.train else "_infer"))
    os.makedirs(out_dir, exist_ok=True)
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    timer = profiling.StepTimer(skip=0, sync=card)
    with profiling.trace(out_dir):
        for _ in range(args.steps):
            with timer, profiling.annotate(f"{args.model}_step"):
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
