"""The zoo's rollout matrix: parameters, seconds a rollout and grid-points/s
of every benchmark model at batch 1 on the 5.625-degree grid, and the
runtime-over-parameters figure (counterpart of
`scripts/benchmark_models.py`; the reference's measured tables,
`plot_results.py:483-570`, were collected at batch 1).

    python -m dlwpbench_tpu_torch.benchmark_models [--models unet,fno2d,...]
        [--batch 1] [--steps 16] [--iters 5] [--out-dir outputs] [--device cpu]

Writes `<out-dir>/benchmark_matrix.json` ({"batch", "steps", "grid",
"results"}), merged with the models a file there already holds, and
`<out-dir>/runtime_over_params.png` where matplotlib is installed.  Each
model's row: `params`, `rollout_s` (median over `--iters` of the mean of
8 eager rollouts of `--steps` lead steps, the card synchronised after
each group; JAX chains the 8 in one `lax.scan` instead), `compile_s` (the
first rollout's seconds: kernel builds and first-call work),
`gridpoints_per_s` = batch x steps x 32 x 64 / rollout_s, and on the card
`peak_mb` (`torch.cuda.max_memory_allocated` over the timed rollouts).  A
model that fails is recorded as `{"error": ...}` and the matrix goes on.
`--device` is the card unless it is `cpu`; without a card the default
raises.

`model_zoo` is the port's one benchmark zoo: `profile_model`,
`benchmark_training` and the tests build from it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPEATS = 8  # rollouts timed back to back between two synchronisations


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


def merge_into(path: str, payload: dict) -> dict:
    """`payload` with its `results` merged over those `path` already holds
    (a partial re-run keeps the other models), written to `path`."""
    try:
        with open(path) as f:
            prev = json.load(f).get("results", {})
    except (OSError, ValueError):
        prev = {}
    payload = {**payload, "results": {**prev, **payload["results"]}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.utils.device import entry_device, no_tf32, sync

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out-dir", default="outputs")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    device = entry_device(args.device, "benchmark_models")
    no_tf32()
    card = device.type == "cuda"
    B, T, H, W = args.batch, args.steps + 1, 32, 64
    Cc, Cp, Cq = 4, 1, 8
    zoo = model_zoo(B, H, W, Cc, Cp, Cq)
    if args.models:
        keep = set(args.models.split(","))
        zoo = {k: v for k, v in zoo.items() if k in keep}

    r = np.random.default_rng(0)
    const, pres, prog = (torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(device)
                         for s in ((B, 1, Cc, H, W), (B, T, Cp, H, W), (B, T, Cq, H, W)))

    results = {}
    for name, make in zoo.items():
        try:
            model = make().to(device).eval()
            n_params = sum(p.numel() for p in model.parameters())

            def rollouts(n):
                with torch.no_grad():
                    for _ in range(n):
                        model(const, pres, prog)
                sync(device)

            t0 = time.perf_counter()
            rollouts(1)
            compile_s = time.perf_counter() - t0
            if card:
                torch.cuda.reset_peak_memory_stats(device)
            times = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                rollouts(REPEATS)
                times.append((time.perf_counter() - t0) / REPEATS)
            dt = float(np.median(times))
            gps = B * args.steps * H * W / dt
            results[name] = {"params": n_params, "rollout_s": round(dt, 5),
                             "compile_s": round(compile_s, 2),
                             "gridpoints_per_s": round(gps, 1)}
            if card:
                results[name]["peak_mb"] = round(torch.cuda.max_memory_allocated(device) / 1e6, 1)
            print(f"{name:12s} {n_params / 1e6:7.2f}M params  {dt * 1e3:8.2f} ms/rollout "
                  f"({gps / 1e6:7.2f} M gp/s, first call {compile_s:.1f}s)", flush=True)
            del model
        except Exception as e:  # a failing model is a row of the matrix, as in JAX
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"{name:12s} FAILED: {type(e).__name__}: {e}", flush=True)
        if card:
            torch.cuda.empty_cache()

    out = os.path.join(args.out_dir, "benchmark_matrix.json")
    payload = merge_into(out, {"batch": B, "steps": args.steps, "grid": [H, W],
                               "device": torch.cuda.get_device_name(device) if card else "cpu",
                               "results": results})
    try:
        from dlwpbench_tpu_torch.evaluation.plots import multi_x_over_params_plot

        ladder = {k: {v["params"]: v["rollout_s"]}
                  for k, v in payload["results"].items() if "params" in v}
        png = os.path.join(args.out_dir, "runtime_over_params.png")
        multi_x_over_params_plot(ladder, "rollout seconds", png, logy=True)
        print(f"-> {png}")
    except ImportError as e:  # the card's machine has no matplotlib
        print(f"runtime-over-params figure skipped: matplotlib unavailable ({e})")
    print(f"-> {out}")
    return payload


if __name__ == "__main__":
    main(sys.argv[1:])
