"""The reference's benchmark ladder, measured on the card (counterpart of
`scripts/benchmark_ladder.py`).

The reference's defining axis is a 50k -> 128M parameter ladder per model
family at 5.625 degrees, with hard-coded measured runtime and memory
tables (the reference's `plot_results.py:483-570`, collected with
`training.batch_size=1` over one year of 6-hourly windows).  For each
(family, parameter rung) this entry solves for the width that hits the
rung, runs the remat train step (forward, backward, AdamW at lr 1e-3 and
weight decay 1e-5, no clipping: `training.trainer.Trainer`) at batch 1
and sequence length 15 on `--device`, and records the step's seconds, the
reference protocol's epoch (96 windows, one 2014 epoch at batch 1), the
first call's seconds, the peak memory and the step's FLOPs.

    python -m dlwpbench_tpu_torch.benchmark_ladder --families unet,convlstm --rungs 50k,1m
    python -m dlwpbench_tpu_torch.benchmark_ladder --families unet --rungs 8m --grid 90x180
    python -m dlwpbench_tpu_torch.benchmark_ladder --families unet_hpx --rungs 8m --nside 32
    python -m dlwpbench_tpu_torch.benchmark_ladder --families swin --rungs 8m \\
        --compute-dtype bfloat16            # keys get @bf16
    python -m dlwpbench_tpu_torch.benchmark_ladder --backfill-flops

Writes `--out` (default `outputs/ladder.json`), one entry per
`family@rung@grid[@bf16]` with JAX's keys: `family`, `rung`, `grid`,
`width`, `params`, `batch`, `seq`, `step_s`, `epoch_s_2014_protocol`,
`compile_s`, `gridpoints_per_s`, `flops_per_step`, `achieved_tflops`;
and the port's: `peak_mb` (`torch.cuda.max_memory_allocated` over the
timed steps, after `reset_peak_memory_stats`), `attention_flops_per_step`
(the part of the count in the attention kernels' operators), `device` and
`power_limit_w` (`nvidia-smi`'s power limit, the card's speed depends on
it).  An entry with a `step_s` is kept unless `--force`; a row that fails
is recorded as `{"error": ...}` and the ladder goes on.

How the port measures, against JAX's script:
- `compile_s` holds the first eager call's seconds (JAX: XLA's compile and
  the first call);
- `step_s` is the median over `--iters` of `--repeats` eager train steps
  between two synchronisations of the card, divided by `--repeats` (JAX
  chains the steps in one `lax.scan` to hide its relay's latency; the
  same 4 x 3 by default);
- the FLOPs are a `torch.utils.flop_counter.FlopCounterMode` count over
  one more eager step: the products and convolutions (the attention
  operators by their FLOP formulas) of the forward, the remat recompute
  and the backward, over every rollout step, so no trip-count multiply;
  not XLA's cost model, which counts elementwise ops too;
- there is no `xla_plan_mb`: `peak_mb` is the card's allocator peak;
- fp32 is fp32: TF32 is off in matmuls and cuDNN convolutions, as in
  the train entry.
The diffusion family measures its real training protocol, one
v-prediction `single_forward` step (`benchmark_training.measure_diffusion`).
`--device` is the card unless it is `cpu`; without a card the default
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

RUNGS = {
    "50k": 50e3, "500k": 500e3, "1m": 1e6, "2m": 2e6, "4m": 4e6,
    "8m": 8e6, "16m": 16e6, "32m": 32e6, "64m": 64e6, "81m": 80.7e6,
    "128m": 128e6,
}

# Rung coverage mirrors the reference's measured tables (its nan pattern,
# `plot_results.py:487-501`): e.g. ConvLSTM tops out at 64M, Swin at 32M.
FAMILY_RUNGS = {
    "convlstm": ("50k", "500k", "1m", "2m", "4m", "8m", "16m", "32m", "64m"),
    "unet": tuple(RUNGS),
    "swin": ("50k", "500k", "1m", "2m", "4m", "8m", "16m", "32m"),
    "pangu": ("500k", "1m", "2m", "4m", "8m", "16m", "32m", "64m"),
    "fourcastnet": tuple(RUNGS),
    "sfno2d": tuple(RUNGS),
    "fno2d": tuple(RUNGS),
    "tfno2d": tuple(RUNGS),
    "mgn": ("50k", "500k", "1m", "2m", "4m", "8m", "16m", "32m"),
    "graphcast": ("50k", "500k", "1m", "2m", "4m", "8m", "16m", "32m"),
    "modernunet": tuple(RUNGS),
    "unet_hpx": ("500k", "2m", "8m", "32m"),
    "convlstm_hpx": ("500k", "2m", "8m"),
    "modernunet_hpx": ("500k", "2m", "8m", "32m"),
    "swin_hpx": ("500k", "2m", "8m"),
    # the windowed Swin (8x8 windows, the token-major kernels): what makes
    # the 2.0-degree and nside-32 Swin tractable; the reference's global
    # windows are O(N^2) and stop at 5.625 degrees
    "swin_win8": ("500k", "2m", "8m"),
    "swin_hpx_win8": ("500k", "2m", "8m"),
    # DISTANA has no reference table row; its rungs bracket its published
    # use (hidden 16, 4 layers)
    "distana": ("50k", "500k", "1m", "2m", "4m", "8m"),
    # the PDE-Refiner diffusion model: its rows measure the training
    # protocol (one v-prediction single_forward + AdamW a step); widths
    # follow the reference's 4-level shape (w, 2w, 4w, 16w), w = 64 being
    # the reference config (~80M)
    "diffusion": ("2m", "8m", "32m", "81m"),
}

WINDOWS_PER_EPOCH_2014 = 96  # (1460 - 15) // 15: one year, 6-hourly, seq 15
LR, WEIGHT_DECAY = 1e-3, 1e-5


def _swin_dims(width: int) -> tuple[int, tuple]:
    """(embed, heads) of the ladder's Swin at a width knob: fine
    quantisation and heads (1, 2) on the small rungs, else heads (3, 6)
    with a head dim that is a multiple of 8."""
    if width < 48:
        return 8 * max(1, round(width / 8)), (1, 2)
    return 24 * max(1, round(width / 24)), (3, 6)


def build(family: str, width: int, H: int, W: int, Cc: int, Cp: int, Cq: int,
          nside: int | None = None, movement_impl: str | None = None):
    """The port's model for a family at the integer width knob `width`
    (JAX's `build`, `scripts/benchmark_ladder.py:79-200`: the same width
    quantisation and heads).  `movement_impl` picks a graph family's
    movement (`backfill_graph_flops`)."""
    from dlwpbench_tpu_torch.models import convlstm, distana, fno, fourcastnet, graphcast, mgn
    from dlwpbench_tpu_torch.models import modern_unet, pangu, sfno, swin, unet

    kw = dict(constant_channels=Cc, prescribed_channels=Cp, prognostic_channels=Cq)
    graph_kw = {} if movement_impl is None else {"movement_impl": movement_impl}
    if family == "diffusion":
        w = 8 * max(1, round(width / 8))
        return modern_unet.DiffModernUNet(hidden_channels=(w, 2 * w, 4 * w, 16 * w),
                                          context_size=2, norm=True, use_scale_shift_norm=True,
                                          num_refinement_step=5, **kw)
    if family == "convlstm":
        return convlstm.ConvLSTM(hidden_sizes=(width, width), **kw)
    if family == "convlstm_hpx":
        return convlstm.ConvLSTMHPX(hidden_sizes=(width, width), **kw)
    if family == "unet":
        return unet.UNet(hidden_channels=(width, 2 * width, 4 * width), **kw)
    if family == "unet_hpx":
        return unet.UNetHPX(hidden_channels=(width, 2 * width, 4 * width), **kw)
    if family == "modernunet":
        return modern_unet.ModernUNet(hidden_channels=(width, 2 * width, 4 * width), norm=True,
                                      **kw)
    if family == "modernunet_hpx":
        return modern_unet.MUNetHPX(hidden_channels=(width, 2 * width, 4 * width), norm=True,
                                    **kw)
    if family in ("swin", "swin_win8", "swin_hpx", "swin_hpx_win8"):
        d, heads = _swin_dims(width)
        win = (8, 8) if family.endswith("win8") else None
        cls = swin.SwinTransformerHPX if "hpx" in family else swin.SwinTransformer
        h, w = (nside, nside) if "hpx" in family else (H, W)
        return cls(img_height=h, img_width=w, embed_dim=d, depths=(4, 4), num_heads=heads,
                   window_size=win, use_flash_attention=None if win else True, **kw)
    if family == "fno2d":
        return fno.FNO2DModule(hidden_channels=width, n_layers=4, grid_shape=(H, W), **kw)
    if family == "tfno2d":
        return fno.TFNO2DModule(hidden_channels=width, n_layers=4, rank=0.8, grid_shape=(H, W),
                                **kw)
    if family == "fourcastnet":
        d = 16 * max(1, round(width / 16))  # num_blocks=8 divides the embedding
        return fourcastnet.FourCastNet(img_height=H, img_width=W, patch_size=(1, 1),
                                       embed_dim=d, depth=6, num_blocks=8, **kw)
    if family == "sfno2d":
        d = 8 * max(1, round(width / 8))
        return sfno.SFNO2DModule(embed_dim=d, num_layers=4, height=H, width=W, **kw)
    if family == "pangu":
        if width < 24:  # the smallest rungs
            d, heads = 8 * max(1, round(width / 8)), (1, 2, 2, 1)
        elif width < 72:  # small rungs: fewer heads so the embedding can shrink
            d, heads = 16 * max(1, round(width / 16)), (2, 4, 4, 2)
        else:
            d, heads = 48 * max(1, round(width / 48)), (6, 12, 12, 6)
        return pangu.PanguWeather(embed_dim=d, num_heads=heads, patch_size=(1, 1), n_lat=H,
                                  n_lon=W, **kw)
    if family == "mgn":
        return mgn.MeshGraphNet(processor_size=4, hidden_dim_processor=width,
                                hidden_dim_node_encoder=width, hidden_dim_edge_encoder=width,
                                hidden_dim_node_decoder=width, graph_type="delaunay",
                                **graph_kw, **kw)
    if family == "graphcast":
        return graphcast.GraphCastNet(input_height=H, input_width=W, mesh_level=3,
                                      processor_layers=4, hidden_dim=width, **graph_kw, **kw)
    if family == "distana":
        return distana.DISTANA(hidden_size=width, layers=4, **kw)
    raise ValueError(f"unknown family {family!r}")


def count_params(model) -> int:
    """The model's parameter count (JAX counts the leaves of its init tree)."""
    return sum(p.numel() for p in model.parameters())


def build_meta(family: str, width: int, *args, **kwargs):
    """`build` with every parameter and buffer on the meta device: shapes
    only, no memory and no init (JAX's `eval_shape`)."""
    with torch.device("meta"):
        return build(family, width, *args, **kwargs)


def solve_width(family, target, H, W, Cc, Cp, Cq, nside, tol=0.10) -> tuple[int, int]:
    """(width, params) of the smallest-error width for the parameter target
    (parameters grow about as width^2): JAX's bisection over 1 .. 4096."""
    lo, hi = 1, 4096
    best = None
    for _ in range(24):
        mid = (lo + hi) // 2
        n = count_params(build_meta(family, mid, H, W, Cc, Cp, Cq, nside))
        if best is None or abs(n - target) < abs(best[1] - target):
            best = (mid, n)
        if n < target:
            lo = mid + 1
        else:
            hi = mid - 1
        if lo > hi:
            break
    w, n = best
    if abs(n - target) / target > tol and target >= 500e3:
        print(f"  [warn] {family}@{target:.0f}: width {w} gives {n} "
              f"({abs(n - target) / target:+.0%})", flush=True)
    return w, n


def prepare_step(model, arrays, device, compute_dtype=None, params=None):
    """A function `chained(repeats)` that runs `repeats` remat train steps
    of `model` (JAX's `_prepare_step`, `scripts/benchmark_ladder.py:235`)
    and returns their summed loss, a 0-d tensor on `device`.  `arrays` are
    (constants, prescribed, prognostic, target) numpy arrays, the target
    [B, T - 1, ...] cut to the rollout's T - context frames; `params` a flax
    tree to start from (`weights.load_flax_params`), else the model's own
    init.  Each step: the MSE of the rollout (in fp32 whatever the compute
    dtype), the backward, AdamW."""
    from dlwpbench_tpu_torch.training.trainer import Trainer

    if hasattr(model, "remat"):
        model.remat = True
    model.to(device).train()
    const, pres, prog, target = (torch.as_tensor(np.asarray(a), device=device) for a in arrays)
    target = target[:, : target.shape[1] - (model.context_size - 1)]
    trainer = Trainer(model, learning_rate=LR, weight_decay=WEIGHT_DECAY, clip_gradients=False,
                      compute_dtype=compute_dtype)
    state = trainer.init(params)
    batch = (const, pres, prog, target)

    def chained(repeats: int) -> torch.Tensor:
        total = torch.zeros((), device=device)
        for _ in range(repeats):
            total = total + trainer.train_step(state, batch, LR)
        return total

    return chained


def step_flops(chained) -> tuple[float, float]:
    """(FLOPs, of them the attention operators') of one step of `chained`,
    counted by `FlopCounterMode` as it runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from dlwpbench_tpu_torch.profile_model import attention_flops

    counter = FlopCounterMode(display=False)
    with counter:
        float(chained(1))
    return float(counter.get_total_flops()), float(attention_flops(counter.get_flop_counts()))


def time_chained(chained, device, repeats: int, iters: int) -> tuple[float, float, dict]:
    """(median seconds a step, the first call's seconds, memory): the
    first call of `repeats` steps, then `iters` timed calls of `repeats`
    steps each, the loss read back (a synchronisation) after each."""
    card = device.type == "cuda"
    t0 = time.perf_counter()
    float(chained(repeats))
    first_s = time.perf_counter() - t0
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(chained(repeats))
        times.append((time.perf_counter() - t0) / repeats)
    mem = {}
    if card:
        mem["peak_mb"] = round(torch.cuda.max_memory_allocated(device) / 1e6, 1)
    return float(np.median(times)), first_s, mem


def measure(model, arrays, device, repeats=4, iters=3, compute_dtype=None, flops=True,
            params=None) -> tuple[float, float, dict]:
    """Time the remat train step; (seconds a step, the first call's
    seconds, {peak_mb, flops_per_step, attention_flops_per_step,
    achieved_tflops}).  `compute_dtype="bfloat16"` measures the
    mixed-precision step (bf16 compute, fp32 master parameters: the
    trainer's recipe)."""
    chained = prepare_step(model, arrays, device, compute_dtype, params)
    step_s, first_s, mem = time_chained(chained, device, repeats, iters)
    if flops:
        f, att = step_flops(chained)
        if f > 0:
            mem.update(flops_per_step=f, attention_flops_per_step=att,
                       achieved_tflops=round(f / step_s / 1e12, 3))
    return step_s, first_s, mem


def card_info(device) -> dict:
    """`device` (the card's name, or "cpu") and `power_limit_w` (the card's
    power limit from `nvidia-smi`, None where it cannot be read)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.splitlines()
        index = device.index or 0
        limit = float(out[index].rsplit(",", 1)[1].strip().split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return {"device": torch.cuda.get_device_name(device), "power_limit_w": limit}


def grid_of(key: str) -> tuple[int | None, tuple, int]:
    """(nside or None, the spatial shape, grid points) of a ladder grid key
    ("32x64", "hpx32")."""
    if key.startswith("hpx"):
        ns = int(key[3:])
        return ns, (12, ns, ns), 12 * ns * ns
    h, w = (int(x) for x in key.split("x"))
    return None, (h, w), h * w


def synthetic_arrays(B: int, T: int, spatial: tuple, Cc=4, Cp=1, Cq=8, seed=0):
    """(constants, prescribed, prognostic, target) drawn as JAX's script
    draws them (numpy's default_rng(seed), in that order)."""
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, t, c, *spatial)).astype(np.float32)
                 for t, c in ((1, Cc), (T, Cp), (T, Cq), (T - 1, Cq)))


def save(results: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)


def backfill_flops(results: dict, families, device, out: str, movement: dict | None = None,
                   force: bool = False) -> None:
    """Fill FLOP counts into existing entries: each rebuilt at its recorded
    width and counted over one step on `device`, no timing; `out` written
    after each.  Without `movement`: `flops_per_step`, its attention part
    and `achieved_tflops`, where an entry lacks them.  With `movement`
    ({family: movement_impl}, `backfill_graph_flops`): that movement form's
    count as `algorithmic_flops_per_step` and `algorithmic_tflops`.
    `force` counts entries that have the count already."""
    field = "algorithmic_flops_per_step" if movement else "flops_per_step"
    for key, e in sorted(results.items()):
        if (not isinstance(e, dict) or "error" in e or not e.get("step_s")
                or (e.get(field) and not force)
                or (families is not None and e.get("family") not in families)):
            continue
        ns, spatial, _ = grid_of(e["grid"])
        Be, Te = e.get("batch", 1), e.get("seq", 15)
        arrays = tuple(np.zeros(a.shape, np.float32)
                       for a in synthetic_arrays(Be, Te, spatial))
        cdt = "bfloat16" if key.endswith("@bf16") else None
        kw = {} if movement is None else {"movement_impl": movement[e["family"]]}
        try:
            model = build(e["family"], e["width"], spatial[-2], spatial[-1], 4, 1, 8, ns, **kw)
            f, att = step_flops(prepare_step(model, arrays, device, cdt))
        except Exception as exc:  # one entry's failure leaves the others to fill
            print(f"{key}: backfill FAILED {type(exc).__name__}: {exc}", flush=True)
            continue
        finally:
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if not f:
            continue
        if movement:
            over = e["flops_per_step"] / f if e.get("flops_per_step") else 0
            e.update(algorithmic_flops_per_step=f,
                     algorithmic_tflops=round(f / e["step_s"] / 1e12, 3))
            print(f"{key}: algorithmic {f / 1e9:.1f} GFLOP/step ({over:.2f}x counted by the "
                  f"executed program) -> {e['algorithmic_tflops']:.3f} TFLOP/s", flush=True)
        else:
            e.update(flops_per_step=f, attention_flops_per_step=att,
                     achieved_tflops=round(f / e["step_s"] / 1e12, 3))
            print(f"{key}: {f / 1e9:.2f} GFLOP/step -> {e['achieved_tflops']:.3f} TFLOP/s",
                  flush=True)
        save(results, out)


def main(argv=None) -> dict:
    from dlwpbench_tpu_torch.utils.device import entry_device, no_tf32

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default="unet,convlstm,swin,fourcastnet,sfno2d,graphcast")
    ap.add_argument("--rungs", default=None, help="e.g. 50k,1m,128m (default: family coverage)")
    ap.add_argument("--grid", default="32x64", help="HxW lat-lon grid")
    ap.add_argument("--nside", type=int, default=None, help="HEALPix nside (hpx families)")
    ap.add_argument("--seq", type=int, default=15)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--compute-dtype", default=None,
                    help="bfloat16 = mixed-precision step (keys get @bf16)")
    ap.add_argument("--out", default="outputs/ladder.json")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even if the key is already cached")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    ap.add_argument("--repeats", type=int, default=4,
                    help="train steps between two synchronisations (JAX's scan length)")
    ap.add_argument("--iters", type=int, default=3, help="timed groups of --repeats steps")
    ap.add_argument("--no-flops", action="store_true", help="skip the FLOP count's extra step")
    ap.add_argument("--backfill-flops", action="store_true",
                    help="no timing: fill flops_per_step/achieved_tflops into EXISTING "
                         "entries (rebuilt at the recorded width, one counted step)")
    args = ap.parse_args(argv)

    device = entry_device(args.device, "benchmark_ladder")
    no_tf32()
    card = device.type == "cuda"
    try:
        with open(args.out) as f:
            results = json.load(f)
    except (OSError, ValueError):
        results = {}

    if args.backfill_flops:
        families = (None if args.families == ap.get_default("families")
                    else set(args.families.split(",")))
        backfill_flops(results, families, device, args.out)
        print(f"-> {args.out}")
        return results

    if args.nside:
        grid_key = f"hpx{args.nside}"
    else:
        grid_key = "x".join(str(int(x)) for x in args.grid.split("x"))
    nside, spatial, npoints = grid_of(grid_key)
    H, W = spatial[-2:]
    B, T, Cc, Cp, Cq = args.batch, args.seq, 4, 1, 8
    arrays = synthetic_arrays(B, T, spatial, Cc, Cp, Cq)
    info = card_info(device)

    for family in args.families.split(","):
        rungs = args.rungs.split(",") if args.rungs else FAMILY_RUNGS[family]
        for rung in rungs:
            key = f"{family}@{rung}@{grid_key}" + ("@bf16" if args.compute_dtype else "")
            if results.get(key, {}).get("step_s") and not args.force:
                print(f"{key}: cached, skipping", flush=True)
                continue
            try:
                w, n = solve_width(family, RUNGS[rung], H, W, Cc, Cp, Cq, nside)
                model = build(family, w, H, W, Cc, Cp, Cq, nside)
                if family == "diffusion":  # the training protocol: one denoiser step
                    from dlwpbench_tpu_torch.benchmark_training import measure_diffusion

                    step_s, compile_s, mem, _ = measure_diffusion(
                        model, arrays, device, compute_dtype=args.compute_dtype,
                        repeats=args.repeats, iters=args.iters)
                    mem["note"] = ("v-prediction single_forward train step; inference pays "
                                   "the DDPM refinement loop (benchmark_models)")
                else:
                    step_s, compile_s, mem = measure(model, arrays, device, args.repeats,
                                                     args.iters, args.compute_dtype,
                                                     flops=not args.no_flops)
                epoch_s = step_s * WINDOWS_PER_EPOCH_2014 / B
                results[key] = {
                    "family": family, "rung": rung, "grid": grid_key,
                    "width": w, "params": n, "batch": B, "seq": T,
                    "step_s": round(step_s, 4),
                    "epoch_s_2014_protocol": round(epoch_s, 2),
                    "compile_s": round(compile_s, 1),
                    "gridpoints_per_s": round(B * (T - 1) * npoints / step_s, 1),
                    **info, **mem,
                }
                tf = mem.get("achieved_tflops")
                print(f"{key}: {n / 1e6:7.2f}M width {w}  step {step_s * 1e3:8.1f} ms  "
                      f"epoch(2014) {epoch_s:7.2f} s  first call {compile_s:5.1f} s  peak "
                      f"{mem.get('peak_mb', 'n/a')} MB  "
                      f"{'n/a' if tf is None else tf} TFLOP/s", flush=True)
                del model
            except Exception as e:  # a failing row is recorded, as in JAX
                results[key] = {"family": family, "rung": rung, "grid": grid_key,
                                "error": f"{type(e).__name__}: {e}", **info}
                print(f"{key}: FAILED {type(e).__name__}: {e}", flush=True)
            if card:
                torch.cuda.empty_cache()
            save(results, args.out)
    print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
