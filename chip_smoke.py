#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`dlwpbench_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and nothing is caught:

1. the card: CUDA must be available; prints its name and power limit;
2. builds every kernel under `dlwpbench_tpu_torch/ops/csrc/` from source,
   one nvcc per source, all started together;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, fp32 and bf16, TF32 off, and times the kernel, the
   plain version, the least time the card could take (`bound_ms`) and one
   PyTorch library call computing the same function (`library_ms`, a
   yardstick the port never calls);
4. the evaluate path: `python -m dlwpbench_tpu_torch.evaluate
   model=swintransformer data=synthetic` at the shipped width (embed 96,
   depths [4, 4], heads [4, 4], 32x64 grid, 16-step rollouts, fp32,
   seeded random weights) at eval batch 32, with every launch counter set
   to 0 just before and read just after (forward only: no gradients);
5. its output: finite forecasts of the expected shape, and the same model
   on a small batch agreeing with its run on the CPU (plain attention);
6. a torch.profiler breakdown of one rollout batch;
7. the training path: `python -m dlwpbench_tpu_torch.train
   model=swintransformer data=synthetic data.n_time=1536
   training.epochs=2` at the shipped width and training config (batch 32,
   2-step rollouts, remat, AdamW; validation at batch 15 over 14-step
   rollouts), counters set to 0 just before and read just after, with
   the exact forward and backward launch counts asserted;
8. the full-width model's loss and every parameter gradient on the card
   (kernels) against the CPU (plain), and a torch.profiler breakdown of
   one training step;
9. the card line, the `kernels` line and, last, `{"ok": true, ...}`.

Every time printed stands beside the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of an H100 SXM at 700 W (dense): fp32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# The main path: the shipped Swin config on synthetic data.  n_time=9060
# makes the synthetic record long enough for 96 biweekly test inits, three
# full eval batches of 32 (the config's testing batch size).
MAIN_ARGV = ["model=swintransformer", "data=synthetic", "data.n_time=9060",
             "--batch-size", "32", "--sequence-length", "17", "--device", "cuda"]
EVAL_BATCH = 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` calls after two warm-ups."""
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_all():
    """One nvcc per source under ops/csrc, all at once; raises on a failure."""
    from dlwpbench_tpu_torch.ops import _build

    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.build, names)))
    for name, path in libs.items():
        print(f"built {name} -> {os.path.relpath(path, REPO)}")
    print(f"build: {len(names)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    return names


# ---------------------------------------------------------------- flash attention
FLASH_CASES = [
    # (label, B, H, N, D, G or 0 for a 3D bias, bias kind)
    ("stage0 unshifted", EVAL_BATCH, 4, 2048, 24, 0, "random"),
    ("stage0 shifted", EVAL_BATCH, 4, 2048, 24, 1, "swin-shift"),
    ("stage1 unshifted", EVAL_BATCH, 4, 512, 48, 0, "random"),
    ("tail N=1000 G=4", 8, 3, 1000, 32, 4, "random"),
]
# fp32: online versus two-pass softmax, sums in another order.  bf16: the
# kernel rounds its fp32 result once to bf16 (|out| < 2 here, so half an
# ulp is < 4e-3); the plain version is computed in fp32 on the same values.
FLASH_TOL = {"float32": {"out": 5e-5, "lse": 5e-5}, "bfloat16": {"out": 1e-2, "lse": 5e-5}}


def _flash_inputs(B, H, N, D, G, kind, dtype, gen):
    import torch

    from dlwpbench_tpu_torch.models.swin import expand_relative_bias, shift_window_groups

    q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen) for _ in range(3))
    shape = (H, N, N) if G == 0 else (G, H, N, N)
    if kind == "swin-shift":  # the model's own bias: table + the -100 shift mask
        h, w = 32, 64
        table = 0.02 * torch.randn((2 * h - 1) * (2 * w - 1), H, device="cuda", generator=gen)
        groups = torch.as_tensor(shift_window_groups(h, w, h, w, h // 2, w // 2), device="cuda")
        mask = torch.where(groups[:, None, :] != groups[:, :, None], -100.0, 0.0)
        bias = expand_relative_bias(table, h, w)[None] + mask[:, None]
    else:
        bias = torch.randn(shape, device="cuda", generator=gen)
    assert tuple(bias.shape) == shape
    return [t.to(dtype).contiguous() for t in (q, k, v, bias)]


def _bound(B, H, N, D, G, dtype_name, backward=False):
    """(bound ms, what bounds it, FLOPs, bytes): the least work, each input
    read once and each output written once.  Forward: QK^T and PV; q, k,
    v, out, bias, lse.  Backward: QK^T, dP, dV, dK, dQ; q, k, v, out, dO,
    dq, dk, dv, lse, drow, bias, dbias."""
    item = 4 if dtype_name == "float32" else 2
    bias_bytes = max(G, 1) * H * N * N * item
    if backward:
        flops = 10 * B * H * N * N * D
        nbytes = 8 * B * H * N * D * item + 2 * B * H * N * 4 + 2 * bias_bytes
    else:
        flops = 4 * B * H * N * N * D
        nbytes = 4 * B * H * N * D * item + bias_bytes + B * H * N * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def check_flash(card: str):
    import torch
    import torch.nn.functional as F

    from dlwpbench_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, B, H, N, D, G, kind in FLASH_CASES:
            q, k, v, bias = _flash_inputs(B, H, N, D, G, kind, dtype, gen)
            out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            p_out, p_lse = fa.flash_window_attention_plain(q.float(), k.float(), v.float(), bias.float())
            err = (out.float() - p_out).abs().max().item()
            lse_err = (lse - p_lse).abs().max().item()
            tol = FLASH_TOL[dname]
            ok = err <= tol["out"] and lse_err <= tol["lse"]
            ms = cuda_ms(lambda: fa.flash_window_attention_fwd(q, k, v, bias), 20)
            plain_ms = cuda_ms(lambda: fa.flash_window_attention_plain(q, k, v, bias), 3)
            mask = bias if G <= 1 else bias.repeat(B // G, 1, 1, 1)  # bias[b % G] per b
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20
            )
            bound_ms, bound_by, flops, nbytes = _bound(B, H, N, D, G, dname)
            rec = dict(case=label, dtype=dname, B=B, H=H, N=N, D=D,
                       bias=list(bias.shape), max_abs_err=err, lse_max_abs_err=lse_err,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            checks.append(rec)
            print(
                f"flash_window_attention {dname} {label} q[{B},{H},{N},{D}] bias{list(bias.shape)}: "
                f"max|out diff| {err:.3e} max|lse diff| {lse_err:.3e} "
                f"(tol {tol['out']:.0e}/{tol['lse']:.0e}) {'ok' if ok else 'FAIL'}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}, {flops / ms / 1e9:.1f} TFLOP/s) [{card}]"
            )
            if not ok:
                failures.append(f"flash_window_attention {dname} {label}")
            del q, k, v, bias, out, lse, p_out, p_lse, mask
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: {failures}")
    return checks


# ---------------------------------------------------------------- flash backward
FLASH_BWD_CASES = [
    # (label, B, H, N, D, G or 0 for a 3D bias, bias kind)
    ("stage0 unshifted", 32, 4, 2048, 24, 0, "random"),
    ("stage0 shifted", 32, 4, 2048, 24, 1, "swin-shift"),
    ("stage1 unshifted", 32, 4, 512, 48, 0, "random"),
    ("tail N=1000 G=4", 8, 3, 1000, 32, 4, "random"),
    ("G=B N=200", 4, 2, 200, 64, 4, "random"),
]
# Tolerances, as a share of max|ref| per output.  fp32: the kernel and the
# plain version sum over up to 2048 keys and 32 members in other orders.
# bf16: the kernel rounds its fp32 result once to bf16 (half an ulp is
# 2^-9 of the value); the plain version is computed in fp32 on the same
# bf16 inputs.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _sdpa_backward(q, k, v, bias, B, G):
    """A function timing the backward alone (autograd.grad over a retained
    graph) of one `F.scaled_dot_product_attention(q, k, v, attn_mask=bias)`
    whose inputs and mask require grad."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    mask = leaves[3] if G <= 1 else leaves[3].repeat(B // G, 1, 1, 1)
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=mask)
    g = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def check_flash_bwd(card: str):
    import torch

    from dlwpbench_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, B, H, N, D, G, kind in FLASH_BWD_CASES:
            q, k, v, bias = _flash_inputs(B, H, N, D, G, kind, dtype, gen)
            do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
            drow = (do.float() * out.float()).sum(-1)[:, :, None, :]
            args = (q, k, v, bias, out, lse, do, drow)
            got = fa.flash_window_attention_bwd(*args)
            again = fa.flash_window_attention_bwd(*args)
            torch.cuda.synchronize()
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            ref = fa.flash_window_attention_bwd_plain(*(a.float() for a in args))
            errs, ok = {}, identical
            for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
                scale = r.abs().max().item()
                errs[name] = (a.float() - r).abs().max().item()
                ok = ok and errs[name] <= FLASH_BWD_TOL[dname] * scale
                errs[name + "_ref_max"] = scale
            del again, ref
            ms = cuda_ms(lambda: fa.flash_window_attention_bwd(*args), 10)
            plain_ms = cuda_ms(lambda: fa.flash_window_attention_bwd_plain(*args), 3)
            lib_fn = _sdpa_backward(q, k, v, bias, B, G)
            library_ms = cuda_ms(lib_fn, 10)
            del lib_fn
            bound_ms, bound_by, flops, nbytes = _bound(B, H, N, D, G, dname, backward=True)
            rec = dict(case=label, dtype=dname, B=B, H=H, N=N, D=D, bias=list(bias.shape),
                       errors=errs, max_abs_err=max(errs[n] for n in ("dq", "dk", "dv", "dbias")),
                       tol=FLASH_BWD_TOL[dname], bit_identical=identical, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            checks.append(rec)
            print(
                f"flash_window_attention_bwd {dname} {label} q[{B},{H},{N},{D}] "
                f"bias{list(bias.shape)}: max|diff| "
                + " ".join(f"{n} {errs[n]:.3e}/{errs[n + '_ref_max']:.3e}"
                           for n in ("dq", "dk", "dv", "dbias"))
                + f" (tol {FLASH_BWD_TOL[dname]:.0e} x max|ref|), two calls "
                f"{'bit-identical' if identical else 'DIFFER'} {'ok' if ok else 'FAIL'}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa bwd (q, k, v, mask) "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                f"{flops / ms / 1e9:.1f} TFLOP/s) [{card}]"
            )
            if not ok:
                failures.append(f"flash_window_attention_bwd {dname} {label}")
            del q, k, v, bias, do, out, lse, drow, args, got
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"backward kernels disagree with their plain versions: {failures}")
    return checks


# ---------------------------------------------------------------- evaluate path
def run_main_path(out_dir: str, counters: dict, card: str):
    import torch

    from dlwpbench_tpu_torch import evaluate as cli
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=[a for a in MAIN_ARGV if "=" in a])
    depth = sum(int(d) for d in cfg.model.depths)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.main([*MAIN_ARGV, "--out-dir", out_dir])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    n_batches = len(res["batch_seconds"])
    steps = int(MAIN_ARGV[MAIN_ARGV.index("--sequence-length") + 1]) - int(cfg.model.context_size)
    want = depth * steps * n_batches
    print(f"main path: evaluate {' '.join(MAIN_ARGV)}: {n_batches} batches, {wall:.1f} s wall "
          f"(data, model, rollout, files), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"main path: batch seconds {[round(s, 4) for _, s in res['batch_seconds']]}, "
          f"steady-state {res['gridpoints_per_s']:.1f} grid-points/s [{card}]")
    print(f"main path: RMSE var0 per lead {[round(x, 4) for x in res['rmse']['var0']]}")
    print(f"main path launches {launches} (flash_window_attention wants {depth} blocks x "
          f"{steps} steps x {n_batches} batches = {want}; no backward under no_grad)")
    if launches != {"flash_window_attention": want, "flash_window_attention_bwd": 0}:
        raise SystemExit(f"evaluate path launches {launches}, want {want} forward, 0 backward")
    return res, launches, cfg


def check_outputs(out_dir: str, res: dict, cfg):
    import numpy as np
    import torch

    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.utils import netcdf3

    data, dims = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    n_var = int(cfg.data.prognostic_channels)
    want_shape = (3 * EVAL_BATCH, 16, int(cfg.data.height), int(cfg.data.width))
    for i in range(n_var):
        arr = data[f"var{i}"]
        if arr.shape != want_shape or not np.isfinite(arr).all():
            raise SystemExit(f"outputs.nc var{i}: shape {arr.shape} (want {want_shape}), "
                             f"finite {np.isfinite(arr).all()}")
    for key in ("rmse", "frobenius"):
        vals = np.array([res[key][f"var{i}"] for i in range(n_var)])
        if not np.isfinite(vals).all():
            raise SystemExit(f"non-finite {key}")
    print(f"outputs: {n_var} variables of shape {want_shape}, all finite; RMSE and "
          "Frobenius curves finite")

    # the same full-width model on 2 samples x 2 steps: card (kernel) vs CPU (plain)
    cfg.testing["sequence_length"] = 3
    _, _, test_ds, _ = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                      int(cfg.model.context_size))
    const, pres, prog, _ = next(test_ds.batches(2))
    model = registry.build_model(cfg.model, seed=int(cfg.seed)).eval()
    args = [torch.from_numpy(a) for a in (const, pres, prog)]
    with torch.no_grad():
        ref = model(*args)
        got = model.to("cuda")(*[a.cuda() for a in args]).cpu()
    err = (got - ref).abs().max().item()
    tol = 1e-3  # fp32, two closed-loop steps of 8 blocks; other summation orders
    print(f"reference: full-width Swin, 2 samples x 2 steps, card vs CPU max|diff| "
          f"{err:.3e} (tol {tol:.0e}, |ref| max {ref.abs().max().item():.3f})")
    if not err <= tol:
        raise SystemExit("the card's rollout disagrees with the CPU reference")


def profile_rollout(cfg, card: str):
    """Kernel time by name over one eval batch's 16-step rollout."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.models import registry

    cfg.testing["sequence_length"] = 17
    _, _, test_ds, _ = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                      int(cfg.model.context_size))
    batch = [torch.from_numpy(a).cuda() for a in next(test_ds.batches(EVAL_BATCH))[:3]]
    model = registry.build_model(cfg.model, seed=int(cfg.seed)).cuda().eval()
    with torch.no_grad():
        model(*batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(*batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in rows)
    if total == 0:
        print(f"profile: the profiler saw no device time; breakdown not measured [{card}]")
        return
    print(f"profile: one rollout of batch {EVAL_BATCH} x 16 steps: {wall_us / 1e3:.1f} ms wall "
          f"(under the profiler), device busy {total / 1e3:.1f} ms = {100 * total / wall_us:.1f}% "
          f"[{card}]")
    for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms {100 * e.self_device_time_total / total:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")


# ---------------------------------------------------------------- training path
# The shipped model and training config; data.n_time is raised from 384
# only so that an epoch holds 11 full batches of 32 (357 training windows)
# and the validation split one batch of 14 windows.
TRAIN_ARGV = ["model=swintransformer", "data=synthetic", "data.n_time=1536",
              "training.epochs=2"]


def run_train_path(run_dir: str, counters: dict, card: str):
    import math

    import numpy as np
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=TRAIN_ARGV)
    ctx = int(cfg.model.context_size)
    train_ds, val_ds, _, _ = build_datasets(cfg.data, cfg.training, cfg.validation,
                                            cfg.testing, ctx)
    depth = sum(int(d) for d in cfg.model.depths)
    epochs, bs, vbs = int(cfg.training.epochs), int(cfg.training.batch_size), int(cfg.validation.batch_size)
    n_train = math.ceil(len(train_ds) / bs)
    n_val = math.ceil(len(val_ds) / vbs)
    steps, val_steps = int(cfg.training.sequence_length) - ctx, int(cfg.validation.sequence_length) - ctx
    # remat: every training forward runs twice (once more in the backward)
    want_fwd = epochs * (depth * steps * 2 * n_train + depth * val_steps * n_val)
    want_bwd = epochs * depth * steps * n_train

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.main([*TRAIN_ARGV, f"run_dir={run_dir}", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    print(f"train path: train {' '.join(TRAIN_ARGV)}: {len(train_ds)} training windows "
          f"({n_train} batches of <= {bs}) and {len(val_ds)} validation windows ({n_val} "
          f"batch of <= {vbs}) per epoch, {epochs} epochs; {wall:.1f} s wall (data, model, "
          f"training, validation, checkpoints) [{card}]")
    print(f"train path launches {launches} (want forward {depth} blocks x {steps} steps x 2 "
          f"(remat) x {n_train} batches + {depth} x {val_steps} steps x {n_val} validation "
          f"batches, per epoch x {epochs} = {want_fwd}; backward {depth} x {steps} x "
          f"{n_train} x {epochs} = {want_bwd})")
    if launches != {"flash_window_attention": want_fwd, "flash_window_attention_bwd": want_bwd}:
        raise SystemExit(f"training path launches {launches}, want {want_fwd} forward and "
                         f"{want_bwd} backward")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was not launched on the training path")
    losses = res["train_loss"] + res["val_loss"]
    if len(res["train_loss"]) != epochs or not np.isfinite(losses).all():
        raise SystemExit(f"training losses {res['train_loss']} / {res['val_loss']}")
    for kind in ("best", "last"):
        path = os.path.join(run_dir, "checkpoints", f"{cfg.model.name}_{kind}.ckpt")
        if not os.path.exists(path):
            raise SystemExit(f"no checkpoint {path}")
    for e, (tl, vl) in enumerate(zip(res["train_loss"], res["val_loss"]), 1):
        print(f"train path: epoch {e} train loss {tl:.6f} val loss {vl:.6f}")

    # steady state: full-batch steps after the first (which builds nothing
    # more, but warms cuBLAS/cuDNN and the allocator)
    full = [s for n, s in res["step_seconds"] if n == bs][1:]
    per_step = sum(full) / len(full)
    samples_s = bs / per_step
    points = steps * int(cfg.data.height) * int(cfg.data.width)
    print(f"train path: steady-state {per_step:.4f} s per optimizer step at batch {bs} "
          f"({len(full)} full-batch steps after the first; min {min(full):.4f}, max "
          f"{max(full):.4f}), {samples_s:.2f} samples/s, {samples_s * points:.1f} "
          f"grid-points/s (samples x {steps} steps x {cfg.data.height} x {cfg.data.width}), "
          f"peak device memory {peak:.2f} GiB [{card}]")
    return dict(launches=launches, seconds_per_step=per_step, samples_per_s=samples_s,
                gridpoints_per_s=samples_s * points, peak_gib=peak, wall_s=wall,
                train_loss=res["train_loss"], val_loss=res["val_loss"]), cfg, train_ds


def check_train_grads(cfg, train_ds, card: str):
    """The full-width Swin's loss and every parameter gradient, 2 samples x
    2 steps, on the card (kernels) against the CPU (plain versions)."""
    import torch

    from dlwpbench_tpu_torch.models import registry

    const, pres, prog, target = (torch.from_numpy(a) for a in next(train_ds.batches(2)))
    cpu = registry.build_model({**cfg.model, "remat": True}, seed=int(cfg.seed))
    card_model = registry.build_model({**cfg.model, "remat": True}, seed=int(cfg.seed)).cuda()
    card_model.load_state_dict(cpu.state_dict())
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card_model, "cuda")):
        out = model(*(a.to(dev) for a in (const, pres, prog)))
        loss = torch.mean((out.float() - target.to(dev)) ** 2)
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results["cuda"]
    worst = max(
        ((g_card[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
        for n, g in g_cpu.items()
    )
    # fp32 both sides; the card sums in other orders (kernels, cuBLAS,
    # cuDNN) through 2 steps x 8 blocks forward and backward
    tol = 1e-3
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"gradients: full-width Swin, 2 samples x 2 steps, loss card {l_card:.8f} cpu "
          f"{l_cpu:.8f} (rel {loss_rel:.2e}); worst max|diff|/max|grad| over "
          f"{len(g_cpu)} tensors {worst[0]:.3e} ({worst[1]}) (tol {tol:.0e})")
    if not (worst[0] <= tol and loss_rel <= 1e-5):
        raise SystemExit("the card's gradients disagree with the CPU reference")
    return worst[0]


def profile_train_step(cfg, train_ds, card: str):
    """Kernel time by name over one training step at batch 32."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.training.trainer import Trainer

    batch = next(train_ds.batches(int(cfg.training.batch_size)))
    model = registry.build_model({**cfg.model, "remat": True}, seed=int(cfg.seed)).cuda()
    trainer = Trainer(model, learning_rate=float(cfg.training.learning_rate),
                      weight_decay=float(cfg.training.optimizer_weight_decay))
    state = trainer.init()
    tensors = trainer._to_device(batch)
    trainer.train_step(state, tensors, 1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, tensors, 1e-3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in rows)
    if total == 0:
        print(f"profile: the profiler saw no device time; breakdown not measured [{card}]")
        return
    print(f"profile: one training step at batch {len(batch[2])} (2-step rollout, remat, "
          f"backward, AdamW): {wall_us / 1e3:.1f} ms wall (under the profiler), device busy "
          f"{total / 1e3:.1f} ms = {100 * total / wall_us:.1f}% [{card}]")
    for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms {100 * e.self_device_time_total / total:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from dlwpbench_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_all()
    counters = {"flash_window_attention": fa.flash_window_attention_fwd,
                "flash_window_attention_bwd": fa.flash_window_attention_bwd}
    checks = check_flash(card)
    bwd_checks = check_flash_bwd(card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as out_dir:
        res, eval_launches, cfg = run_main_path(out_dir, counters, card)
        check_outputs(out_dir, res, cfg)
    profile_rollout(cfg, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        train, tcfg, train_ds = run_train_path(run_dir, counters, card)
    check_train_grads(tcfg, train_ds, card)
    profile_train_step(tcfg, train_ds, card)

    # times at stage 0 in fp32, the paths' largest launch; the error is the
    # worst over the fp32 cases (the paths' dtype).  `launches` counts the
    # training path (this slice's), `launches_by_path` both paths.
    kernels = []
    pa = "dlwpbench_tpu/ops/pallas_attention.py"
    for name, src, replaces, also, cases in (
        ("flash_window_attention", "flash_window_attention.cu", f"{pa}:200", None, checks),
        ("flash_window_attention_bwd", "flash_window_attention_bwd.cu", f"{pa}:396",
         f"{pa}:640", bwd_checks),
    ):
        head = cases[0]
        kernels.append(dict(
            name=name, route="cuda", source=f"dlwpbench_tpu_torch/ops/csrc/{src}",
            replaces=replaces, also_replaces=also, launches=train["launches"][name],
            launches_by_path={"evaluate": eval_launches[name], "train": train["launches"][name]},
            max_abs_err=max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=f"{head['case']} q[{head['B']},{head['H']},{head['N']},{head['D']}] {head['dtype']}",
        ))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
