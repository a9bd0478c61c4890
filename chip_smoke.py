#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`dlwpbench_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and nothing is caught:

1. the card: CUDA must be available; prints its name and power limit;
2. builds every kernel under `dlwpbench_tpu_torch/ops/csrc/` from source,
   one nvcc per source, all started together;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes, fp32 and bf16, TF32 off (backward calls twice, which
   must agree bit for bit), and times the kernel, the plain version, the
   least time the card could take (`bound_ms`) and one PyTorch library
   call computing the same function (`library_ms`, a yardstick the port
   never calls);
4. five paths at the shipped widths (32x64 synthetic grid, fp32, seeded
   random weights), each with every launch counter set to 0 just before
   and read just after, and the counts the port's routing rule derives
   from the model's geometry and the batch sizes asserted exactly:
   - Swin evaluate: `python -m dlwpbench_tpu_torch.evaluate
     model=swintransformer data=synthetic` at batch 32, 16-step rollouts
     (flash forward); finite forecasts, the card against the CPU on 2
     samples, a profiler breakdown of one rollout batch;
   - Swin train: `python -m dlwpbench_tpu_torch.train
     model=swintransformer data=synthetic data.n_time=1536
     training.epochs=2` (batch 32, 2-step rollouts, remat, AdamW;
     validation at batch 15 over 14-step rollouts); finite losses,
     checkpoints, card-vs-CPU loss and gradients, a profiler breakdown of
     one training step;
   - Pangu evaluate and train, the same commands with
     `model=panguweather` (the 5D window-attention kernels), with the
     same checks; the card's gradients on the forced 5D route;
   - swin_win8 train: `model.window_size=[8,8]
     model.use_flash_attention=null` for 1 epoch (the token-major
     window-attention kernels);
5. the card line, the `kernels` line and, last, `{"ok": true, ...}`.

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

# The evaluate paths: the shipped configs on synthetic data.  n_time=9060
# makes the synthetic record long enough for 96 biweekly test inits, three
# full eval batches of 32 (the config's testing batch size).
EVAL_TAIL = ["data=synthetic", "data.n_time=9060", "--batch-size", "32",
             "--sequence-length", "17", "--device", "cuda"]
MAIN_ARGV = ["model=swintransformer", *EVAL_TAIL]
PANGU_EVAL_ARGV = ["model=panguweather", *EVAL_TAIL]
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


# ---------------------------------------------------------------- window attention
# (label, layout, qkv shape, nh, window, bias kind, mask kind): the shapes
# the Pangu and Swin-win8 paths give the kernels at batch 32, plus the JAX
# test's L > 1 shape and an odd N.
WINDOW_CASES = [
    ("pangu stage1 shifted", "5d", (32, 2, 36, 72, 576), 6, (2, 6, 12), "earth", "pangu-shift"),
    ("pangu stage1", "5d", (32, 2, 36, 72, 576), 6, (2, 6, 12), "earth", None),
    ("pangu stage2 shifted", "5d", (32, 2, 18, 36, 1152), 12, (2, 6, 12), "earth", "pangu-shift"),
    ("swin8 stage0", "token-major", (32, 1, 32, 64, 288), 4, None, "swin-shared", None),
    ("swin8 stage1 shifted", "token-major", (32, 1, 8, 64, 576), 4, None, "swin-shift", None),
    ("L3 masked", "token-major", (4, 3, 2, 144, 96), 2, None, "random", "block"),
    ("odd N 72 hd 24", "token-major", (16, 2, 4, 72, 144), 2, None, "random", "block"),
]
# Tolerances.  Forward out: fp32 sums over <= 1023 keys in another order
# (|out| < 5 here), bf16 one rounding of the fp32 result (half an ulp is
# 2^-9 of the value); lse is fp32 on both sides.  Backward: a share of
# max|ref| per output, as the flash backward (fp32: sums over <= 1023 keys
# and, for dbias, <= 1152 members in other orders; bf16: one rounding).
WINDOW_TOL = {"float32": {"out": 5e-5, "lse": 5e-5, "bwd": 1e-4},
              "bfloat16": {"out": 2e-2, "lse": 5e-5, "bwd": 1e-2}}


def _window_dims(layout, shape, win):
    """(B, L, nW, N, C) of a token-major qkv or a 5D field."""
    if layout == "5d":
        B, Pl, Lat, Lon, C3 = shape
        return B, Lon // win[2], (Pl // win[0]) * (Lat // win[1]), win[0] * win[1] * win[2], C3 // 3
    B, L, nW, N, C3 = shape
    return B, L, nW, N, C3 // 3


def _window_inputs(layout, shape, nh, win, bias_kind, mask_kind, dtype, gen):
    """qkv, key-major bias, mask (or None) and dO on the card: the models'
    own biases and shift masks where the case names them."""
    import torch

    from dlwpbench_tpu_torch.models.pangu import expand_earth_bias, shift_window_groups_3d
    from dlwpbench_tpu_torch.models.swin import expand_relative_bias, shift_window_groups

    B, L, nW, N, C = _window_dims(layout, shape, win)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    qkv = randn(*shape)
    if bias_kind == "earth":  # the Pangu table, expanded key-major
        bias = expand_earth_bias(randn(win[0] ** 2 * win[1] ** 2 * (2 * win[2] - 1), nW, nh), win)
    elif bias_kind.startswith("swin"):  # 8x8 windows; query-major, swapped as the model does
        rel = expand_relative_bias(randn(15 * 15, nh), 8, 8)
        if bias_kind == "swin-shift":
            groups = torch.as_tensor(shift_window_groups(16, 32, 8, 8, 4, 4), device="cuda")
            rel = rel[None] + torch.where(groups[:, None, :] != groups[:, :, None], -100.0, 0.0)[:, None]
        bias = (rel if rel.ndim == 4 else rel[None]).transpose(-1, -2)
    else:
        bias = randn(nW, nh, N, N)
    mask = None
    if mask_kind == "pangu-shift":
        groups = torch.as_tensor(shift_window_groups_3d(tuple(shape[1:4]), win,
                                                        tuple(w // 2 for w in win)), device="cuda")
        mask = torch.where(groups[:, :, None, :] != groups[:, :, :, None], -100.0, 0.0)
    elif mask_kind == "block":  # symmetric, a different cut per (l, w)
        mask = torch.zeros(L, nW, N, N, device="cuda")
        for lo in range(L):
            for w in range(nW):
                cut = (lo + w + 1) * N // (L + nW + 1)
                mask[lo, w, :cut, cut:] = mask[lo, w, cut:, :cut] = -100.0
    dout = randn(*shape[:-1], C)
    return [None if t is None else t.to(dtype).contiguous() for t in (qkv, bias, mask, dout)]


def _window_bound(B, L, nW, N, C, nh, bW, mask_shape, dname, backward=False):
    """(bound ms, what bounds it, FLOPs, bytes): each input read once and
    each output written once.  Forward: QK^T and PV; qkv, bias, mask read,
    out and lse written.  Backward: QK^T, dP, dV, dK, dQ; qkv, out, dO, lse,
    bias, mask read, dqkv and dbias written."""
    item = 4 if dname == "float32" else 2
    hd = C // nh
    M = B * L * nW * nh
    tokens = B * L * nW * N
    bias_b = bW * nh * N * N * item
    mask_b = 0 if mask_shape is None else mask_shape[0] * mask_shape[1] * N * N * item
    if backward:
        flops = 10 * M * N * N * hd
        nbytes = tokens * (3 * C + 2 * C + 3 * C) * item + M * N * 4 + 2 * bias_b + mask_b
    else:
        flops = 4 * M * N * N * hd
        nbytes = tokens * 4 * C * item + M * N * 4 + bias_b + mask_b
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def _sdpa_args(layout, qkv, bias, mask, nh, win):
    """q, k, v [B*L*nW, nh, N, hd] and the query-major bias + mask broadcast
    over the batch, [B*L*nW, nh, N, N]: one `scaled_dot_product_attention`
    call computes the kernel's function on these (the yardstick)."""
    from dlwpbench_tpu_torch.ops import window_attention as wa

    tok = wa.partition_windows_5d(qkv, win) if layout == "5d" else qkv
    B, L, nW, N, C3 = tok.shape
    hd = C3 // 3 // nh
    q, k, v = (t.reshape(B * L * nW, nh, N, hd) for t in
               tok.reshape(B, L, nW, N, 3, nh, hd).permute(4, 0, 1, 2, 5, 3, 6))
    full = bias.transpose(-1, -2)[None, None]  # [1, 1, bW, nh, Nq, Nk]
    if mask is not None:
        full = full + mask.transpose(-1, -2)[None, :, :, None]
    full = full.expand(B, L, nW, nh, N, N).reshape(B * L * nW, nh, N, N)
    return [t.contiguous() for t in (q, k, v, full)]


def check_window(card: str):
    """Both layouts' forward and backward kernels against their plain
    versions, fp32 and bf16, with repeat determinism and timings."""
    import torch
    import torch.nn.functional as F

    from dlwpbench_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(2)
    checks, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = WINDOW_TOL[dname]
        for label, layout, shape, nh, win, bias_kind, mask_kind in WINDOW_CASES:
            qkv, bias, mask, dout = _window_inputs(layout, shape, nh, win, bias_kind, mask_kind,
                                                   dtype, gen)
            if layout == "5d":
                fwd = lambda *a: wa.window_attention_qkv5d_fwd(*a, win)  # noqa: E731
                bwd = lambda *a: wa.window_attention_qkv5d_bwd(*a, win)  # noqa: E731
                p_fwd = lambda *a: wa.window_attention_qkv5d_plain(*a, win)  # noqa: E731
                p_bwd = lambda *a: wa.window_attention_qkv5d_bwd_plain(*a, win)  # noqa: E731
            else:
                fwd, bwd = wa.window_attention_qkv_fwd, wa.window_attention_qkv_bwd
                p_fwd, p_bwd = wa.window_attention_qkv_plain, wa.window_attention_qkv_bwd_plain
            out, lse = fwd(qkv, bias, mask, nh)
            got = bwd(qkv, bias, mask, out, lse, dout)
            again = bwd(qkv, bias, mask, out, lse, dout)
            torch.cuda.synchronize()
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            f32 = [None if t is None else t.float() for t in (qkv, bias, mask)]
            p_out, p_lse = p_fwd(*f32, nh)
            ref = p_bwd(*f32, out.float(), lse, dout.float())
            errs = {"out": (out.float() - p_out).abs().max().item(),
                    "lse": (lse - p_lse).abs().max().item()}
            ok = identical and errs["out"] <= tol["out"] * max(1.0, p_out.abs().max().item()) \
                and errs["lse"] <= tol["lse"] * max(1.0, p_lse.abs().max().item())
            for name, a, r in zip(("dqkv", "dbias"), got, ref):
                errs[name] = (a.float() - r).abs().max().item()
                errs[name + "_ref_max"] = r.abs().max().item()
                ok = ok and errs[name] <= tol["bwd"] * errs[name + "_ref_max"]
            del again, ref, p_out, p_lse
            ms = cuda_ms(lambda: fwd(qkv, bias, mask, nh), 20)
            bwd_ms = cuda_ms(lambda: bwd(qkv, bias, mask, out, lse, dout), 10)
            plain_ms = cuda_ms(lambda: p_fwd(qkv, bias, mask, nh), 3)
            plain_bwd_ms = cuda_ms(lambda: p_bwd(qkv, bias, mask, out, lse, dout), 3)
            q, k, v, full = _sdpa_args(layout, qkv, bias, mask, nh, win)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full), 10)
            del q, k, v, full
            lib_bwd = _sdpa_backward(*_sdpa_args(layout, qkv, bias, mask, nh, win), 1, 1)
            library_bwd_ms = cuda_ms(lib_bwd, 10)
            del lib_bwd
            B, L, nW, N, C = _window_dims(layout, shape, win)
            mshape = None if mask is None else tuple(mask.shape)
            geo = (B, L, nW, N, C, nh, bias.shape[0], mshape, dname)
            bound_ms, bound_by, flops, nbytes = _window_bound(*geo)
            bwd_bound_ms, bwd_bound_by, bwd_flops, bwd_bytes = _window_bound(*geo, backward=True)
            rec = dict(case=label, layout=layout, dtype=dname, shape=list(shape), nh=nh, N=N,
                       hd=C // nh, bias=list(bias.shape), mask=mshape, errors=errs,
                       fwd_max_abs_err=max(errs["out"], errs["lse"]),
                       bwd_max_abs_err=max(errs["dqkv"], errs["dbias"]), tol=tol,
                       bit_identical=identical, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                       bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms, library_bwd_ms=library_bwd_ms,
                       bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by, bwd_flops=bwd_flops,
                       bwd_bytes=bwd_bytes)
            checks.append(rec)
            print(
                f"window_attention {layout} {dname} {label} qkv{list(shape)} nh {nh} "
                f"bias{list(bias.shape)} mask{list(mshape) if mshape else None}: max|diff| out "
                f"{errs['out']:.3e} lse {errs['lse']:.3e} dqkv {errs['dqkv']:.3e}/"
                f"{errs['dqkv_ref_max']:.3e} dbias {errs['dbias']:.3e}/{errs['dbias_ref_max']:.3e} "
                f"(tol {tol}), two backward calls {'bit-identical' if identical else 'DIFFER'} "
                f"{'ok' if ok else 'FAIL'}; forward kernel {ms:.4f} ms, plain {plain_ms:.4f}, sdpa "
                f"{library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}, {flops / ms / 1e9:.1f} "
                f"TFLOP/s); backward kernel {bwd_ms:.4f} ms, plain {plain_bwd_ms:.4f}, sdpa bwd "
                f"(q, k, v, mask) {library_bwd_ms:.4f}, bound {bwd_bound_ms:.4f} ({bwd_bound_by}, "
                f"{bwd_flops / bwd_ms / 1e9:.1f} TFLOP/s) [{card}]"
            )
            if not ok:
                failures.append(f"window_attention {layout} {dname} {label}")
            del qkv, bias, mask, dout, out, lse, got
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"window-attention kernels disagree with their plain versions: {failures}")
    return checks


# ---------------------------------------------------------------- expected launches
def counters_of():
    """Every kernel wrapper's launch counter, by kernel name."""
    from dlwpbench_tpu_torch.ops import flash_attention as fa
    from dlwpbench_tpu_torch.ops import window_attention as wa

    return {"flash_window_attention": fa.flash_window_attention_fwd,
            "flash_window_attention_bwd": fa.flash_window_attention_bwd,
            "window_attention_qkv": wa.window_attention_qkv_fwd,
            "window_attention_qkv_bwd": wa.window_attention_qkv_bwd,
            "window_attention_qkv5d": wa.window_attention_qkv5d_fwd,
            "window_attention_qkv5d_bwd": wa.window_attention_qkv5d_bwd}


def step_calls(model, B: int) -> dict:
    """Kernel launches of one rollout step's forward on the card at batch
    B, by the port's routing rule (the JAX auto rule with "on the TPU" read
    as "on a CUDA device"), from the model's own geometry."""
    import collections

    from dlwpbench_tpu_torch.models.pangu import PanguWeather

    calls = collections.Counter()
    if isinstance(model, PanguWeather):
        win = model.window_size
        N = win[0] * win[1] * win[2]
        for b, blk in enumerate(model._block_plan()):
            uf = getattr(model, f"EarthSpecificBlock_{b}").use_flash
            pad = blk["pad_res"]
            hd = blk["dim"] // blk["heads"]
            windows = B * (pad[2] // win[2]) * (pad[0] // win[0]) * (pad[1] // win[1])
            small = N < 1024 and hd % 8 == 0 and windows >= 64
            if uf == "packed5d" or (uf in (None, "packed") and small):
                calls["window_attention_qkv5d"] += 1
            elif uf == "packed" or (uf is None and small):
                calls["window_attention_qkv"] += 1
            elif (uf is True or (uf is None and N >= 1024)) and hd % 8 == 0:
                calls["flash_window_attention"] += 1
        return calls
    blk = 0
    for i, st in enumerate(model.plan):  # Swin
        uf = getattr(model, f"SwinBlock_{blk}").WindowAttention_0.use_flash
        N = st["wh"] * st["ww"]
        nW = (st["Hp"] // st["wh"]) * (st["Wp"] // st["ww"])
        hd = model.embed_dim * 2**i // model.num_heads[i]
        packed = uf == "packed" or (uf is None and N < 1024 and hd % 8 == 0 and B * nW >= 64)
        if packed:
            calls["window_attention_qkv"] += model.depths[i]
        elif (uf is True or (uf is None and N >= 1024)) and hd % 8 == 0:
            calls["flash_window_attention"] += model.depths[i]
        blk += model.depths[i]
    return calls


def expected_launches(model, counters, rollouts, backward_rollouts=()):
    """{kernel: launches} over forward rollouts [(batch, steps, passes)] and
    backward rollouts [(batch, steps)]; every other kernel 0."""
    want = {name: 0 for name in counters}
    for B, steps, passes in rollouts:
        for name, n in step_calls(model, B).items():
            want[name] += n * steps * passes
    for B, steps in backward_rollouts:
        for name, n in step_calls(model, B).items():
            want[name + "_bwd"] += n * steps
    return want


def _batch_sizes(n: int, bs: int) -> list[int]:
    return [bs] * (n // bs) + ([n % bs] if n % bs else [])


# ---------------------------------------------------------------- evaluate paths
def run_eval_path(label: str, argv: list, out_dir: str, card: str):
    import torch

    from dlwpbench_tpu_torch import evaluate as cli
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=[a for a in argv if "=" in a])
    counters = counters_of()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.main([*argv, "--out-dir", out_dir])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    steps = int(argv[argv.index("--sequence-length") + 1]) - int(cfg.model.context_size)
    model = registry.build_model(cfg.model)  # its geometry only, for the routing rule
    want = expected_launches(model, counters, [(n, steps, 1) for n, _ in res["batch_seconds"]])
    print(f"{label}: evaluate {' '.join(argv)}: {len(res['batch_seconds'])} batches, {wall:.1f} s "
          f"wall (data, model, rollout, files), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"{label}: batch seconds {[round(s, 4) for _, s in res['batch_seconds']]}, "
          f"steady-state {res['gridpoints_per_s']:.1f} grid-points/s [{card}]")
    print(f"{label}: RMSE var0 per lead {[round(x, 4) for x in res['rmse']['var0']]}")
    print(f"{label} launches {launches} (the routing rule over {len(res['batch_seconds'])} "
          f"batches x {steps} steps wants {want}; no backward under no_grad)")
    if launches != want or not any(launches.values()):
        raise SystemExit(f"{label}: launches {launches}, want {want}")
    check_forecast_files(out_dir, res, cfg, len(res["batch_seconds"]))
    return res, launches, cfg


def check_forecast_files(out_dir: str, res: dict, cfg, n_batches: int):
    import numpy as np

    from dlwpbench_tpu_torch.utils import netcdf3

    data, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    n_var = int(cfg.data.prognostic_channels)
    want_shape = (n_batches * EVAL_BATCH, 16, int(cfg.data.height), int(cfg.data.width))
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


def check_rollout_vs_cpu(cfg):
    """The same full-width model on 2 samples x 2 steps: card (kernels) vs
    CPU (plain)."""
    import torch

    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.models import registry

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
    print(f"reference: full-width {cfg.model.name}, 2 samples x 2 steps, card vs CPU max|diff| "
          f"{err:.3e} (tol {tol:.0e}, |ref| max {ref.abs().max().item():.3f})")
    if not err <= tol:
        raise SystemExit("the card's rollout disagrees with the CPU reference")


def _print_profile(prof, what: str, wall_us: float, card: str, top: int):
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in rows)
    if total == 0:
        print(f"profile: the profiler saw no device time; breakdown not measured [{card}]")
        return
    print(f"profile: {what}: {wall_us / 1e3:.1f} ms wall (under the profiler), device busy "
          f"{total / 1e3:.1f} ms = {100 * total / wall_us:.1f}% [{card}]")
    for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<5d} {e.key[:90]}")


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
    _print_profile(prof, f"{cfg.model.name}, one rollout of batch {EVAL_BATCH} x 16 steps",
                   wall_us, card, 10)


# ---------------------------------------------------------------- training paths
# The shipped model and training config; data.n_time is raised from 384
# only so that an epoch holds 11 full batches of 32 (357 training windows)
# and the validation split one batch of 14 windows.
TRAIN_TAIL = ["data=synthetic", "data.n_time=1536"]
TRAIN_ARGV = ["model=swintransformer", *TRAIN_TAIL, "training.epochs=2"]
PANGU_TRAIN_ARGV = ["model=panguweather", *TRAIN_TAIL, "training.epochs=2"]
# the swin_win8 configuration: fixed 8x8 windows, auto routing
SWIN8_TRAIN_ARGV = ["model=swintransformer", "model.window_size=[8,8]",
                    "model.use_flash_attention=null", *TRAIN_TAIL, "training.epochs=1"]


def run_train_path(label: str, argv: list, run_dir: str, card: str):
    import numpy as np
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=argv)
    ctx = int(cfg.model.context_size)
    train_ds, val_ds, _, _ = build_datasets(cfg.data, cfg.training, cfg.validation,
                                            cfg.testing, ctx)
    epochs, bs, vbs = int(cfg.training.epochs), int(cfg.training.batch_size), int(cfg.validation.batch_size)
    steps, val_steps = int(cfg.training.sequence_length) - ctx, int(cfg.validation.sequence_length) - ctx
    train_bs, val_bs = _batch_sizes(len(train_ds), bs), _batch_sizes(len(val_ds), vbs)
    model = registry.build_model({**cfg.model, "remat": True})  # geometry, for the rule
    counters = counters_of()
    # remat: every training forward runs twice (once more in the backward)
    want = expected_launches(
        model, counters,
        [(b, steps, 2) for b in train_bs * epochs] + [(b, val_steps, 1) for b in val_bs * epochs],
        [(b, steps) for b in train_bs * epochs])
    del model

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.main([*argv, f"run_dir={run_dir}", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    print(f"{label}: train {' '.join(argv)}: {len(train_ds)} training windows (batches "
          f"{train_bs}) and {len(val_ds)} validation windows (batches {val_bs}) per epoch, "
          f"{epochs} epoch(s); {wall:.1f} s wall (data, model, training, validation, "
          f"checkpoints) [{card}]")
    print(f"{label} launches {launches} (the routing rule over those batches, {steps} steps "
          f"x 2 (remat) forward + {steps} backward per training batch, {val_steps} steps per "
          f"validation batch, wants {want})")
    if launches != want or not any(launches.values()):
        raise SystemExit(f"{label}: launches {launches}, want {want}")
    losses = res["train_loss"] + res["val_loss"]
    if len(res["train_loss"]) != epochs or not np.isfinite(losses).all():
        raise SystemExit(f"{label}: training losses {res['train_loss']} / {res['val_loss']}")
    for kind in ("best", "last"):
        path = os.path.join(run_dir, "checkpoints", f"{cfg.model.name}_{kind}.ckpt")
        if not os.path.exists(path):
            raise SystemExit(f"no checkpoint {path}")
    for e, (tl, vl) in enumerate(zip(res["train_loss"], res["val_loss"]), 1):
        print(f"{label}: epoch {e} train loss {tl:.6f} val loss {vl:.6f}")

    # steady state: full-batch steps after the first (which builds nothing
    # more, but warms cuBLAS/cuDNN and the allocator)
    full = [s for n, s in res["step_seconds"] if n == bs][1:]
    per_step = sum(full) / len(full)
    samples_s = bs / per_step
    points = steps * int(cfg.data.height) * int(cfg.data.width)
    print(f"{label}: steady-state {per_step:.4f} s per optimizer step at batch {bs} "
          f"({len(full)} full-batch steps after the first; min {min(full):.4f}, max "
          f"{max(full):.4f}), {samples_s:.2f} samples/s, {samples_s * points:.1f} "
          f"grid-points/s (samples x {steps} steps x {cfg.data.height} x {cfg.data.width}), "
          f"peak device memory {peak:.2f} GiB [{card}]")
    return dict(launches=launches, seconds_per_step=per_step, samples_per_s=samples_s,
                gridpoints_per_s=samples_s * points, peak_gib=peak, wall_s=wall,
                train_loss=res["train_loss"], val_loss=res["val_loss"]), cfg, train_ds


def check_train_grads(cfg, train_ds, card: str, card_route=None):
    """The full-width model's loss and every parameter gradient, 2 samples x
    2 steps, on the card (kernels; `card_route` forces an attention route)
    against the CPU (auto: plain einsum or the kernels' plain versions)."""
    import torch

    from dlwpbench_tpu_torch.models import registry

    const, pres, prog, target = (torch.from_numpy(a) for a in next(train_ds.batches(2)))
    cpu = registry.build_model({**cfg.model, "remat": True}, seed=int(cfg.seed))
    card_cfg = {**cfg.model, "remat": True}
    if card_route is not None:
        card_cfg["use_flash_attention"] = card_route
    card_model = registry.build_model(card_cfg, seed=int(cfg.seed)).cuda()
    card_model.load_state_dict(cpu.state_dict())
    counters = counters_of()
    before = {name: fn.launches for name, fn in counters.items()}
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card_model, "cuda")):
        out = model(*(a.to(dev) for a in (const, pres, prog)))
        loss = torch.mean((out.float() - target.to(dev)) ** 2)
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    used = {n: fn.launches - before[n] for n, fn in counters.items() if fn.launches != before[n]}
    (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results["cuda"]
    worst = max(
        ((g_card[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
        for n, g in g_cpu.items()
    )
    # fp32 both sides; the card sums in other orders (kernels, cuBLAS,
    # cuDNN) through 2 steps of every block forward and backward
    tol = 1e-3
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"gradients: full-width {cfg.model.name} (card route "
          f"{card_route if card_route is not None else cfg.model.use_flash_attention}, "
          f"kernel launches {used}), 2 samples x 2 steps, loss card {l_card:.8f} cpu "
          f"{l_cpu:.8f} (rel {loss_rel:.2e}); worst max|diff|/max|grad| over "
          f"{len(g_cpu)} tensors {worst[0]:.3e} ({worst[1]}) (tol {tol:.0e})")
    if not (worst[0] <= tol and loss_rel <= 1e-5 and used):
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
    _print_profile(prof, f"{cfg.model.name}, one training step at batch {len(batch[2])} "
                   "(2-step rollout, remat, backward, AdamW)", wall_us, card, 12)


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
        import dlwpbench_tpu_torch.ops.window_attention  # noqa: F401
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
    flash = check_flash(card)
    flash_bwd = check_flash_bwd(card)
    window = check_window(card)

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as out_dir:
        _, paths["evaluate"], cfg = run_eval_path("main path", MAIN_ARGV, out_dir, card)
    check_rollout_vs_cpu(cfg)
    profile_rollout(cfg, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        train, tcfg, train_ds = run_train_path("train path", TRAIN_ARGV, run_dir, card)
    paths["train"] = train["launches"]
    check_train_grads(tcfg, train_ds, card)
    profile_train_step(tcfg, train_ds, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pangu_eval_") as out_dir:
        _, paths["pangu_evaluate"], pcfg = run_eval_path("pangu evaluate", PANGU_EVAL_ARGV,
                                                          out_dir, card)
    profile_rollout(pcfg, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pangu_train_") as run_dir:
        ptrain, ptcfg, ptrain_ds = run_train_path("pangu train", PANGU_TRAIN_ARGV, run_dir, card)
    paths["pangu_train"] = ptrain["launches"]
    # at 2 samples stage 2 would take einsum under auto (2 * 3 * 3 < 64)
    check_train_grads(ptcfg, ptrain_ds, card, card_route="packed5d")
    profile_train_step(ptcfg, ptrain_ds, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_swin8_train_") as run_dir:
        s8, _, _ = run_train_path("swin_win8 train", SWIN8_TRAIN_ARGV, run_dir, card)
    paths["swin_win8_train"] = s8["launches"]

    # Each kernel's times at its path's largest case in fp32 (the paths'
    # dtype); the error is the worst over its fp32 cases.  `launches`
    # counts the path of the kernel's slice, `launches_by_path` every path.
    pa = "dlwpbench_tpu/ops/pallas_attention.py"
    csrc = "dlwpbench_tpu_torch/ops/csrc"
    kernels = []
    for name, src, replaces, also, cases in (
        ("flash_window_attention", "flash_window_attention.cu", f"{pa}:200", None, flash),
        ("flash_window_attention_bwd", "flash_window_attention_bwd.cu", f"{pa}:396",
         f"{pa}:640", flash_bwd),
    ):
        head = cases[0]
        kernels.append(dict(
            name=name, route="cuda", source=f"{csrc}/{src}", replaces=replaces,
            also_replaces=also, launches=paths["train"][name],
            launches_by_path={p: c[name] for p, c in paths.items()},
            max_abs_err=max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=f"{head['case']} q[{head['B']},{head['H']},{head['N']},{head['D']}] {head['dtype']}",
        ))
    for name, layout, replaces, slice_path, largest in (
        ("window_attention_qkv", "token-major", f"{pa}:1349", "swin_win8_train", "swin8 stage0"),
        ("window_attention_qkv5d", "5d", f"{pa}:1630", "pangu_train", "pangu stage1 shifted"),
    ):
        fp32 = [c for c in window if c["layout"] == layout and c["dtype"] == "float32"]
        head = next(c for c in fp32 if c["case"] == largest)
        bwd_replaces = f"{pa}:1407" if layout == "token-major" else f"{pa}:1688"
        for kname, pre, rep, err in ((name, "", replaces, "fwd_max_abs_err"),
                                     (name + "_bwd", "bwd_", bwd_replaces, "bwd_max_abs_err")):
            kernels.append(dict(
                name=kname, route="cuda", source=f"{csrc}/window_attention_qkv.cu",
                replaces=rep, launches=paths[slice_path][kname],
                launches_by_path={p: c[kname] for p, c in paths.items()},
                max_abs_err=max(c[err] for c in fp32),
                ms=head[f"{pre}ms"], plain_ms=head[f"plain_{pre}ms"],
                bound_ms=head[f"{pre}bound_ms"], bound_by=head[f"{pre}bound_by"],
                library_ms=head[f"library_{pre}ms"],
                shape=f"{head['case']} qkv{head['shape']} nh {head['nh']} {head['dtype']}",
            ))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
