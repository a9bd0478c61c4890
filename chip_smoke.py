#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`dlwpbench_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and nothing is caught.
They run in this order: the card (1); the build (2) in a thread while
this process drives the U-Net's paths of 4, which launch no attention
kernel; the attention paths of 4; then, once the second process has
ended, the kernel checks (3), the distributed phase and the profile
entry.  A second process of this script (`ScriptProcess`), started before
the build, runs the kernel-free phases of 4 (the graph families, the
ModernUNet family, Navier-Stokes, the spectral families) beside the
build and the attention paths: the card waits on the host for most of
each path, so the two overlap.  A third, started once the kernels are
built, runs the analysis entries' ranks beside the attention paths.  The
paths' seconds, busy shares and rates are taken while the processes
share the card and the host; the kernel checks and the distributed phase
run alone.

1. the card: CUDA must be available; prints its name and power limit;
2. builds every kernel under `dlwpbench_tpu_torch/ops/csrc/` from source,
   one nvcc per source, all started together; prints ptxas's registers
   and spills of the fused instances (window forward and backward, packed
   forward and backward) and of the flash forward's and backward's mma
   kernels, and the instructions per mma of the flash forward's step loop
   (fp32, D 24 and 48) from cuobjdump's SASS;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes, fp32 and bf16, TF32 off (backward calls twice, which
   must agree bit for bit, and so must two flash forward calls; each
   window and packed case's forward and backward must take the designs
   `fwd_route` and `bwd_route` name, and each flash case the ones
   `flash_attention.fwd_route` and `bwd_route` name; one window and one
   packed case lie past the fused region; one flash case is Pangu's flash
   route at stage 1), and
   times the kernel, the old design on the new design's cases (the row
   forwards, the flash forward's row kernel, the four-pass packed
   backward, the flash backward's row passes, through the modules' private
   launchers), the plain version, the
   least time the card could take (`bound_ms`) and one PyTorch library
   call computing the same function (`library_ms`, a yardstick the port
   never calls); the packed kernel (B5) also against the 5D window kernel
   on one Pangu stage-1 field, shifted and unshifted;
4. the paths, each with every launch counter set to 0 just before and
   read just after and the counts asserted exactly (the bf16-instance
   counts too); at the shipped widths (32x64 synthetic grid, seeded
   random weights), with the counts the port's routing rule derives from
   the model's geometry and the batch sizes (no model routes to B5, and
   the U-Net launches no attention kernel at all):
   - Swin evaluate: `python -m dlwpbench_tpu_torch.evaluate
     model=swintransformer data=synthetic` at batch 32, 16-step rollouts
     (flash forward); finite forecasts, the card against the CPU on 2
     samples, a profiler breakdown of one rollout batch;
   - Swin train: `python -m dlwpbench_tpu_torch.train
     model=swintransformer data=synthetic data.n_time=1536
     training.epochs=1` (batch 32, 2-step rollouts, remat, AdamW;
     validation at batch 15 over 14-step rollouts); finite losses,
     checkpoints, card-vs-CPU loss and gradients, a profiler breakdown of
     one training step;
   - Pangu evaluate and train, the same commands with
     `model=panguweather` (the 5D window-attention kernels), with the
     same checks; the card's gradients on the forced 5D route, on its
     flash route and on its token-major route; the training run's best
     checkpoint exported on the card (`python -m
     dlwpbench_tpu_torch.export_model`) and one batch served from the
     artifact: 5D-kernel launches as the routing rule counts them, the
     output against the eager rollout of the same weights;
   - swin_win8 train: `model.window_size=[8,8]
     model.use_flash_attention=null` for 1 epoch (the token-major
     window-attention kernels), its card-vs-CPU gradients on the forced
     token-major route and a profiler breakdown of one training step;
     then its epoch before the prefetch (a pageable copy and a sync per
     step, the trainer's loop until the prefetch) and after it (the
     trainer's own epoch, its steps under
     `torch.cuda.set_sync_debug_mode("error")`), in turns on 768 frames:
     seconds per step, the device's busy share, and what the host does;
   on every path each window forward and backward launch must take the
   fused route, and each flash forward and backward launch the mma
   design, as must every launch of the card-vs-CPU gradient checks (Pangu
   also on its forced flash route);
   - the packed path: B5's public `packed_window_attention` has no model
     caller, so three emulated Pangu attention steps at batch 32 drive it,
     forward and backward at each of the shipped Pangu's 16 blocks' shapes
     (48 launches each way, all 48 forward and 48 backward launches fused,
     0 of every other kernel);
   - U-Net evaluate at `bench.py`'s shape: `python -m
     dlwpbench_tpu_torch.evaluate model=unet
     model.hidden_channels=[64,128,256] data=synthetic data.n_time=9060
     --batch-size 32` (three batches of 16-step rollouts, fp32, 0
     attention launches), the rollout at batch 128 in fp32 and in bf16 (parameters
     and inputs cast as `bench.py` casts them) with and without the host
     copies, and the card against the CPU on 2 samples x 2 steps;
   - training in bf16 compute (`training.compute_dtype=bfloat16`): the
     U-Net at `configs/model/unet.yaml` in fp32 and in bf16, the Swin and
     Pangu for one epoch each in bf16 beside their fp32 paths, every
     training-step attention launch on the kernels' bf16 instances;
     card-vs-CPU bf16 gradients of the Swin and Pangu; a profiler
     breakdown of Pangu's bf16 step with the GEMMs' share;
   - the zarr path, in a temporary working directory: a WeatherBench-layout
     zarr tree written with the port's `zarr_lite` (32x64, 1979-1981,
     6-hourly from 05:00 UTC, `configs/data/weatherbench.yaml`'s 8 + 1 + 4
     channels, time chunked and zlib-compressed); `build_datasets` timed
     (set-up seconds, MB/s, the native decoder's chunks) and the native
     batcher against per-item numpy stacking on the same batches; `python
     -m dlwpbench_tpu_torch.train model=swintransformer data=weatherbench
     data.timedelta=1 data.timedelta_hours=6 training.epochs=1` (every
     flash launch on the mma designs), its s per step, busy share and
     batch-building ms beside the synthetic Swin train path's; `python -m
     dlwpbench_tpu_torch.build_baselines -c RUN_DIR`; `python -m
     dlwpbench_tpu_torch.evaluate -c RUN_DIR --batch-size 32` (ACC finite,
     the files written, flash forwards as the routing rule counts them;
     with `--video`: the comparison plot and the video skipped with their
     messages, the card's machine having neither matplotlib nor ffmpeg);
     the restored checkpoint's rollout on the card against the CPU; then
     serving: the run exported with `python -m
     dlwpbench_tpu_torch.export_model` traced on the card and, a second
     artifact, on the CPU, each served on the card with `python -m
     dlwpbench_tpu_torch.serve` (flash launches counted, the forecast
     within 1e-5 of `evaluate -c`'s, grid-points/s beside evaluate's), and
     a module archive of the checkpoint round-tripped on the card;
   - the HEALPix paths (`configs/data/synthetic_hpx8.yaml`, nside 8), each
     phase's seconds printed: the U-Net's user path in a temporary working
     directory (`train model=unet_hpx data=synthetic_hpx8` 1 epoch,
     `build_baselines -c`, `evaluate -c`: no attention launch, the files on
     the 8 x 8 lat-lon grid, RMSE and ACC finite); the Swin at its shipped
     width on the faces (`model.type=SwinTransformerHPX model.mesh=healpix`:
     evaluate, 3 batches of 32 x 16 steps, and 1 training epoch, every
     flash launch on the mma design, card vs CPU rollout and gradients);
     the same Swin with 8x8 windows at nside 32 (1 epoch, every launch on
     the fused token-major kernels, card vs CPU gradients on that route);
     each training path's s per step, grid-points/s and busy share, after
     an epoch whose steps ran under `set_sync_debug_mode("error")`; the
     U-Net's rollout at nside 32 (hidden 64, 128, 256, batch 32, 16 steps,
     inputs on the card) with the HEALPix pad's share of device time beside
     the convolutions' and concatenations', and card vs CPU; the kernel
     checks of phase 3 include the HEALPix Swin's flash shapes (N 768 with
     the shift bias, N 192) and its token-major shape at nside 32 (192
     windows of 64 tokens), listed under `hpx_cases` in the `kernels` line;
   - the ModernUNet family (no attention kernel: every count 0): the
     ModernUNet at `configs/model/modernunet.yaml`'s shipped width through
     the evaluate CLI (3 batches of 32 x 15 steps) with a profiled rollout
     and card vs CPU, and 1 training epoch in fp32 and in bf16 compute,
     each with its busy share after an epoch under
     `set_sync_debug_mode("error")`, a profiled step split into
     convolutions, GroupNorm and concatenations, and card-vs-CPU
     gradients; `MUNetHPX` (`modernunet_inverted_hpx.yaml`) and both
     diffusion models (`diffusion_modernunet.yaml` with
     `training=diffusion`, and `model.type=DiffMUNetHPX` on the faces)
     through their user paths (train 1 epoch, build_baselines -c,
     evaluate -c with ACC; the diffusion runs on their EMA weights); the
     EMA against its fp64 replay from the step parameters; the denoiser,
     its gradients and 3-step rollouts of both samplers card vs CPU on the
     same noise; every phase step's seconds;
   - Navier-Stokes and the recurrent models (no attention kernel: every
     count 0), in one temporary working directory: `python -m
     dlwpbench_tpu_torch.train model=convlstm data=navier_stokes` with the
     shipped training defaults but 10 epochs (30 shipped), batch 32, `build_baselines
     -c`, `evaluate -c` (batch 4, ACC), then `model=distana` 1 epoch and
     `evaluate -c`; every entry point generates `navier_stokes.yaml`'s
     dataset (16 trajectories, n 64, 50 records of 400 solver steps where
     it ships 1,000) on the card and
     each generation is timed; the first one's fields checked (finite,
     mean-free, no enstrophy growth over the second half), the solver's
     launches per step and busy share profiled, the same initial field
     card vs CPU over 100 steps; each model's s per step, grid-points/s,
     busy share, RMSE per lead beside persistence's, card-vs-CPU rollout
     and gradients; ConvLSTMHPX (`model.mesh=healpix`) and DISTANAHPX 1
     epoch each on `synthetic_hpx8` with card-vs-CPU gradients; `python -m
     dlwpbench_tpu_torch.make_wb_learnable --years 1979 1982
     --inner-steps 5` into a temporary root, timed, and its store loaded
     through `build_datasets` on `data=wb_learnable` with its lag
     autocorrelations;
   - the spectral families (no attention kernel: every count 0; the DFTs
     and SHTs on cuBLAS and cuFFT), each 1 epoch at batch 32 through the
     train CLI with its s per step, grid-points/s, device ops per step,
     busy share and peak memory after an epoch under
     `set_sync_debug_mode("error")`, and its rollout and gradients card vs
     CPU: TFNO (`model=fno`), FourCastNet (`model=fourcastnet`, AFNO) and
     SFNO (`model=sfno`) through their user paths (`build_baselines -c`,
     `evaluate -c` with ACC), FNO (`model.type=FNO2DModule`),
     FourCastNetv2 (`model=fourcastnetv2`, the SFNO mixer) and the
     ModernUNet with its Fourier block (`model.use_fourier=true`) through
     the train CLI; SFNO's profiled training step and its epoch in bf16
     compute; the `fft_impl` branches ("matmul", the default, and "fft")
     of SFNO's spherical convolution and FourCastNet's AFNO filter at the
     shipped shapes against each other, timed, and one SFNO training step
     each way;
   - the graph families (no attention kernel: every count 0; the gathers
     and per-node sums on ATen's `index_select` and `index_add`, the MLPs
     on cuBLAS), each 1 epoch at batch 32 on 448 frames through the train
     CLI with its s per step, grid-points/s, device ops per step, busy
     share and peak memory after an epoch under
     `set_sync_debug_mode("error")`, and its rollout and gradients card vs
     CPU (GraphCast's gradients on 1 sample): GraphCast (`model=graphcast`, 35,232,264
     parameters) and MeshGraphNet (`model=meshgraphnet`, its Delaunay edge
     list) through their user paths (`build_baselines -c`, `evaluate -c`
     at batch 2 with ACC), MeshGraphNet on the 8-stencil
     (`model.graph_type=grid_2d_8stencil`, the stencil movement) through
     the train CLI; each one's profiled training step split into GEMMs,
     gathers and `index_add`, rolls and pads, LayerNorm and the rest;
     GraphCast's epoch in bf16 compute; one GraphCast processor layer at
     the shipped shapes on the gather and the onehot movement, against
     each other and timed;
   - the distributed phase (`run_distributed_paths`): 2 ranks, each a
     process of this script (`dist_rank`) on cuda:0, joined over gloo
     (CUDA tensors staged through pinned host memory; NCCL refuses two
     ranks on one card): the Swin's train path (`TRAIN_ARGV`, its data,
     seed and epochs) with `training.data_parallel=2`, its per-step losses
     and final parameters against the single-rank train path above, the
     two ranks' parameters equal bit for bit, and each rank's flash
     launches those of the single-rank path, all mma; ring attention on
     the flash kernels at the Swin's stage 0 (q[32,4,2048,24], its shifted
     bias) and Pangu's flash route at stage 1 (q[1152,6,144,32], the
     grouped bias with the mask), forward and backward against one kernel
     call on the same inputs, 2 forward and 2 backward launches a rank,
     with one round's kv exchange timed; one forward of the shipped Swin
     with `spmd_mesh` against one without; the halo on [4,64,32,64], the
     sharded HEALPix pad at nside 32 and one partitioned GraphCast forward
     at `graphcast.yaml`'s width against the single-device results; the
     spectral models with `spmd_mesh` at their shipped widths (SFNO under
     `dist_schedule` "per_conv" and "fused", FourCastNet, FourCastNetv2,
     FourCastNet with the FNO2D filter) against the single rank on the
     same weights, forward and every
     parameter gradient summed over the ranks, SFNO in bf16 compute with
     bf16 exchanges too, 0 attention launches; the distributed SHT and
     rFFT2 pairs on [4,256,32,64] against the single-device transforms,
     timed, and one all-to-all's bytes and ms; then a one-rank NCCL
     group's all-reduce, all-to-all and self send/receive on CUDA tensors
     (two-card NCCL needs two cards);
   - the profile entry (`run_profile_paths`): `python -m
     dlwpbench_tpu_torch.profile_model --model unet` (the rollout) and
     `--model swin --train` (the trainer's step, the flash kernels), each
     `profile.json` with its steps, median seconds, FLOPs a step and
     achieved rate, the Swin's count holding every block's attention;
   - the ladder phase (`run_ladder_rows`, `ladder_side_phase`): the
     reference's parameter ladder through `python -m
     dlwpbench_tpu_torch.benchmark_ladder`, one row a call (the remat
     train step at batch 1, 14 rollout steps; 3 steps a row, `--repeats 1
     --iters 1`, where the entry runs 17): in this process, beside
     the attention paths, swin@8m (head dim 56, the flash kernels'
     tensor-core designs), swin@16m and swin@32m (head dims 80 and 120,
     the row kernels), pangu@8m at batch 1 (einsum under the routing
     rule: no kernel) and at batch 2 (the 5D kernels at stage 1),
     swin_win8@2m at 90x180 (the token-major kernels) and swin@8m in bf16
     compute; in the second process the kernel-free rows unet@8m,
     graphcast@2m (then `backfill_graph_flops` on JAX's entry for it),
     diffusion@2m, sfno2d@8m and sfno2d@32m in fp32 and bf16 compute (the
     scaling model's SFNO inputs), the zoo's rollout matrix (`benchmark_models --steps 4
     --iters 1`) and the training matrix (`benchmark_training --models
     unet,swin`, batch 32); every row's width and parameter count against JAX's
     `results/ladder.json`, no row failing, each row's launches by kernel
     against the kernels it must reach; then `ladder_tables` on both
     processes' rows; the kernel checks of phase 3 include every shape
     the ladder's rows give a kernel (the Swin's flash shapes at head dims
     56, 80 and 120, Pangu's 5D stage 1 at batch 2, the 90x180 token-major
     stages; `ladder_cases` in the `kernels` line);
   - the analysis phase (`analysis_process`, `check_analysis`): the
     multi-device analysis entries, each through its own `-m` ranks, in a
     third process from the end of the build: `collective_microbench` on 2
     gloo ranks sharing cuda:0 and on one NCCL rank (the byte audit of the
     distributed spherical conv's forward and backward within 1% of the
     model's claim, the all_to_all fit's four rows), `schedule_audit` on 2
     gloo ranks (the ring attention's round launches the flash forward,
     all on the mma design, one launch inside its exchange's window; the
     fused SFNO's collectives, no attention launch; the K 1 and K 8 step
     times), `benchmark_scaling` on 1 and 2 gloo ranks (the U-Net, no
     attention launch, both rows timed) and with `--spatial 2` on 2 and 4
     ranks (the U-Net on latitude rows over 2 ranks, halo exchanges between
     them; meshes 1x2 and 2x2); then the 2x2 meshes (`run_mesh_paths`): 4
     ranks of this script (`mesh_rank`) sharing cuda:0 over gloo run the 2D
     ring attention on a (2, 2) ("x", "h") mesh at the unshifted Swin stage
     0 and Pangu's flash route (forward and backward against one kernel
     call, 2 forward and 2 backward launches a rank, all mma), the fused
     SFNO stack at `sfno.yaml`'s width on a (2, 2) ("x", "c") mesh with fp32
     and bf16 exchanges (output and every gradient against the single
     device's), and the Swin's train path under `training.multihost=true
     training.model_parallel=2` (a (2, 2) ("data", "x") mesh, 16 rows a
     host; per-step losses and final parameters against the single-rank
     trainer replayed on the same global batches, each x pair's parameters
     equal bit for bit), each rank's peak device memory printed; then, in
     this process after the join, the phase's checks and `scaling_model` on
     the ladder phase's ladder and the phase's microbench file, with the
     bf16-exchange rows of every SFNO family; each output's backend and
     ranks per card printed; the kernel checks of phase 3 include the
     ring's rounds, 1D and 2D (`ring_cases`);
5. the run's seconds, the card line, the `kernels` line (the flash rows'
   `launches_by_path` with the distributed paths, per rank) and, last,
   `{"ok": true, ...}`.

Every time printed stands beside the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of an H100 SXM at 700 W (dense), and HBM3 bandwidth.
# fp32-accurate products run fastest on the tensor cores as 3xTF32 (three
# TF32 products of split operands, as the fused window backward does), so
# the fp32 bound is reckoned at a third of the 495 TFLOP/s TF32 peak, not
# at the 67 TFLOP/s of the fp32 CUDA cores; bf16 at its tensor-core peak.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
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


def build_all(log=print):
    """One nvcc per source under ops/csrc, all at once; raises on a failure.
    Its report goes line by line to `log` (the caller prints it once the
    build is joined when it runs beside other phases)."""
    from dlwpbench_tpu_torch.ops import _build

    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.build, names)))
    for name, path in libs.items():
        log(f"built {name} -> {os.path.relpath(path, REPO)}")
    log(f"build: {len(names)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    fused = [row for lib in ("window_attention_qkv", "packed_window_attention",
                             "flash_window_attention", "flash_window_attention_bwd")
             for row in fused_ptxas(libs[lib][:-3] + ".log")]
    for kind in ("window backward", "window forward", "packed backward", "packed forward",
                 "flash forward mma", "flash backward mma dq", "flash backward mma dbias",
                 "flash backward mma dkv"):
        rows = [r for r in fused if r[0] == kind]
        spilled = [f"{k}: {s} B" for _, k, _, s in rows if s]
        log(f"ptxas -v, the {len(rows)} {kind} instances (dtype, hd, tiles, layout: "
              f"registers): {'; '.join(f'{k}: {r}' for _, k, r, _ in rows)}; spill stores "
              f"{', '.join(spilled) if spilled else 'none'}")
    for inst in ("flash_fwd_mma_kernelIfLi24E", "flash_fwd_mma_kernelIfLi48E"):
        counts = sass_loop_counts(libs["flash_window_attention"], inst)
        log(f"sass, {inst}: " + (
            f"its innermost loop with mma issues {counts[0]} instructions for {counts[1]} mma "
            f"({counts[0] / counts[1]:.2f} an mma)" if counts else
            "cuobjdump not found or no loop with mma in its SASS; not measured"))
    return names


def sass_loop_counts(lib_path: str, instance: str):
    """(instructions, mma) in the body of the innermost loop that holds
    `mma.sync` (HMMA) in the kernel whose mangled name holds `instance`:
    the instructions between a backward branch and its target, from
    cuobjdump's SASS of the library; None without cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=300, cwd=REPO).stdout
    body = sass[sass.index(instance):]
    body = body[:body.index("Function :", 1)] if "Function :" in body[1:] else body
    insts = {}  # address -> (opcode text, branch target address or None)
    for line in body.splitlines():
        if m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line):
            target = re.search(r"\bBRA\s+(0x[0-9a-f]+)", m.group(2))
            insts[int(m.group(1), 16)] = (m.group(2), int(target.group(1), 16) if target else None)
    loops = [(sum(1 for b in insts if t <= b <= a), sum("HMMA" in insts[b][0] for b in insts if t <= b <= a))
             for a, (_, t) in insts.items() if t is not None and t <= a]
    return min((lp for lp in loops if lp[1]), default=None)


FUSED_KINDS = {"wa_bwd": "window backward", "wa_fwd": "window forward",
               "pw_bwd": "packed backward", "pw_fwd": "packed forward",
               "fwd": "flash forward mma", "bwd_dq": "flash backward mma dq",
               "bwd_dbias": "flash backward mma dbias", "bwd_dkv": "flash backward mma dkv"}


def fused_ptxas(log_path: str):
    """[(kind, instance, registers, spill-store bytes)] of every fused
    window or packed kernel, the flash forward's mma kernel and every flash
    backward mma pass, from the ptxas -v report the build keeps beside the
    library."""
    import re

    rows, entry, spill = [], None, 0
    with open(log_path) as f:
        for line in f:
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry, spill = m.group(1), 0
            elif m := re.search(r"(\d+) bytes spill stores", line):
                spill = int(m.group(1))
            elif (m := re.search(r"Used (\d+) registers", line)) and entry:
                if t := re.search(r"(wa_bwd|wa_fwd|pw_bwd|pw_fwd)_fused_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                                  entry):
                    dtype = "fp32" if t.group(2) == "f" else "bf16"
                    layout = ("5D" if "Field5D" in entry else
                              "token-major" if "TokenMajor" in entry else "head-major")
                    rows.append((FUSED_KINDS[t.group(1)],
                                 f"{dtype} hd {t.group(3)} NT {t.group(4)} {layout}",
                                 int(m.group(1)), spill))
                elif t := re.search(r"flash_(fwd|bwd_dq|bwd_dbias|bwd_dkv)_mma_kernelI(\w+?)Li(\d+)E",
                                    entry):
                    dtype = "fp32" if t.group(2) == "f" else "bf16"
                    rows.append((FUSED_KINDS[t.group(1)], f"{dtype} D {t.group(3)}",
                                 int(m.group(1)), spill))
                entry = None
    return rows


# ---------------------------------------------------------------- flash attention
# one round of the 2D (sequence x head) ring on the 4-rank (2, 2) mesh
# (`RING_2D_CASES`): half the heads against one half-sequence kv chunk and
# its bias columns, for the unshifted Swin stage 0 and Pangu's flash route
# (a random bias of the round's shape: the round cuts the shift mask's
# blocks); forward and backward
RING_2D_ROUNDS = [
    ("ring 2d round swin stage0 unshifted (4 ranks)", EVAL_BATCH, 2, 1024, 24, 1, "random"),
    ("ring 2d round pangu flash G=36 (4 ranks)", EVAL_BATCH * 36, 3, 72, 32, 36, "random"),
]
FLASH_CASES = [
    # (label, B, H, N, D, G or 0 for a 3D bias, bias kind)
    ("stage0 unshifted", EVAL_BATCH, 4, 2048, 24, 0, "random"),
    ("stage0 shifted", EVAL_BATCH, 4, 2048, 24, 1, "swin-shift"),
    ("stage1 unshifted", EVAL_BATCH, 4, 512, 48, 0, "random"),
    ("tail N=1000 G=4", 8, 3, 1000, 32, 4, "random"),
    # Pangu's flash route (`use_flash_attention: true`) at stage 1 and batch
    # 32: 32 x nLon 6 x nW 6 windows, the earth bias plus the shift mask, one
    # group per (lon, window)
    ("pangu stage1 flash G=36", EVAL_BATCH * 36, 6, 144, 32, 36, "pangu-shift"),
    # the HEALPix Swin at nside 8: one global window over the 24 x 32
    # rectangle of faces (N 768, shifted bias), and stage 1 (N 192)
    ("hpx stage0 shifted", EVAL_BATCH, 4, 768, 24, 1, "hpx-shift"),
    ("hpx stage1 unshifted", EVAL_BATCH, 4, 192, 48, 0, "random"),
    # the ladder's Swin rows (batch 1): swin@8m (embed 168, heads 3 and 6),
    # head dim 56 at both stages, on the tensor-core designs; swin@16m
    # (embed 240) and swin@32m (embed 360), head dims 80 and 120, past the
    # tensor-core designs' 64: the row kernels
    ("ladder swin8m stage0 shifted", 1, 3, 2048, 56, 1, "swin-shift"),
    ("ladder swin8m stage1 unshifted", 1, 6, 512, 56, 0, "random"),
    ("ladder swin16m stage0 shifted", 1, 3, 2048, 80, 1, "swin-shift"),
    ("ladder swin16m stage1 unshifted", 1, 6, 512, 80, 0, "random"),
    ("ladder swin32m stage0 shifted", 1, 3, 2048, 120, 1, "swin-shift"),
    ("ladder swin32m stage1 unshifted", 1, 6, 512, 120, 0, "random"),
    # one round of the schedule audit's ring attention on 2 ranks (B 2, H
    # 4, N 512, D 32, one bias group): this rank's 256 queries against one
    # 256-token kv chunk and its bias columns
    ("ring round (schedule audit, 2 ranks)", 2, 4, 256, 32, 1, "random"),
    *RING_2D_ROUNDS,
]
# the global window of each shifted-bias kind: the Swin's 32 x 64 grid and
# the HEALPix Swin's 24 x 32 rectangle of nside-8 faces
SHIFT_GRIDS = {"swin-shift": (32, 64), "hpx-shift": (24, 32)}
# fp32: online versus two-pass softmax, sums in another order.  bf16: the
# kernel rounds its fp32 result once to bf16 (half an ulp is < 4e-3 where
# |out| < 2; the bf16 bound grows with max|out| / 2 past that, as at
# Pangu's flash-route case); the plain version is computed in fp32 on the
# same values.
FLASH_TOL = {"float32": {"out": 5e-5, "lse": 5e-5}, "bfloat16": {"out": 1e-2, "lse": 5e-5}}


def _flash_inputs(B, H, N, D, G, kind, dtype, gen):
    import torch

    from dlwpbench_tpu_torch.models.swin import expand_relative_bias, shift_window_groups

    q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen) for _ in range(3))
    shape = (H, N, N) if G == 0 else (G, H, N, N)
    if kind in SHIFT_GRIDS:  # the model's own bias: table + the -100 shift mask
        h, w = SHIFT_GRIDS[kind]
        table = 0.02 * torch.randn((2 * h - 1) * (2 * w - 1), H, device="cuda", generator=gen)
        groups = torch.as_tensor(shift_window_groups(h, w, h, w, h // 2, w // 2), device="cuda")
        mask = torch.where(groups[:, None, :] != groups[:, :, None], -100.0, 0.0)
        bias = expand_relative_bias(table, h, w)[None] + mask[:, None]
    elif kind == "pangu-shift":  # as the model's flash route builds it
        from dlwpbench_tpu_torch.models.pangu import shift_window_mask

        mask = torch.as_tensor(shift_window_mask((2, 36, 72), PANGU_WIN, PANGU_SHIFT),
                               device="cuda")
        bias = (_earth_bias(6, H, gen)[None] + mask[:, :, None]).reshape(G, H, N, N)
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
    """The flash forward against its plain version, fp32 and bf16: each
    case must take the design `fwd_route` names and repeat bit for bit;
    the row kernel is timed beside the mma design."""
    import torch
    import torch.nn.functional as F

    from dlwpbench_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, B, H, N, D, G, kind in FLASH_CASES:
            q, k, v, bias = _flash_inputs(B, H, N, D, G, kind, dtype, gen)
            mma0 = fa.flash_window_attention_fwd.mma_launches
            out, lse = fa.flash_window_attention_fwd(q, k, v, bias)
            again = fa.flash_window_attention_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            design = "mma" if fa.flash_window_attention_fwd.mma_launches - mma0 == 2 else "rows"
            identical = torch.equal(out, again[0]) and torch.equal(lse, again[1])
            del again
            p_out, p_lse = fa.flash_window_attention_plain(q.float(), k.float(), v.float(), bias.float())
            err = (out.float() - p_out).abs().max().item()
            lse_err = (lse - p_lse).abs().max().item()
            tol = dict(FLASH_TOL[dname])
            if dname == "bfloat16":
                tol["out"] *= max(1.0, p_out.abs().max().item() / 2)
            ok = err <= tol["out"] and lse_err <= tol["lse"] and identical \
                and design == fa.fwd_route(N, D)
            ms = cuda_ms(lambda: fa.flash_window_attention_fwd(q, k, v, bias), 20)
            old_ms = None  # the old design at an mma case: the row kernel
            if design == "mma":
                old_ms = cuda_ms(lambda: fa._launch_fwd(q, k, v, bias, route="rows"), 20)
            plain_ms = cuda_ms(lambda: fa.flash_window_attention_plain(q, k, v, bias), 3)
            mask = bias if G <= 1 else bias.repeat(B // G, 1, 1, 1)  # bias[b % G] per b
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20
            )
            bound_ms, bound_by, flops, nbytes = _bound(B, H, N, D, G, dname)
            rec = dict(case=label, dtype=dname, B=B, H=H, N=N, D=D,
                       bias=list(bias.shape), max_abs_err=err, lse_max_abs_err=lse_err,
                       tol=tol, bit_identical=identical, design=design, ms=ms, old_ms=old_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            checks.append(rec)
            print(
                f"flash_window_attention {dname} {label} q[{B},{H},{N},{D}] bias{list(bias.shape)}: "
                f"max|out diff| {err:.3e} max|lse diff| {lse_err:.3e} "
                f"(tol {tol['out']:.1e}/{tol['lse']:.0e}), design {design}, two calls "
                f"{'bit-identical' if identical else 'DIFFER'} {'ok' if ok else 'FAIL'}; "
                f"kernel {ms:.4f} ms"
                + (f" (row kernel {old_ms:.4f})" if old_ms is not None else "")
                + f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
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
    ("hpx stage0 shifted", 32, 4, 768, 24, 1, "hpx-shift"),
    ("hpx stage1 unshifted", 32, 4, 192, 48, 0, "random"),
    ("ladder swin8m stage0 shifted", 1, 3, 2048, 56, 1, "swin-shift"),
    ("ladder swin8m stage1 unshifted", 1, 6, 512, 56, 0, "random"),
    ("ladder swin16m stage0 shifted", 1, 3, 2048, 80, 1, "swin-shift"),
    ("ladder swin16m stage1 unshifted", 1, 6, 512, 80, 0, "random"),
    ("ladder swin32m stage0 shifted", 1, 3, 2048, 120, 1, "swin-shift"),
    ("ladder swin32m stage1 unshifted", 1, 6, 512, 120, 0, "random"),
    *RING_2D_ROUNDS,
    ("ring audit round (2 ranks)", 2, 4, 256, 32, 1, "random"),
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
            bwd = fa.flash_window_attention_bwd
            wg0, mma0 = bwd.wgmma_launches, bwd.mma_launches
            got = fa.flash_window_attention_bwd(*args)
            again = fa.flash_window_attention_bwd(*args)
            torch.cuda.synchronize()
            design = ("wgmma" if bwd.wgmma_launches - wg0 == 2
                      else "mma" if bwd.mma_launches - mma0 == 2 else "rows")
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            ref = fa.flash_window_attention_bwd_plain(*(a.float() for a in args))
            errs, ok = {}, identical and design == fa.bwd_route(N, D)
            for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
                scale = r.abs().max().item()
                errs[name] = (a.float() - r).abs().max().item()
                ok = ok and errs[name] <= FLASH_BWD_TOL[dname] * scale
                errs[name + "_ref_max"] = scale
            del again, ref
            # small cases are host-bound: more calls average the host's jitter
            iters = 10 if B * H * N * N * D > 2 ** 30 else 100
            ms = cuda_ms(lambda: fa.flash_window_attention_bwd(*args), iters)
            # the design each one replaced, timed beside it: the mma passes
            # beside the wgmma ones, the row passes beside the mma ones
            old_design = {"wgmma": "mma", "mma": "rows"}.get(design)
            old_ms = None
            if old_design is not None:
                old_ms = cuda_ms(lambda: fa._launch_bwd(*args, route=old_design), iters)
            plain_ms = cuda_ms(lambda: fa.flash_window_attention_bwd_plain(*args), 3)
            lib_fn = _sdpa_backward(q, k, v, bias, B, G)
            library_ms = cuda_ms(lib_fn, 10)
            del lib_fn
            bound_ms, bound_by, flops, nbytes = _bound(B, H, N, D, G, dname, backward=True)
            rec = dict(case=label, dtype=dname, B=B, H=H, N=N, D=D, bias=list(bias.shape),
                       errors=errs, max_abs_err=max(errs[n] for n in ("dq", "dk", "dv", "dbias")),
                       tol=FLASH_BWD_TOL[dname], bit_identical=identical, design=design,
                       old_design=old_design, ms=ms, old_ms=old_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            checks.append(rec)
            print(
                f"flash_window_attention_bwd {dname} {label} q[{B},{H},{N},{D}] "
                f"bias{list(bias.shape)}: max|diff| "
                + " ".join(f"{n} {errs[n]:.3e}/{errs[n + '_ref_max']:.3e}"
                           for n in ("dq", "dk", "dv", "dbias"))
                + f" (tol {FLASH_BWD_TOL[dname]:.0e} x max|ref|), design {design}, two calls "
                f"{'bit-identical' if identical else 'DIFFER'} {'ok' if ok else 'FAIL'}; "
                f"kernel {ms:.4f} ms"
                + (f" ({old_design} passes {old_ms:.4f})" if old_ms is not None else "")
                + f", plain {plain_ms:.4f} ms, sdpa bwd (q, k, v, mask) "
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
# test's L > 1 shape, an odd N and the ladder rows' shapes.
WINDOW_CASES = [
    ("pangu stage1 shifted", "5d", (32, 2, 36, 72, 576), 6, (2, 6, 12), "earth", "pangu-shift"),
    ("pangu stage1", "5d", (32, 2, 36, 72, 576), 6, (2, 6, 12), "earth", None),
    ("pangu stage2 shifted", "5d", (32, 2, 18, 36, 1152), 12, (2, 6, 12), "earth", "pangu-shift"),
    ("swin8 stage0", "token-major", (32, 1, 32, 64, 288), 4, None, "swin-shared", None),
    ("swin8 stage1 shifted", "token-major", (32, 1, 8, 64, 576), 4, None, "swin-shift", None),
    # the HEALPix Swin's 8x8 windows at nside 32 (the 96 x 128 rectangle of faces)
    ("hpx swin8 stage0", "token-major", (32, 1, 192, 64, 288), 4, None, "swin-shared", None),
    ("L3 masked", "token-major", (4, 3, 2, 144, 96), 2, None, "random", "block"),
    ("odd N 72 hd 24", "token-major", (16, 2, 4, 72, 144), 2, None, "random", "block"),
    # just past the fused backward's region (N 144): the four-pass route
    ("four-pass N 200 hd 32", "token-major", (8, 1, 4, 200, 192), 2, None, "random", "block"),
    # the ladder's rows: pangu@8m at batch 2 (embed 96, head dim 16; its
    # stage-1 blocks, the only ones past the routing rule's 64 windows) and
    # swin_win8@2m at 90x180 (embed 96, head dim 32; the padded 96 x 184
    # grid's 276 windows at stage 0, 72 at stage 1)
    ("ladder pangu8m b2 stage1 shifted", "5d", (2, 2, 36, 72, 288), 6, (2, 6, 12), "earth",
     "pangu-shift"),
    ("ladder pangu8m b2 stage1", "5d", (2, 2, 36, 72, 288), 6, (2, 6, 12), "earth", None),
    ("ladder swin_win8 90x180 stage0 shifted", "token-major", (1, 1, 276, 64, 288), 3, None,
     "swin-shift", None),
    ("ladder swin_win8 90x180 stage1", "token-major", (1, 1, 72, 64, 576), 6, None,
     "swin-shared", None),
]
# the padded grid whose 8x8 windows (shifted by 4) give a "swin-shift"
# case's window count
SWIN8_SHIFT_GRIDS = {8: (16, 32), 276: (96, 184)}
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


def _block_mask(lead, nW, N):
    """[lead, nW, N, N] symmetric {0, -100} masks on the card, a different
    cut per (l, w)."""
    import torch

    mask = torch.zeros(lead, nW, N, N, device="cuda")
    for lo in range(lead):
        for w in range(nW):
            cut = (lo + w + 1) * N // (lead + nW + 1)
            mask[lo, w, :cut, cut:] = mask[lo, w, cut:, :cut] = -100.0
    return mask


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
            groups = torch.as_tensor(shift_window_groups(*SWIN8_SHIFT_GRIDS[nW], 8, 8, 4, 4),
                                     device="cuda")
            rel = rel[None] + torch.where(groups[:, None, :] != groups[:, :, None], -100.0, 0.0)[:, None]
        bias = (rel if rel.ndim == 4 else rel[None]).transpose(-1, -2)
    else:
        bias = randn(nW, nh, N, N)
    mask = None
    if mask_kind == "pangu-shift":
        groups = torch.as_tensor(shift_window_groups_3d(tuple(shape[1:4]), win,
                                                        tuple(w // 2 for w in win)), device="cuda")
        mask = torch.where(groups[:, :, None, :] != groups[:, :, :, None], -100.0, 0.0)
    elif mask_kind == "block":
        mask = _block_mask(L, nW, N)
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
            counter = wa.window_attention_qkv5d_bwd if layout == "5d" else wa.window_attention_qkv_bwd
            fwd_counter = wa.window_attention_qkv5d_fwd if layout == "5d" else wa.window_attention_qkv_fwd
            B, L, nW, N, C = _window_dims(layout, shape, win)
            ffused0 = fwd_counter.fused_launches
            out, lse = fwd(qkv, bias, mask, nh)
            fwd_route = "fused" if fwd_counter.fused_launches - ffused0 == 1 else "row"
            fused0 = counter.fused_launches
            got = bwd(qkv, bias, mask, out, lse, dout)
            again = bwd(qkv, bias, mask, out, lse, dout)
            torch.cuda.synchronize()
            route = "fused" if counter.fused_launches - fused0 == 2 else "four_pass"
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            f32 = [None if t is None else t.float() for t in (qkv, bias, mask)]
            p_out, p_lse = p_fwd(*f32, nh)
            ref = p_bwd(*f32, out.float(), lse, dout.float())
            errs = {"out": (out.float() - p_out).abs().max().item(),
                    "lse": (lse - p_lse).abs().max().item()}
            ok = identical and route == wa.bwd_route(N, C // nh) \
                and fwd_route == wa.fwd_route(N, C // nh) \
                and errs["out"] <= tol["out"] * max(1.0, p_out.abs().max().item()) \
                and errs["lse"] <= tol["lse"] * max(1.0, p_lse.abs().max().item())
            for name, a, r in zip(("dqkv", "dbias"), got, ref):
                errs[name] = (a.float() - r).abs().max().item()
                errs[name + "_ref_max"] = r.abs().max().item()
                ok = ok and errs[name] <= tol["bwd"] * errs[name + "_ref_max"]
            del again, ref, p_out, p_lse
            ms = cuda_ms(lambda: fwd(qkv, bias, mask, nh), 20)
            row_ms = None  # the old design at a fused case: the row forward
            if fwd_route == "fused":
                code = wa._FIELD_5D if layout == "5d" else wa._TOKEN_MAJOR
                m = wa._zero_mask(N, qkv) if mask is None else mask
                row_ms = cuda_ms(lambda: wa._launch_fwd(
                    "row forward", code, qkv, bias, m, nh, win, tuple(out.shape),
                    tuple(lse.shape), route="row"), 20)
            bwd_ms = cuda_ms(lambda: bwd(qkv, bias, mask, out, lse, dout), 10)
            plain_ms = cuda_ms(lambda: p_fwd(qkv, bias, mask, nh), 3)
            plain_bwd_ms = cuda_ms(lambda: p_bwd(qkv, bias, mask, out, lse, dout), 3)
            q, k, v, full = _sdpa_args(layout, qkv, bias, mask, nh, win)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full), 10)
            del q, k, v, full
            lib_bwd = _sdpa_backward(*_sdpa_args(layout, qkv, bias, mask, nh, win), 1, 1)
            library_bwd_ms = cuda_ms(lib_bwd, 10)
            del lib_bwd
            mshape = None if mask is None else tuple(mask.shape)
            geo = (B, L, nW, N, C, nh, bias.shape[0], mshape, dname)
            bound_ms, bound_by, flops, nbytes = _window_bound(*geo)
            bwd_bound_ms, bwd_bound_by, bwd_flops, bwd_bytes = _window_bound(*geo, backward=True)
            rec = dict(case=label, layout=layout, dtype=dname, shape=list(shape), nh=nh, N=N,
                       hd=C // nh, bias=list(bias.shape), mask=mshape, errors=errs,
                       fwd_max_abs_err=max(errs["out"], errs["lse"]),
                       bwd_max_abs_err=max(errs["dqkv"], errs["dbias"]), tol=tol,
                       fwd_route=fwd_route, row_ms=row_ms,
                       bwd_route=route, bit_identical=identical, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms,
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
                f"(tol {tol}), forward route {fwd_route}, backward route {route}, two backward "
                f"calls {'bit-identical' if identical else 'DIFFER'} "
                f"{'ok' if ok else 'FAIL'}; forward kernel {ms:.4f} ms"
                + (f" (row kernel {row_ms:.4f})" if row_ms is not None else "")
                + f", plain {plain_ms:.4f}, sdpa "
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


# ---------------------------------------------------------------- packed window attention
PANGU_WIN = (2, 6, 12)
PANGU_SHIFT = (1, 3, 6)
# (label, BW, nh, N, D, nW, bias kind, mask kind, nLon or the padded field
# of the shift mask): Pangu's earth attention at batch 32 (BW = 32 x nLon x
# nW), the round-2 shape, a random asymmetric mask shared by the windows,
# and a shape past the fused backward's region (N 200: four passes).
PACKED_CASES = [
    ("pangu stage1 shifted", 32 * 6 * 6, 6, 144, 32, 6, "earth", "pangu-shift", (2, 36, 72)),
    ("pangu stage1", 32 * 6 * 6, 6, 144, 32, 6, "earth", None, None),
    ("pangu stage2 shifted", 32 * 3 * 3, 12, 144, 32, 3, "earth", "pangu-shift", (2, 18, 36)),
    ("round-2 N72 hd16", 32 * 3 * 2, 3, 72, 16, 2, "random", "block", 3),
    ("asymmetric mask N100 hd24", 32 * 4 * 4, 4, 100, 24, 4, "random", "random", 4),
    ("four-pass N200 hd32", 32 * 2 * 2, 2, 200, 32, 2, "random", "block", 2),
]
# Tolerances.  out: fp32 sums over <= 144 keys in another order (absolute;
# |out| < 5), bf16 one rounding of the fp32 result (a share of max|ref|).
# lse fp32 on both sides.  Backward, a share of max|ref| per output: fp32
# sums over <= 144 keys and, for dbias, <= 192 problems in other orders;
# bf16 one rounding.
PACKED_TOL = {"float32": {"out": 5e-5, "lse": 5e-5, "bwd": 1e-5},
              "bfloat16": {"out": 1e-2, "lse": 5e-5, "bwd": 1e-2}}


def _earth_bias(nW, nh, gen):
    """A query-major [nW, nh, N, N] bias for Pangu's window, expanded from a
    random earth-position table as the model expands its own."""
    import torch

    from dlwpbench_tpu_torch.models.pangu import expand_earth_bias

    wpl, wlat, wlon = PANGU_WIN
    table = torch.randn(wpl**2 * wlat**2 * (2 * wlon - 1), nW, nh, device="cuda", generator=gen)
    return expand_earth_bias(table, PANGU_WIN).transpose(-1, -2)


def _packed_inputs(BW, nh, N, D, nW, bias_kind, mask_kind, mask_arg, dtype, gen):
    """q, k, v, query-major bias, mask (or None) and dO on the card."""
    import torch

    from dlwpbench_tpu_torch.models.pangu import shift_window_mask

    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    q, k, v, do = (randn(BW, nh, N, D) for _ in range(4))
    bias = _earth_bias(nW, nh, gen) if bias_kind == "earth" else randn(nW, nh, N, N)
    mask = None
    if mask_kind == "pangu-shift":
        mask = torch.as_tensor(shift_window_mask(mask_arg, PANGU_WIN, PANGU_SHIFT), device="cuda")
    elif mask_kind == "block":
        mask = _block_mask(mask_arg, nW, N)
    elif mask_kind == "random":  # asymmetric, window axis 1
        mask = 2.0 * randn(mask_arg, 1, N, N)
        assert not torch.equal(mask, mask.transpose(-1, -2))
    return [None if t is None else t.to(dtype).contiguous() for t in (q, k, v, bias, mask, do)]


def _packed_bound(BW, nh, N, D, nW, mask_shape, dname, backward=False):
    """(bound ms, what bounds it, FLOPs, bytes): each input read once and
    each output written once.  Forward: QK^T and PV; q, k, v, bias, mask
    read, out and lse written.  Backward: QK^T, dP, dV, dK, dQ; q, k, v,
    out, dO, lse, bias, mask read, dq, dk, dv, dbias written."""
    item = 4 if dname == "float32" else 2
    head_b = BW * nh * N * D * item
    bias_b = nW * nh * N * N * item
    mask_b = 0 if mask_shape is None else mask_shape[0] * mask_shape[1] * N * N * item
    if backward:
        flops = 10 * BW * nh * N * N * D
        nbytes = 8 * head_b + BW * nh * N * 4 + 2 * bias_b + mask_b
    else:
        flops = 4 * BW * nh * N * N * D
        nbytes = 4 * head_b + BW * nh * N * 4 + bias_b + mask_b
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def _packed_sdpa_mask(bias, mask, BW):
    """bias[p % nW] + mask[(p // nW) % nLon, p % nW or 0] as one [BW, nh, N,
    N] float mask: `scaled_dot_product_attention` computes B5's function
    with it (the yardstick)."""
    import torch

    nW, nh, N, _ = bias.shape
    full = bias[None].expand(BW // nW, nW, nh, N, N)
    if mask is not None:
        lon = torch.arange(BW // nW, device=bias.device) % mask.shape[0]
        full = full + mask[lon][:, :, None]
    return full.reshape(BW, nh, N, N).contiguous()


def check_packed(card: str):
    """B5's forward and backward kernels against their plain versions,
    fp32 and bf16, with repeat determinism and timings."""
    import torch
    import torch.nn.functional as F

    from dlwpbench_tpu_torch.ops import packed_attention as pk
    from dlwpbench_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(3)
    checks, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = PACKED_TOL[dname]
        for label, BW, nh, N, D, nW, bias_kind, mask_kind, mask_arg in PACKED_CASES:
            q, k, v, bias, mask, do = _packed_inputs(BW, nh, N, D, nW, bias_kind, mask_kind,
                                                     mask_arg, dtype, gen)
            ffused0 = pk.packed_window_attention_fwd.fused_launches
            out, lse = pk.packed_window_attention_fwd(q, k, v, bias, mask)
            fwd_route = "fused" if pk.packed_window_attention_fwd.fused_launches - ffused0 == 1 \
                else "row"
            fused0 = pk.packed_window_attention_bwd.fused_launches
            got = pk.packed_window_attention_bwd(q, k, v, bias, mask, out, lse, do)
            again = pk.packed_window_attention_bwd(q, k, v, bias, mask, out, lse, do)
            torch.cuda.synchronize()
            route = "fused" if pk.packed_window_attention_bwd.fused_launches - fused0 == 2 \
                else "four_pass"
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            f32 = [None if t is None else t.float() for t in (q, k, v, bias, mask)]
            p_out, p_lse = pk.packed_window_attention_plain(*f32)
            ref = pk.packed_window_attention_bwd_plain(*f32, out.float(), lse, do.float())
            errs = {"out": (out.float() - p_out).abs().max().item(),
                    "lse": (lse - p_lse).abs().max().item()}
            out_scale = 1.0 if dname == "float32" else p_out.abs().max().item()
            ok = identical and route == pk._bwd_plan(BW, nh, N, D, nW)[0] \
                and fwd_route == wa.fwd_route(N, D) \
                and errs["out"] <= tol["out"] * out_scale \
                and errs["lse"] <= tol["lse"] * max(1.0, p_lse.abs().max().item())
            for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
                errs[name] = (a.float() - r).abs().max().item()
                errs[name + "_ref_max"] = r.abs().max().item()
                ok = ok and errs[name] <= tol["bwd"] * errs[name + "_ref_max"]
            del again, ref, p_out, p_lse, f32
            args = (q, k, v, bias, mask)
            ms = cuda_ms(lambda: pk.packed_window_attention_fwd(*args), 20)
            row_ms = None  # the old design at a fused case: the row forward
            if fwd_route == "fused":
                m = wa._zero_mask(N, q) if mask is None else mask
                row_ms = cuda_ms(lambda: pk._launch_fwd(q, k, v, bias, m, route="row"), 20)
            bwd_ms = cuda_ms(lambda: pk.packed_window_attention_bwd(*args, out, lse, do), 10)
            four_pass_ms = None  # the old design at a fused case: the four passes
            if route == "fused":
                m = wa._zero_mask(N, q) if mask is None else mask
                four_pass_ms = cuda_ms(lambda: pk._launch_bwd(
                    q, k, v, bias, m, out, lse, do, route="four_pass"), 10)
            plain_ms = cuda_ms(lambda: pk.packed_window_attention_plain(*args), 3)
            plain_bwd_ms = cuda_ms(lambda: pk.packed_window_attention_bwd_plain(*args, out, lse, do), 3)
            full = _packed_sdpa_mask(bias, mask, BW)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full), 10)
            lib_bwd = _sdpa_backward(q, k, v, full, 1, 1)
            library_bwd_ms = cuda_ms(lib_bwd, 10)
            del lib_bwd, full
            mshape = None if mask is None else tuple(mask.shape)
            geo = (BW, nh, N, D, nW, mshape, dname)
            bound_ms, bound_by, flops, nbytes = _packed_bound(*geo)
            bwd_bound_ms, bwd_bound_by, bwd_flops, bwd_bytes = _packed_bound(*geo, backward=True)
            rec = dict(case=label, dtype=dname, q=[BW, nh, N, D], bias=list(bias.shape),
                       mask=mshape, errors=errs, fwd_max_abs_err=max(errs["out"], errs["lse"]),
                       bwd_max_abs_err=max(errs[n] for n in ("dq", "dk", "dv", "dbias")),
                       tol=tol, fwd_route=fwd_route, row_ms=row_ms, bwd_route=route,
                       four_pass_bwd_ms=four_pass_ms,
                       bit_identical=identical, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                       bytes=nbytes, bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms,
                       library_bwd_ms=library_bwd_ms, bwd_bound_ms=bwd_bound_ms,
                       bwd_bound_by=bwd_bound_by, bwd_flops=bwd_flops, bwd_bytes=bwd_bytes)
            checks.append(rec)
            print(
                f"packed_window_attention {dname} {label} q[{BW},{nh},{N},{D}] "
                f"bias{list(bias.shape)} mask{list(mshape) if mshape else None}: max|diff| out "
                f"{errs['out']:.3e} lse {errs['lse']:.3e} "
                + " ".join(f"{n} {errs[n]:.3e}/{errs[n + '_ref_max']:.3e}"
                           for n in ("dq", "dk", "dv", "dbias"))
                + f" (tol {tol}), forward route {fwd_route}, backward route {route}, two "
                f"backward calls {'bit-identical' if identical else 'DIFFER'} "
                f"{'ok' if ok else 'FAIL'}; forward kernel {ms:.4f} ms"
                + (f" (row kernel {row_ms:.4f})" if row_ms is not None else "")
                + f", plain {plain_ms:.4f}, sdpa "
                f"{library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}, {flops / ms / 1e9:.1f} "
                f"TFLOP/s); backward kernel {bwd_ms:.4f} ms"
                + (f" (four-pass kernels {four_pass_ms:.4f})" if four_pass_ms is not None else "")
                + f", plain {plain_bwd_ms:.4f}, sdpa bwd "
                f"(q, k, v, mask) {library_bwd_ms:.4f}, bound {bwd_bound_ms:.4f} ({bwd_bound_by}, "
                f"{bwd_flops / bwd_ms / 1e9:.1f} TFLOP/s) [{card}]"
            )
            if not ok:
                failures.append(f"packed_window_attention {dname} {label}")
            del q, k, v, bias, mask, do, out, lse, got, args
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"packed kernels disagree with their plain versions: {failures}")
    return checks


def check_packed_vs_5d(card: str):
    """Two hand-written kernels of one function: B5 on the partitioned q,
    k, v of a seeded Pangu stage-1 field against `window_attention_qkv5d`
    on the field, shifted and unshifted, fp32, forward and backward."""
    import torch

    from dlwpbench_tpu_torch.models.pangu import shift_window_mask
    from dlwpbench_tpu_torch.ops import packed_attention as pk
    from dlwpbench_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(4)
    (B, Pl, Lat, Lon, C3), nh, win = (EVAL_BATCH, 2, 36, 72, 576), 6, PANGU_WIN
    C, hd = C3 // 3, C3 // 3 // nh
    nLon, nW, N = Lon // win[2], (Pl // win[0]) * (Lat // win[1]), win[0] * win[1] * win[2]
    tol = PACKED_TOL["float32"]

    def heads(x, parts):  # [B, Pl, Lat, Lon, parts*C] -> parts x [BW, nh, N, hd]
        t = wa.partition_windows_5d(x, win).reshape(B, nLon, nW, N, parts, nh, hd)
        return t.permute(4, 0, 1, 2, 5, 3, 6).reshape(parts, B * nLon * nW, nh, N, hd)

    def field(*ts):  # the inverse of `heads`
        t = torch.stack(ts).reshape(len(ts), B, nLon, nW, nh, N, hd)
        t = t.permute(1, 2, 3, 5, 0, 4, 6).reshape(B, nLon, nW, N, len(ts) * C)
        return wa.reverse_windows_5d(t, win, Pl, Lat, Lon)

    for shifted in (True, False):
        qkv5 = torch.randn(B, Pl, Lat, Lon, C3, device="cuda", generator=gen)
        dout5 = torch.randn(B, Pl, Lat, Lon, C, device="cuda", generator=gen)
        bias = _earth_bias(nW, nh, gen).contiguous()
        mask = (torch.as_tensor(shift_window_mask((Pl, Lat, Lon), win, PANGU_SHIFT), device="cuda")
                if shifted else None)
        bias_km = bias.transpose(-1, -2).contiguous()
        out5, lse5 = wa.window_attention_qkv5d_fwd(qkv5, bias_km, mask, nh, win)
        dqkv5, dbias5 = wa.window_attention_qkv5d_bwd(qkv5, bias_km, mask, out5, lse5, dout5, win)
        q, k, v = (t.contiguous() for t in heads(qkv5, 3))
        out, lse = pk.packed_window_attention_fwd(q, k, v, bias, mask)
        dq, dk, dv, dbias = pk.packed_window_attention_bwd(q, k, v, bias, mask, out, lse,
                                                           heads(dout5, 1)[0].contiguous())
        torch.cuda.synchronize()
        pairs = {"out": (field(out), out5), "lse": (lse.reshape(lse5.shape), lse5),
                 "dqkv": (field(dq, dk, dv), dqkv5), "dbias": (dbias.transpose(-1, -2), dbias5)}
        errs = {n: (a - b).abs().max().item() for n, (a, b) in pairs.items()}
        limits = {"out": tol["out"], "lse": tol["lse"] * max(1.0, lse5.abs().max().item()),
                  "dqkv": tol["bwd"] * dqkv5.abs().max().item(),
                  "dbias": tol["bwd"] * dbias5.abs().max().item()}
        ok = all(errs[n] <= limits[n] for n in errs)
        print(f"packed vs 5D: Pangu stage 1 {'shifted' if shifted else 'unshifted'} qkv5"
              f"[{B},{Pl},{Lat},{Lon},{C3}] nh {nh}, fp32: max|B5 - 5D| "
              + " ".join(f"{n} {errs[n]:.3e} (limit {limits[n]:.3e})" for n in errs)
              + f" {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise SystemExit("the packed kernel disagrees with the 5D window kernel")
        del qkv5, dout5, out5, lse5, dqkv5, dbias5, q, k, v, out, lse, dq, dk, dv, dbias, pairs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- expected launches
def build_for(cfg, model_cfg=None, **kwargs):
    """The run's model (`cfg.model`, or `model_cfg`) built for its data's
    grid, which sizes the spectral weights of the models that take it."""
    from dlwpbench_tpu_torch.models import registry

    return registry.build_model(cfg.model if model_cfg is None else model_cfg,
                                grid_shape=registry.data_grid_shape(cfg.data), **kwargs)


def counters_of():
    """Every kernel wrapper's launch counter, by kernel name."""
    from dlwpbench_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def new_design_counter(fn):
    """The attribute counting a two-design kernel's launches of its new
    design ("fused_launches": window and B5 kernels; "mma_launches": the
    flash forward; "wgmma_launches": the flash backward), or None for a
    kernel with one design."""
    return next((a for a in ("fused_launches", "wgmma_launches", "mma_launches")
                 if hasattr(fn, a)), None)


def new_design_launches(counters):
    """{kernel: launches of its new design} of every two-design kernel."""
    return {n: getattr(fn, a) for n, fn in counters.items() if (a := new_design_counter(fn))}


def reset_counters(counters):
    """Every launch counter to 0, each design's and the bf16 ones too."""
    for fn in counters.values():
        fn.launches = fn.bf16_launches = 0
        for attr in ("fused_launches", "wgmma_launches", "mma_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def check_fused(label: str, counters, launches):
    """Every launch of a path's kernels with two designs (the window
    forwards and backwards, B5's forward and backward, the flash forward
    and backward) took the new design: the paths' shapes (window N 64 and
    144 at hd 24, 32, 48; flash D 24, 32 and 48) all lie in its region."""
    fused = new_design_launches(counters)
    print(f"{label} new-design launches (fused; mma and wgmma for the flash kernels) {fused} of "
          f"{({n: launches[n] for n in fused})}")
    if any(fused[n] != launches[n] for n in fused):
        raise SystemExit(f"{label}: new-design launches {fused}, want all of "
                         f"{({n: launches[n] for n in fused})}")
    return fused


def step_calls(model, B: int) -> dict:
    """Kernel launches of one rollout step's forward on the card at batch
    B, by the port's routing rule (the JAX auto rule with "on the TPU" read
    as "on a CUDA device"), from the model's own geometry."""
    import collections

    from dlwpbench_tpu_torch.models.base import RecurrentModel
    from dlwpbench_tpu_torch.models.fno import FNO2DModule
    from dlwpbench_tpu_torch.models.fourcastnet import FourCastNet
    from dlwpbench_tpu_torch.models.graphcast import GraphCastNet
    from dlwpbench_tpu_torch.models.mgn import MeshGraphNet
    from dlwpbench_tpu_torch.models.modern_unet import DiffModernUNet, ModernUNet
    from dlwpbench_tpu_torch.models.pangu import PanguWeather
    from dlwpbench_tpu_torch.models.sfno import SFNO2DModule
    from dlwpbench_tpu_torch.models.unet import UNet

    calls = collections.Counter()
    if isinstance(model, (UNet, ModernUNet, DiffModernUNet, RecurrentModel, FNO2DModule,
                          FourCastNet, SFNO2DModule, GraphCastNet, MeshGraphNet)):
        # convs, GroupNorm, pools, GELU, Dense, LSTM gates, the DFTs and
        # SHTs (cuBLAS, cuFFT), the graphs' gathers and per-node sums (ATen):
        # no attention kernel
        return calls
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
    backward rollouts [(batch, steps)]; every other kernel 0.  A remat
    policy ("full", "dots", "dots_no_batch") does not change the count: each
    recomputes the attention calls (a second forward pass of the step, as
    JAX recomputes its Pallas calls under every policy), which `passes`
    counts; an exported program launches what the eager model does."""
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
def check_launches(label: str, model, launches: dict, want: dict):
    """The counts equal the routing rule's, and a model with attention
    launched its kernels (the U-Net has none: every count 0)."""
    if launches != want or (bool(step_calls(model, EVAL_BATCH)) and not any(launches.values())):
        raise SystemExit(f"{label}: launches {launches}, want {want}")


def run_eval_path(label: str, argv: list, out_dir: str, card: str):
    import torch

    from dlwpbench_tpu_torch import evaluate as cli
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=[a for a in argv if "=" in a])
    counters = counters_of()
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.main([*argv, "--out-dir", out_dir])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    steps = int(argv[argv.index("--sequence-length") + 1]) - int(cfg.model.context_size)
    model = build_for(cfg)  # its geometry only, for the routing rule
    want = expected_launches(model, counters, [(n, steps, 1) for n, _ in res["batch_seconds"]])
    print(f"{label}: evaluate {' '.join(argv)}: {len(res['batch_seconds'])} batches, {wall:.1f} s "
          f"wall (data, model, rollout, files), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"{label}: batch seconds {[round(s, 4) for _, s in res['batch_seconds']]}, "
          f"steady-state {res['gridpoints_per_s']:.1f} grid-points/s [{card}]")
    print(f"{label}: RMSE var0 per lead {[round(x, 4) for x in res['rmse']['var0']]}")
    print(f"{label} launches {launches} (the routing rule over {len(res['batch_seconds'])} "
          f"batches x {steps} steps wants {want}; no backward under no_grad)")
    check_launches(label, model, launches, want)
    fused = check_fused(label, counters, launches)
    batch = int(argv[argv.index("--batch-size") + 1])
    check_forecast_files(out_dir, res, cfg, len(res["batch_seconds"]), batch, steps)
    return res, launches, cfg, fused


def check_forecast_files(out_dir: str, res: dict, cfg, n_batches: int, batch: int, steps: int):
    import numpy as np

    from dlwpbench_tpu_torch.utils import netcdf3

    data, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    n_var = int(cfg.data.prognostic_channels)
    want_shape = (n_batches * batch, steps, int(cfg.data.height), int(cfg.data.width))
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


def tensors_of(*arrays, device="cpu"):
    """Numpy arrays or tensors as tensors on `device`; None (a source
    without constants or prescribed channels) stays None."""
    import torch

    return [None if a is None else torch.as_tensor(a).to(device) for a in arrays]


def check_rollout_vs_cpu(cfg, weights=None, test_ds=None, weights_label="restored"):
    """The same full-width model (seeded, or with `weights`, a state dict)
    on 2 samples x 2 steps of the test split (`test_ds`, or built from
    `cfg`): card (kernels) vs CPU (plain)."""
    import torch

    from dlwpbench_tpu_torch.data.sources import build_datasets

    if test_ds is None:
        cfg.testing["sequence_length"] = 3
        _, _, test_ds, _ = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                          int(cfg.model.context_size))
    test_ds.sequence_length = 3
    const, pres, prog, _ = next(test_ds.batches(2))
    model = build_for(cfg, seed=int(cfg.seed)).eval()
    if weights is not None:
        model.load_state_dict(weights)
    args = tensors_of(const, pres, prog)
    with torch.no_grad():
        ref = model(*args)
        got = model.to("cuda")(*tensors_of(*args, device="cuda")).cpu()
    err = (got - ref).abs().max().item()
    tol = 1e-3  # fp32, two closed-loop steps of 8 blocks; other summation orders
    print(f"reference: full-width {cfg.model.name} ({weights_label if weights is not None else 'seeded'} "
          f"weights), 2 samples x 2 steps, card vs CPU max|diff| "
          f"{err:.3e} (tol {tol:.0e}, |ref| max {ref.abs().max().item():.3f})")
    if not err <= tol:
        raise SystemExit("the card's rollout disagrees with the CPU reference")


GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet")  # cuBLAS / cuDNN kernel names


def _print_profile(prof, what: str, wall_us: float, card: str, top: int):
    """Device time by kernel name under the profiler; returns (busy share,
    the GEMM-like kernels' share of device time), or None when the
    profiler saw no device time."""
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in rows)
    if total == 0:
        print(f"profile: the profiler saw no device time; breakdown not measured [{card}]")
        return None
    gemm = sum(e.self_device_time_total for e in rows
               if any(k in e.key.lower() for k in GEMM_NAMES))
    print(f"profile: {what}: {wall_us / 1e3:.1f} ms wall (under the profiler), device busy "
          f"{total / 1e3:.1f} ms = {100 * total / wall_us:.1f}%; GEMM-like kernels (names with "
          f"{'/'.join(GEMM_NAMES)}, cuDNN's implicit-GEMM convs included) {gemm / 1e3:.2f} ms = "
          f"{100 * gemm / total:.1f}% of device time [{card}]")
    for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<5d} {e.key[:90]}")
    return total / wall_us, gemm / total


def helper_test_split(cfg):
    """The test split of `cfg`, the evaluate path's own data (its frames
    drawn once, `memoise_synthetic_generator`), which the checks beside an
    evaluate path share: a profiled rollout of one batch of 32, card vs
    CPU on 2 samples."""
    from dlwpbench_tpu_torch.data.sources import build_datasets

    return build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                          int(cfg.model.context_size))[2]


def profile_rollout(cfg, card: str, test_ds=None):
    """Kernel time by name over one eval batch's 16-step rollout (of
    `test_ds`, or of the test split built from `cfg`)."""
    import torch

    from dlwpbench_tpu_torch.utils import profiling

    if test_ds is None:
        test_ds = helper_test_split(cfg)
    test_ds.sequence_length = 17
    batch = [torch.from_numpy(a).cuda() for a in next(test_ds.batches(EVAL_BATCH))[:3]]
    model = build_for(cfg, seed=int(cfg.seed)).cuda().eval()
    with torch.no_grad():
        model(*batch)
        torch.cuda.synchronize()
        with profiling.trace() as prof:
            t0 = time.perf_counter()
            model(*batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    steps = 17 - int(cfg.model.context_size)
    _print_profile(prof, f"{cfg.model.name}, one rollout of batch {EVAL_BATCH} x {steps} steps",
                   wall_us, card, 10)


# ---------------------------------------------------------------- training paths
# The shipped model and training config; data.n_time is raised from 384
# only so that an epoch holds 11 full batches of 32 (357 training windows)
# and the validation split one batch of 14 windows.  One epoch each (2
# until the distributed phase, which trains the Swin path again on 2
# ranks, needed the time).
TRAIN_TAIL = ["data=synthetic", "data.n_time=1536"]
TRAIN_ARGV = ["model=swintransformer", *TRAIN_TAIL, "training.epochs=1"]
PANGU_TRAIN_ARGV = ["model=panguweather", *TRAIN_TAIL, "training.epochs=1"]
# the swin_win8 configuration: fixed 8x8 windows, auto routing
SWIN8_TRAIN_ARGV = ["model=swintransformer", "model.window_size=[8,8]",
                    "model.use_flash_attention=null", *TRAIN_TAIL, "training.epochs=1"]


def grid_points(data_cfg) -> int:
    """Points of the grid a model runs on: 12 n^2 HEALPix pixels, else H x W."""
    nside = data_cfg.get("healpix_nside")
    return 12 * int(nside) ** 2 if nside else int(data_cfg.height) * int(data_cfg.width)


def train_splits(argv: list):
    """(train, val): the splits the train CLI builds for `argv`.  Paths on
    one data config and context size share one build (each takes seconds
    of host time)."""
    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=argv)
    return build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                          int(cfg.model.context_size))[:2]


def run_train_path(label: str, argv: list, run_dir: str, card: str, datasets=None,
                   keep_params: bool = False):
    """The train CLI on `argv`; `datasets` (train, val), when given, are
    the splits the CLI builds, already built (the expected launches are
    counted from them).  `keep_params`: the result carries the final
    parameters (CPU copies) and every step's loss."""
    import numpy as np
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=argv)
    ctx = int(cfg.model.context_size)
    train_ds, val_ds = train_splits(argv) if datasets is None else datasets
    epochs, bs, vbs = int(cfg.training.epochs), int(cfg.training.batch_size), int(cfg.validation.batch_size)
    steps, val_steps = int(cfg.training.sequence_length) - ctx, int(cfg.validation.sequence_length) - ctx
    train_bs, val_bs = _batch_sizes(len(train_ds), bs), _batch_sizes(len(val_ds), vbs)
    model = build_for(cfg, {**cfg.model, "remat": True})  # geometry, for the rule
    counters = counters_of()
    # remat: every training forward runs twice (once more in the backward)
    train_rollouts = [(b, steps, 2) for b in train_bs * epochs]
    backward_rollouts = [(b, steps) for b in train_bs * epochs]
    want = expected_launches(model, counters,
                             train_rollouts + [(b, val_steps, 1) for b in val_bs * epochs],
                             backward_rollouts)
    # with bf16 compute every training-step launch takes the bf16 instance;
    # validation runs in fp32, as the JAX trainer's
    bf16_compute = cfg.training.get("compute_dtype") == "bfloat16"
    want_bf16 = (expected_launches(model, counters, train_rollouts, backward_rollouts)
                 if bf16_compute else {name: 0 for name in counters})

    reset_counters(counters)
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
    check_launches(label, model, launches, want)
    del model
    fused = check_fused(label, counters, launches)
    bf16 = {name: fn.bf16_launches for name, fn in counters.items()}
    print(f"{label} bf16-instance launches {bf16} (wants {want_bf16}: "
          + ("every training-step launch, no validation launch)" if bf16_compute else "none)"))
    if bf16 != want_bf16:
        raise SystemExit(f"{label}: bf16 launches {bf16}, want {want_bf16}")
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
    points = steps * grid_points(cfg.data)
    print(f"{label}: steady-state {per_step:.4f} s per optimizer step at batch {bs} "
          f"({len(full)} full-batch steps after the first; min {min(full):.4f}, max "
          f"{max(full):.4f}), {samples_s:.2f} samples/s, {samples_s * points:.1f} "
          f"grid-points/s (samples x {steps} steps x {grid_points(cfg.data)} points), "
          f"peak device memory {peak:.2f} GiB [{card}]")
    return dict(launches=launches, fused=fused, bf16=bf16, seconds_per_step=per_step,
                samples_per_s=samples_s,
                gridpoints_per_s=samples_s * points, peak_gib=peak, wall_s=wall,
                train_loss=res["train_loss"], val_loss=res["val_loss"],
                **({"step_losses": res["step_losses"], "params": {
                    n: p.detach().cpu() for n, p in res["state"].model.named_parameters()}}
                   if keep_params else {})), cfg, train_ds


def perturbed_state(cfg, scale: float = 0.01):
    """The seeded model's parameters, each moved by scale x N(0, 1) (seed
    0): a ModernUNet's zero-initialised convs then carry signal, so a
    rollout is more than persistence and every gradient is exercised."""
    import torch


    model = build_for(cfg, seed=int(cfg.seed))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))
    return model.state_dict()


def check_train_grads(cfg, train_ds, card: str, card_route=None, kernels: bool = True,
                      weights=None, samples: int = 2, reference=None):
    """The full-width model's loss and every parameter gradient, `samples`
    samples x 2 steps, on the card (kernels; `card_route` forces an
    attention route) against the CPU (auto: plain einsum or the kernels'
    plain versions).  Every launch of a kernel with two designs must take
    the new one; a model without attention (`kernels=False`) must launch
    none.  `weights` (a state dict) replaces the seeded init on both
    sides.  `reference`, a dict, keeps the batch and the CPU's result for
    the next call on the same model and weights (another card route, or
    `check_train_grads_bf16`'s fp32 scale): the first call fills it, later
    ones reuse it."""
    import torch

    if reference:
        const, pres, prog, target = reference["batch"]
    else:
        const, pres, prog, target = tensors_of(*next(train_ds.batches(samples)))
    cpu = build_for(cfg, {**cfg.model, "remat": True}, seed=int(cfg.seed))
    if weights is not None:
        cpu.load_state_dict(weights)
    card_cfg = {**cfg.model, "remat": True}
    if card_route is not None:
        card_cfg["use_flash_attention"] = card_route
    card_model = build_for(cfg, card_cfg, seed=int(cfg.seed)).cuda()
    card_model.load_state_dict(cpu.state_dict())
    counters = counters_of()
    before = {name: fn.launches for name, fn in counters.items()}
    before_fused = new_design_launches(counters)
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card_model, "cuda")):
        if name == "cpu" and reference:
            results[name] = reference["cpu"]
            continue
        out = model(*tensors_of(const, pres, prog, device=dev))
        loss = torch.mean((out.float() - target.to(dev)) ** 2)
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    if reference is not None:
        reference["cpu"], reference["batch"] = results["cpu"], (const, pres, prog, target)
    used = {n: fn.launches - before[n] for n, fn in counters.items() if fn.launches != before[n]}
    after_fused = new_design_launches(counters)
    new = {n: after_fused[n] - before_fused[n] for n in before_fused if n in used}
    used.update({f"{n} new design": c for n, c in new.items()})
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
          f"{card_route if card_route is not None else cfg.model.get('use_flash_attention')}, "
          f"kernel launches {used}), {samples} samples x 2 steps, loss card {l_card:.8f} cpu "
          f"{l_cpu:.8f} (rel {loss_rel:.2e}); worst max|diff|/max|grad| over "
          f"{len(g_cpu)} tensors {worst[0]:.3e} ({worst[1]}) (tol {tol:.0e})")
    if not (worst[0] <= tol and loss_rel <= 1e-5 and bool(used) == kernels):
        raise SystemExit("the card's gradients disagree with the CPU reference")
    if any(c != used[n] for n, c in new.items()):
        raise SystemExit(f"gradients: launches {used}, not all on the new designs")
    return worst[0]


def run_trainer(cfg, model, **kw):
    """A Trainer with the run's training settings (the diffusion objective
    and its schedule included), as the train CLI builds it."""
    from dlwpbench_tpu_torch.training.trainer import Trainer

    t = cfg.training
    kw.setdefault("compute_dtype", t.get("compute_dtype"))
    return Trainer(model, learning_rate=float(t.learning_rate),
                   weight_decay=float(t.optimizer_weight_decay),
                   training_type=str(t.get("type", "regular")), seed=int(cfg.seed),
                   num_refinement_steps=int(t.get("num_refinement_steps", 5)),
                   min_noise_std=float(t.get("min_noise_std", 4e-4)),
                   ema_decay=float(t.get("ema_decay", 0.995)), **kw)


def profile_train_step(cfg, train_ds, card: str, compute_dtype=None):
    """Kernel time by name over one training step at batch 32 (in bf16
    compute when `compute_dtype` says so)."""
    import torch

    from dlwpbench_tpu_torch.utils import profiling

    batch = next(train_ds.batches(int(cfg.training.batch_size)))
    model = build_for(cfg, {**cfg.model, "remat": True}, seed=int(cfg.seed)).cuda()
    trainer = run_trainer(cfg, model, compute_dtype=compute_dtype)
    state = trainer.init()
    tensors = trainer._to_device(batch)
    trainer.train_step(state, tensors, 1e-3)
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, tensors, 1e-3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _print_profile(prof, f"{cfg.model.name}, one training step at batch {len(batch[2])} "
                          f"(2-step rollout, remat, backward, AdamW; compute "
                          f"{compute_dtype or 'float32'})", wall_us, card, 12)


# ---------------------------------------------------------------- bf16 compute
# Card vs CPU with bf16 compute, norm-wise over every parameter's fp32
# gradient: ||g_card - g_cpu|| / ||g_cpu||.  The two sides round to bf16
# at other points (cuBLAS and cuDNN against ATen's CPU kernels, the CUDA
# kernels' bf16 instances against their plain versions); bf16's own
# rounding moves these gradients by 0.3% to 2.8% of their norm from fp32's
# at reduced widths on the CPU, and by 0.6% at the full widths (printed
# beside each check).  The loss is held at 1e-2 relative.
BF16_GRAD_TOL = 2e-2


def _grad_distance(got: dict, ref: dict) -> float:
    num = sum(float(((got[n] - g) ** 2).sum()) for n, g in ref.items())
    return (num / sum(float((g ** 2).sum()) for g in ref.values())) ** 0.5


def check_train_grads_bf16(cfg, train_ds, card: str, card_route=None, kernels: bool = True,
                           weights=None, reference=None):
    """The port's bf16 training step (`Trainer._compute_params` and
    `_loss`: bf16 copies of the parameters and inputs, the loss in fp32)
    on the full-width model, 2 samples x 2 steps: the card's loss and fp32
    master gradients against the CPU's, every card launch on the kernels'
    bf16 instances and new designs.  The CPU's fp32 gradients give the
    scale of bf16 rounding itself; `reference`, filled by
    `check_train_grads` on the same model, weights and 2 samples, gives
    the batch and those fp32 gradients (the same MSE, computed once)."""
    import torch

    from dlwpbench_tpu_torch.training.trainer import Trainer

    if reference:
        const, pres, prog, target = reference["batch"]
    else:
        const, pres, prog, target = tensors_of(*next(train_ds.batches(2)))
    cpu = build_for(cfg, {**cfg.model, "remat": True}, seed=int(cfg.seed))
    if weights is not None:
        cpu.load_state_dict(weights)
    card_cfg = {**cfg.model, "remat": True}
    if card_route is not None:
        card_cfg["use_flash_attention"] = card_route
    card_model = build_for(cfg, card_cfg, seed=int(cfg.seed)).cuda()
    card_model.load_state_dict(cpu.state_dict())

    def grads(model, dev, dtype):
        trainer = Trainer(model, compute_dtype=dtype)
        model.zero_grad(set_to_none=True)
        with trainer._compute_params(model):
            loss = trainer._loss(*(a.to(dev) for a in (const, pres, prog, target)))
            loss.backward()
        return loss.item(), {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}

    l32, g32 = reference["cpu"] if reference else grads(cpu, "cpu", None)
    l16, g16 = grads(cpu, "cpu", "bfloat16")
    counters = counters_of()
    before = {n: (fn.launches, fn.bf16_launches) for n, fn in counters.items()}
    before_new = new_design_launches(counters)
    l_card, g_card = grads(card_model, "cuda", "bfloat16")
    used = {n: fn.launches - before[n][0] for n, fn in counters.items() if fn.launches != before[n][0]}
    bf16 = {n: counters[n].bf16_launches - before[n][1] for n in used}
    new = {n: c - before_new[n] for n, c in new_design_launches(counters).items() if n in used}
    dist, bf16_vs_fp32 = _grad_distance(g_card, g16), _grad_distance(g16, g32)
    loss_rel = abs(l_card - l16) / abs(l16)
    print(f"gradients, bf16 compute: full-width {cfg.model.name} (card route "
          f"{card_route if card_route is not None else cfg.model.get('use_flash_attention')}, kernel "
          f"launches {used}, on the bf16 instance {bf16}, on the new design {new}), 2 samples x 2 "
          f"steps: loss card {l_card:.8f} cpu {l16:.8f} (rel {loss_rel:.2e}, tol 1e-2; cpu fp32 "
          f"{l32:.8f}); ||g_card - g_cpu|| / ||g_cpu|| over {len(g16)} tensors {dist:.3e} (tol "
          f"{BF16_GRAD_TOL:.0e}); the CPU's bf16 against its fp32 gradients {bf16_vs_fp32:.3e}")
    if not (dist <= BF16_GRAD_TOL and loss_rel <= 1e-2 and bool(used) == kernels):
        raise SystemExit("the card's bf16 gradients disagree with the CPU's")
    if bf16 != used or any(c != used[n] for n, c in new.items()):
        raise SystemExit(f"bf16 gradients: launches {used}, bf16 {bf16}, new design {new}")
    return dist


# ---------------------------------------------------------------- the U-Net at bench.py's shape
# `bench.py`'s flagship: hidden (64, 128, 256), batch 128, 16-step rollouts
# of the 32x64 synthetic grid (4 constant + 1 prescribed + 8 prognostic
# channels).  The rollout with its inputs on the card takes one batch of
# 128 windows of 17 frames from the training split; the evaluate CLI
# takes the 96 test inits of the evaluate paths' 9,060 frames, three
# batches of 32.  The evaluate CLI draws those frames first (beside the
# build), and the Swin's and Pangu's evaluate paths and, through the
# shared draws, the ModernUNet's read them (`memoise_synthetic_generator`):
# the U-Net's own 6,000 and 3,200 frames took
# about 15 s of host drawing (about 1.7 ms a frame) until the distributed
# spectral checks and the profile entry needed the time (24,000 frames
# and two batches of 128 until the Navier-Stokes phase did; 12,100 frames
# and two batches of 64 until the graph phase did; the rollout's batch
# from 12,100 frames' 128 test inits until the serving phase did).
UNET_EVAL_BATCH = 128
UNET_DRIVE_N_TIME = 9060
UNET_EVAL_ARGV = ["model=unet", "model.hidden_channels=[64,128,256]", *EVAL_TAIL]
UNET_TRAIN_ARGV = ["model=unet", *TRAIN_TAIL, "training.epochs=1"]


def drive_unet_rollout(cfg, card: str):
    """The evaluate path's U-Net rolled over one batch of 128 windows of 17
    frames (from the training split) in fp32 and in bf16, the parameters
    and inputs cast as `bench.py:105-109` casts them: grid-points/s with the host copies (as `rollout_dataset` times a
    batch: copy in, rollout, copy out; the 2 rollouts after the first) and
    with the inputs resident on the card (CUDA events over 3 rollouts,
    `bench.py`'s quantity), a profile of one resident rollout; the bf16
    forecast against the fp32 one; no attention launch."""
    import copy

    import torch

    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.utils import profiling

    cfg.data["n_time"] = UNET_DRIVE_N_TIME
    train_ds = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                              int(cfg.model.context_size))[0]
    train_ds.sequence_length = 17
    batch = next(train_ds.batches(UNET_EVAL_BATCH))
    if batch[2].shape[0] != UNET_EVAL_BATCH:
        raise SystemExit(f"unet rollout: a batch of {batch[2].shape[0]}, want {UNET_EVAL_BATCH}")
    model32 = build_for(cfg, seed=int(cfg.get("seed", 0))).cuda().eval()
    models = {"float32": model32, "bfloat16": copy.deepcopy(model32).to(torch.bfloat16)}
    counters = counters_of()
    reset_counters(counters)
    rates, first = {}, {}
    points = 16 * int(cfg.data.height) * int(cfg.data.width)
    with torch.no_grad():
        for name, model in models.items():
            dtype = getattr(torch, name)
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                args = [torch.from_numpy(a).cuda().to(dtype) for a in batch[:3]]
                first[name] = model(*args).float().cpu()
                secs.append(time.perf_counter() - t0)
            host_rate = UNET_EVAL_BATCH * points * 2 / sum(secs[1:])
            ms = cuda_ms(lambda: model(*args), 3)
            dev_rate = UNET_EVAL_BATCH * points / (ms / 1e3)
            rates[name] = dict(with_copies=host_rate, resident=dev_rate, rollout_ms=ms)
            print(f"unet rollout {name}: hidden {list(model32.hidden_channels)}, batch "
                  f"{UNET_EVAL_BATCH} x 16 steps: {host_rate:.1f} grid-points/s with the host "
                  f"copies (the 2 rollouts after the first; seconds {[round(t, 4) for t in secs]}); "
                  f"{dev_rate:.1f} grid-points/s with the inputs on the card ({ms:.3f} ms a "
                  f"rollout) [{card}]")
            torch.cuda.synchronize()
            with profiling.trace() as prof:
                t0 = time.perf_counter()
                model(*args)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            _print_profile(prof, f"unet {name}, one rollout of batch {UNET_EVAL_BATCH} x 16 "
                           "steps, inputs on the card", wall_us, card, 8)
            del args
    launches = {n: fn.launches for n, fn in counters.items()}
    err = (first["bfloat16"] - first["float32"]).abs().max().item()
    scale = first["float32"].abs().max().item()
    finite = bool(torch.isfinite(first["bfloat16"]).all())
    print(f"unet rollout: bf16 against fp32 on the first batch after 16 steps: max|diff| "
          f"{err:.3e} of max|fp32| {scale:.3f}; bf16 finite {finite}; attention launches "
          f"{launches} (none wanted); bf16 / fp32 speed {rates['bfloat16']['resident'] / rates['float32']['resident']:.2f}x "
          f"resident, {rates['bfloat16']['with_copies'] / rates['float32']['with_copies']:.2f}x with copies")
    if any(launches.values()) or not finite:
        raise SystemExit(f"unet rollout: launches {launches}, bf16 finite {finite}")
    return rates


# ---------------------------------------------------------------- the prefetch
def _copied_model_constants():
    """Patches that put back the Swin's constant tables as they were built
    before `utils.device.device_constant`: copied from pageable host memory
    on every forward (a copy that waits for the card), the relative-position
    offsets too.  Returns the undo."""
    import torch

    from dlwpbench_tpu_torch.models import swin

    saved = swin.device_constant, swin.expand_relative_bias

    def copied(table_fn, *args, device):
        return torch.as_tensor(table_fn(*args), device=device)

    def expand(table, wh, ww):
        nh, N = table.shape[-1], wh * ww
        T = table.reshape(2 * wh - 1, 2 * ww - 1, nh)
        dx = (torch.arange(ww)[:, None] - torch.arange(ww)[None, :] + ww - 1).to(table.device)
        T2 = T[:, dx.reshape(-1)].reshape(2 * wh - 1, ww, ww, nh)
        dy = (torch.arange(wh)[:, None] - torch.arange(wh)[None, :] + wh - 1).to(table.device)
        return T2[dy.reshape(-1)].reshape(wh, wh, ww, ww, nh).permute(4, 0, 2, 1, 3).reshape(nh, N, N)

    swin.device_constant, swin.expand_relative_bias = copied, expand

    def undo():
        swin.device_constant, swin.expand_relative_bias = saved

    return undo


def sync_free_epoch(trainer, state, train_ds, bs: int):
    """`Trainer.train_epoch` with its steps under
    `torch.cuda.set_sync_debug_mode("error")`, which raises on a
    synchronising call (a pageable copy, an item read), up to the epoch's
    one read from the card at its end."""
    import torch

    close = trainer._close_epoch

    def close_after_steps(*a):  # the epoch's one read from the card
        torch.cuda.set_sync_debug_mode("default")
        return close(*a)

    trainer._close_epoch = close_after_steps
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_epoch(state, train_ds, bs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        trainer.__dict__.pop("_close_epoch", None)


def compare_prefetch(cfg, train_ds, card: str):
    """swin_win8's training epoch before and after the prefetch, in turns
    on one model.  "before" is the trainer's loop until this change: each
    batch copied from pageable memory, `Trainer.train_step`, a sync per
    step, timed on the host clock; "before, tables copied per forward" is
    the same with the model's constant tables copied from pageable memory
    on every forward, as they were.  "after" is `Trainer.train_epoch` (pinned
    staging on a side stream, CUDA-event timing), its steps run under
    `torch.cuda.set_sync_debug_mode("error")`, which raises on a
    synchronising call, up to the epoch's one read at its end.  Seconds per
    step (full batches after the first); the device's busy share, its
    kernel and copy time per step (one more epoch of each under the
    profiler) over those seconds; what the host does in an "after" epoch."""
    import torch

    from dlwpbench_tpu_torch.training.trainer import Trainer, cosine_lr
    from dlwpbench_tpu_torch.utils import profiling

    bs = int(cfg.training.batch_size)
    ctx = int(cfg.model.context_size)
    steps = int(cfg.training.sequence_length) - ctx
    model = build_for(cfg, {**cfg.model, "remat": True}, seed=int(cfg.seed)).cuda()
    # many epochs' worth of cosine schedule: the LR stays near its base
    trainer = Trainer(model, learning_rate=float(cfg.training.learning_rate),
                      weight_decay=float(cfg.training.optimizer_weight_decay), epochs=100)
    state = trainer.init()

    def before():
        lr = cosine_lr(state.epoch, trainer.base_lr, trainer.epochs)
        out = []
        for batch in train_ds.batches(bs, shuffle=True):
            t0 = time.perf_counter()
            trainer.train_step(state, trainer._to_device(batch), lr)
            torch.cuda.synchronize()
            out.append((batch[2].shape[0], time.perf_counter() - t0))
        state.epoch += 1
        return out

    def before_copies():
        undo = _copied_model_constants()
        try:
            return before()
        finally:
            undo()

    def after(check_sync: bool = False):
        n0 = len(trainer.timings)
        if check_sync:
            sync_free_epoch(trainer, state, train_ds, bs)
        else:
            trainer.train_epoch(state, train_ds, bs)
        return trainer.timings[n0:]

    def per_step(timed):
        full = [t for n, t in timed if n == bs][1:]
        return sum(full) / len(full), min(full), max(full)

    def device_ms_per_step(run):
        """Kernel and copy time per step of one more epoch under the
        profiler (tracing slows the host, not the kernels)."""
        torch.cuda.synchronize()
        with profiling.trace(host=False) as prof:
            n = len(run())
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA"))
        return dev / 1e3 / n if dev else None

    variants = {"before, tables copied per forward": before_copies, "before": before,
                "after": lambda: after(True)}
    counters = counters_of()
    after()  # warm-up: cuBLAS, the allocator, the pinned pool (one epoch warms every variant)
    reset_counters(counters)
    timed = {name: [] for name in variants}
    for name in [*variants, *reversed(variants)]:  # in turns: A B C C B A
        timed[name].append(per_step(variants[name]()))
    launches = {n: fn.launches for n, fn in counters.items()}
    train_bs = _batch_sizes(len(train_ds), bs)
    epochs = 2 * len(variants)
    want = expected_launches(model, counters, [(b, steps, 2) for b in train_bs * epochs],
                             [(b, steps) for b in train_bs * epochs])
    results = {}
    for name, run in variants.items():
        mean = sum(m for m, _, _ in timed[name]) / len(timed[name])
        dev_ms = device_ms_per_step(run)
        busy = None if dev_ms is None else dev_ms / 1e3 / mean
        results[name] = dict(seconds_per_step=mean, device_ms=dev_ms, busy=busy)
        print(f"swin_win8 prefetch: {name}: " + "; ".join(
            f"{m:.4f} s per step (min {lo:.4f}, max {hi:.4f})" for m, lo, hi in timed[name])
            + f" at batch {bs}; device (kernels and copies) "
            + ("not measured" if dev_ms is None else
               f"{dev_ms:.2f} ms a step under the profiler, busy {100 * busy:.1f}%")
            + f" [{card}]")
    print("swin_win8 prefetch: the after epochs' steps ran with set_sync_debug_mode('error') "
          "and raised nothing")
    print(f"swin_win8 prefetch launches over the {epochs} timed epochs {launches} (wants {want})")
    if launches != want:
        raise SystemExit(f"swin_win8 prefetch: launches {launches}, want {want}")

    # what the host does in an "after" epoch: building the batches alone,
    # then the profiler's host side
    t0 = time.perf_counter()
    n = sum(1 for _ in train_ds.batches(bs, shuffle=True))
    build_s = (time.perf_counter() - t0) / n
    with profiling.trace(device=False) as prof:
        t0 = time.perf_counter()
        after()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    launch_us = sum(e.self_cpu_time_total for e in rows if "LaunchKernel" in e.key)
    print(f"swin_win8 prefetch: host side of one after epoch: {wall / n:.4f} s a step under "
          f"the profiler, building a batch (dataset.batches alone) {build_s:.4f} s, the "
          f"launch calls (cudaLaunchKernel and the like) {launch_us / 1e6 / n:.4f} s a step "
          f"[{card}]")
    for e in rows[:10]:
        print(f"swin_win8 prefetch:   host {e.self_cpu_time_total / 1e3 / n:8.3f} ms a step "
              f"x{e.count // n:<5d} {e.key[:80]}")
    return dict(results=results, launches=launches)


# ---------------------------------------------------------------- the zarr path
# A WeatherBench-layout zarr tree at the real 5.625-degree grid (32 x 64)
# with `configs/data/weatherbench.yaml`'s roles: 8 prognostic channels (t
# at 850 hPa, t2m, u10, v10, z at 300, 500, 700 and 1000 hPa), tisr
# prescribed, 4 constants.  One store per variable and year, 1979-1981, CF
# time 6-hourly from 05:00 UTC (so the test split's biweekly 11:00 UTC
# inits engage), time chunked in 8-day blocks and zlib-compressed (the
# native decoder reads every multi-chunk array).  Cut from WeatherBench:
# hourly data at `timedelta: 6` over 36 training years becomes 6-hourly
# data at `timedelta: 1` over 3 years.
ZARR_YEARS = (1979, 1980, 1981)
ZARR_CHUNK_FRAMES = 32
ZARR_SPLITS = ["data.train_start_date=1979-01-02", "data.train_stop_date=1980-06-30",
               "data.val_start_date=1980-07-01", "data.val_stop_date=1980-12-31",
               "data.test_start_date=1981-01-01", "data.test_stop_date=1981-12-31",
               "data.timedelta=1", "data.timedelta_hours=6"]
# (variable, its directory's name too; levels or None; per level: offset,
# pole-equator contrast, the random walk's std, the seasonal amplitude)
ZARR_VARIABLES = (
    ("t", [850], [(275.0, -30.0, 3.0, 8.0)]),
    ("t2m", None, [(278.0, -40.0, 4.0, 12.0)]),
    ("u10", None, [(0.0, 0.0, 4.0, 0.0)]),
    ("v10", None, [(0.0, 0.0, 3.0, 0.0)]),
    ("z", [300, 500, 700, 1000], [(89000.0, -5000.0, 800.0, 600.0),
                                  (55000.0, -3000.0, 500.0, 400.0),
                                  (29000.0, -1500.0, 300.0, 200.0),
                                  (1000.0, -500.0, 200.0, 100.0)]),
)
ZARR_AR = 0.97  # the walk's persistence per 6 h (decorrelates in about 8 days)


def write_zarr_store(root: str, seed: int = 2024) -> int:
    """Write the tree under `root` with the port's `zarr_lite` (smooth
    mean-reverting random walks from `seed` over a seasonal cycle, in
    physical units; tisr a daily cycle in [0, 1], the HALF_MANUAL table's
    scale); returns its raw bytes."""
    import numpy as np

    from dlwpbench_tpu_torch.data import zarr_lite
    from dlwpbench_tpu_torch.grids.latlon import LatLonGrid

    grid = LatLonGrid(32, 64)
    lat, lon = grid.lats.astype(np.float32), grid.lons.astype(np.float32)
    rng = np.random.default_rng(seed)
    epoch = np.datetime64("1979-01-01T00:00")
    times, hours = [], []
    for year in ZARR_YEARS:
        t = np.arange(np.datetime64(f"{year}-01-01T05:00"), np.datetime64(f"{year + 1}-01-01"),
                      np.timedelta64(6, "h"))
        times.append(t)
        hours.append(((t - epoch) // np.timedelta64(1, "h")).astype(np.int64))
    t_all = np.concatenate(times)
    n_time = len(t_all)
    sin_lat = np.sin(np.deg2rad(lat))[:, None].astype(np.float32)
    day = (t_all - t_all.astype("datetime64[Y]")).astype("timedelta64[h]").astype(np.float32) / 24
    season = np.cos(2 * np.pi * (day - 196.0) / 365.25).astype(np.float32)  # +1 in mid July

    def smooth(x):  # 3-point box filter over lat and lon
        for ax in (-2, -1):
            x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
        return x

    def walk(offset, contrast, std, amp):
        """[T, 32, 64]: offset + contrast sin^2(lat) + amp sin(lat) season
        + an AR(1) walk of stationary std `std` (the box filter takes about
        2/3 of the noise's std; the factor 3 gives it back)."""
        noise = smooth(rng.standard_normal((n_time, 32, 64), dtype=np.float32))
        noise *= np.float32(3 * std * np.sqrt(1 - ZARR_AR ** 2))
        x = np.zeros((32, 64), np.float32)
        for i in range(n_time):
            x = np.float32(ZARR_AR) * x + noise[i]
            noise[i] = x
        return (offset + contrast * sin_lat ** 2 + amp * sin_lat * season[:, None, None]
                + noise).astype(np.float32)

    fields = {(var, var): np.stack([walk(*spec) for spec in specs], axis=1)
              for var, _, specs in ZARR_VARIABLES}  # [T, level, 32, 64]
    hour = (t_all - t_all.astype("datetime64[D]")).astype("timedelta64[h]").astype(np.float32)
    phase = 2 * np.pi * (hour[:, None] / 24.0 + lon[None, :] / 360.0)  # [T, lon]
    fields[("toa_incident_solar_radiation", "tisr")] = np.maximum(
        np.cos(np.deg2rad(lat))[None, None, :, None] * np.cos(phase)[:, None, None, :], 0
    ).astype(np.float32)

    time_attrs = {"units": "hours since 1979-01-01 00:00:00", "calendar": "proleptic_gregorian"}
    compressor = {"id": "zlib", "level": 1}
    levels_of = {var: levels for var, levels, _ in ZARR_VARIABLES}
    jobs = []
    for (dirname, var), data in fields.items():
        lo = 0
        for year, t in zip(ZARR_YEARS, hours):
            store = os.path.join(root, dirname, f"{var}_{year}_5.625deg.zarr")
            coords = {"time": (("time",), t, time_attrs), "lat": (("lat",), lat),
                      "lon": (("lon",), lon)}
            if levels_of.get(var):
                coords["level"] = (("level",), np.asarray(levels_of[var], np.int64))
                dims, arr = ("time", "level", "lat", "lon"), data[lo:lo + len(t)]
            else:
                dims, arr = ("time", "lat", "lon"), data[lo:lo + len(t), 0]
            zarr_lite.write_dataset(store, {}, coords)
            jobs.append((os.path.join(store, var), arr, dims))
            lo += len(t)
    oro = np.maximum(smooth(smooth(rng.standard_normal((32, 64), dtype=np.float32))) * 2000.0, 0)
    consts = {"orography": oro.astype(np.float32), "lsm": (oro > 0).astype(np.float32),
              "lat2d": np.broadcast_to(lat[:, None], (32, 64)).astype(np.float32),
              "lon2d": np.broadcast_to(lon[None, :], (32, 64)).astype(np.float32)}
    zarr_lite.write_dataset(os.path.join(root, "constants", "constants_5.625deg.zarr"),
                            {k: (("lat", "lon"), v) for k, v in consts.items()},
                            {"lat": (("lat",), lat), "lon": (("lon",), lon)})

    def write(job):
        path, arr, dims = job
        zarr_lite.write_array(path, arr, dims, chunks=(ZARR_CHUNK_FRAMES, *arr.shape[1:]),
                              compressor=compressor)
        return arr.nbytes

    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # zlib drops the GIL
        raw = sum(pool.map(write, jobs))
    return raw + sum(v.nbytes for v in consts.values())


def _count_decoder():
    """Wrap the native decoder to count its chunks and seconds; returns
    (counts, undo)."""
    from dlwpbench_tpu_torch.data import native

    real, counts = native.decode_chunks, {"chunks": 0, "calls": 0, "seconds": 0.0}

    def counted(paths, *a, **k):
        t0 = time.perf_counter()
        out = real(paths, *a, **k)
        counts["seconds"] += time.perf_counter() - t0
        counts["chunks"] += len(paths)
        counts["calls"] += 1
        return out

    native.decode_chunks = counted

    def undo():
        native.decode_chunks = real

    return counts, undo


def time_data_layer(argv: list, raw_bytes: int, card: str):
    """`build_datasets` on the store (set-up seconds, MB/s, the decoder's
    chunks), then the native batcher against the per-item numpy stacking
    on the same training windows at batch 32."""
    import numpy as np

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data import native
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=argv)
    counts, undo = _count_decoder()
    try:
        t0 = time.perf_counter()
        splits = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                int(cfg.model.context_size))
        setup_s = time.perf_counter() - t0
    finally:
        undo()
    train_ds, val_ds, test_ds, _ = splits
    mb = raw_bytes / 1e6
    print(f"zarr data: build_datasets {setup_s:.2f} s for {mb:.1f} MB raw ({mb / setup_s:.1f} "
          f"MB/s, normalisation and splits included); the native decoder read "
          f"{counts['chunks']} chunks in {counts['calls']} calls, {counts['seconds']:.2f} s "
          f"({mb / counts['seconds']:.1f} MB/s); splits train {train_ds.prognostic.shape} "
          f"val {val_ds.prognostic.shape} test {test_ds.prognostic.shape}, {len(test_ds)} "
          f"test inits [{card}]")
    if counts["chunks"] == 0 or test_ds.init_indices is None:
        raise SystemExit("zarr data: the native decoder read nothing or no test inits")

    bs = int(cfg.training.batch_size)
    order = np.random.default_rng(0).permutation(len(train_ds))
    groups = [order[i:i + bs] for i in range(0, len(order) - bs + 1, bs)]
    times = {"native": 0.0, "numpy": 0.0}
    for idxs in groups:
        starts = np.asarray([train_ds.window_start(j) for j in idxs], np.int64)
        t0 = time.perf_counter()
        fast = train_ds._batch_native(starts)
        times["native"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        slow = train_ds._batch_items(idxs)
        times["numpy"] += time.perf_counter() - t0
        if any(not np.array_equal(a, b) for a, b in zip(fast, slow)):
            raise SystemExit("zarr data: the native batch differs from the per-item one")
    ms = {k: 1e3 * v / len(groups) for k, v in times.items()}
    print(f"zarr data: a training batch of {bs} windows x {train_ds.sequence_length + 1} "
          f"frames: native batcher {ms['native']:.3f} ms, per-item numpy stacking "
          f"{ms['numpy']:.3f} ms ({ms['numpy'] / ms['native']:.2f}x), over {len(groups)} "
          f"shuffled batches, equal bit for bit [{card}]")
    # the gather alone, on the batcher's 4 threads and on 1
    for threads in (native.BATCH_THREADS, 1):
        t0 = time.perf_counter()
        for idxs in groups:
            starts = np.asarray([train_ds.window_start(j) for j in idxs], np.int64)
            native.assemble_windows(train_ds.prognostic, starts, train_ds.sequence_length + 1,
                                    n_threads=threads)
        ms[f"gather_{threads}"] = 1e3 * (time.perf_counter() - t0) / len(groups)
    print(f"zarr data: the prognostic gather alone (assemble_windows, 8 MB a batch): "
          f"{ms[f'gather_{native.BATCH_THREADS}']:.3f} ms on {native.BATCH_THREADS} threads, "
          f"{ms['gather_1']:.3f} ms on 1 [{card}]")
    return dict(setup_s=setup_s, mb=mb, decoder=counts, batch_ms=ms), cfg, splits


def batch_build_ms(ds, bs: int) -> float:
    """Host ms to build one shuffled training batch (an epoch's worth)."""
    t0 = time.perf_counter()
    n = sum(1 for _ in ds.batches(bs, shuffle=True))
    return 1e3 * (time.perf_counter() - t0) / n


def epoch_busy(cfg, train_ds, check_sync: bool = False):
    """One training epoch of the model under the profiler: (device time,
    kernels and copies, per step in ms; its share of the epoch's step
    seconds; the device ops (kernels, copies, memsets) launched per step),
    or (None, None, None) when the profiler sees no device time.  With
    `check_sync`, an epoch before it runs its steps under
    `set_sync_debug_mode("error")` (`sync_free_epoch`)."""
    import torch

    from dlwpbench_tpu_torch.utils import profiling

    model = build_for(cfg, {**cfg.model, "remat": True}, seed=int(cfg.seed)).cuda()
    trainer = run_trainer(cfg, model, epochs=100)
    state = trainer.init()
    if check_sync:
        sync_free_epoch(trainer, state, train_ds, int(cfg.training.batch_size))
        trainer.timings.clear()
    torch.cuda.synchronize()
    with profiling.trace(host=False) as prof:
        trainer.train_epoch(state, train_ds, int(cfg.training.batch_size))
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in rows)
    if not dev_us:
        return None, None, None
    steps = len(trainer.timings)
    return (dev_us / 1e3 / steps, dev_us / 1e6 / sum(t for _, t in trainer.timings),
            sum(e.count for e in rows) / steps)


def run_zarr_path(card: str, synthetic):
    """The phase "zarr path", in a temporary working directory (the
    baselines and the evaluator's climatology live under `./outputs/`):
    write the store, time the data layer, train the shipped Swin 1 epoch
    on it through the train CLI, build the baselines, evaluate the run's
    best checkpoint with ACC through `evaluate -c`, and hold the card's
    rollout of the checkpoint against the CPU's.  `synthetic` is the
    synthetic Swin train path's (results, cfg, train_ds) of this run."""
    import numpy as np
    import torch

    from dlwpbench_tpu_torch import build_baselines, evaluate as eval_cli
    from dlwpbench_tpu_torch.training.trainer import checkpoint_path

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zarr_") as work:
        os.chdir(work)
        try:
            root = os.path.join(work, "wb_zarr")
            t0 = time.perf_counter()
            raw = write_zarr_store(root)
            print(f"zarr store: {raw / 1e6:.1f} MB raw, years {list(ZARR_YEARS)}, 32 x 64, "
                  f"written in {time.perf_counter() - t0:.2f} s [{card}]")
            data_argv = ["data=weatherbench", f"data.data_path={root}", *ZARR_SPLITS]
            argv = ["model=swintransformer", *data_argv, "training.epochs=1"]
            data, cfg, (train_ds, val_ds, test_ds, _) = time_data_layer(argv, raw, card)

            run_dir = os.path.join(work, "runs", "swin")
            train, _, _ = run_train_path("zarr train", argv, run_dir, card,
                                         datasets=(train_ds, val_ds))
            syn, scfg, sds = synthetic
            bs = int(cfg.training.batch_size)
            for label, res, rcfg, ds in (("synthetic", syn, scfg, sds),
                                         ("zarr", train, cfg, train_ds)):
                dev_ms, busy, _ = epoch_busy(rcfg, ds)
                res["device_ms"], res["busy"] = dev_ms, busy
                res["batch_build_ms"] = batch_build_ms(ds, bs)
                print(f"zarr path, Swin train on {label} data: {res['seconds_per_step']:.4f} s "
                      f"per step at batch {bs}; device "
                      + ("not measured" if dev_ms is None else
                         f"{dev_ms:.2f} ms a step, busy {100 * busy:.1f}% of the steps' "
                         f"seconds (one more epoch under the profiler, its short last "
                         f"batch included)")
                      + f"; the host builds a batch in {res['batch_build_ms']:.3f} ms [{card}]")

            t0 = time.perf_counter()
            base = build_baselines.main(["-c", run_dir])
            print(f"zarr baselines: build_baselines -c in {time.perf_counter() - t0:.2f} s; "
                  f"RMSE z500 at the last lead: persistence "
                  f"{base['persistence']['rmse']['z500'][-1]:.2f}, climatology "
                  f"{base['climatology']['rmse']['z500'][-1]:.2f} [{card}]")

            counters = counters_of()
            reset_counters(counters)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_Tee(sys.stdout)) as out:
                res = eval_cli.main(["-c", run_dir, "--batch-size", "32", "--video",
                                     "--device", "cuda"])["swin"]
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            check_plot_skips(out.getvalue())
            model = build_for(cfg)  # its geometry only, for the routing rule
            steps = 16
            want = expected_launches(model, counters,
                                     [(n, steps, 1) for n, _ in res["batch_seconds"]])
            print(f"zarr evaluate -c: {len(res['batch_seconds'])} batches of "
                  f"{[n for n, _ in res['batch_seconds']]} x {steps} steps, {wall:.1f} s wall; "
                  f"steady-state {res['gridpoints_per_s']:.1f} grid-points/s [{card}]")
            print(f"zarr evaluate launches {launches} (the routing rule wants {want})")
            check_launches("zarr evaluate", model, launches, want)
            fused = check_fused("zarr evaluate", counters, launches)
            acc = np.array([res["acc"][v] for v in res["variables"]])
            out_dir = os.path.join(run_dir, "evaluation")
            missing = [f for f in ("inits.nc", "outputs.nc", "targets.nc", "rmses.nc",
                                   "accs.nc", "metrics.json") if not os.path.exists(
                                       os.path.join(out_dir, f))]
            if not np.isfinite(acc).all() or missing:
                raise SystemExit(f"zarr evaluate: ACC finite {np.isfinite(acc).all()}, "
                                 f"missing files {missing}")
            print(f"zarr evaluate: ACC z500 per lead {np.round(res['acc']['z500'], 4).tolist()}, "
                  f"RMSE z500 {np.round(res['rmse']['z500'], 2).tolist()}; every ACC finite; "
                  f"forecast, rmses.nc and accs.nc files written")
            weights = torch.load(checkpoint_path(run_dir, cfg.model.name, "best"),
                                 map_location="cpu", weights_only=True)["model"]
            check_rollout_vs_cpu(cfg, weights=weights, test_ds=test_ds)
            print(f"zarr path: {time.perf_counter() - t_phase:.1f} s to here [{card}]")
            serving = run_serve_paths(run_dir, cfg, res, card)
        finally:
            os.chdir(cwd)
    print(f"zarr path: {time.perf_counter() - t_phase:.1f} s for the phase, serving "
          f"included [{card}]")
    return dict(data=data, train=train, eval_launches=launches, eval_fused=fused,
                gridpoints_per_s=res["gridpoints_per_s"], serving=serving)


def check_plot_skips(stdout: str):
    """The evaluate CLI's `-c ... --video` on the card's machine, which has
    no matplotlib: the comparison plot is skipped with a message naming
    why, and so is the video (for want of ffmpeg, or of matplotlib where
    ffmpeg exists), after the files and metrics are written."""
    import importlib.util
    import shutil

    lines = stdout.splitlines()
    plot = [ln for ln in lines if ln.startswith("Comparison plot")]
    video = [ln for ln in lines if ln.startswith("video:")]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    want_video = ("written" if has_mpl and shutil.which("ffmpeg") else
                  "ffmpeg unavailable, skipped" if not shutil.which("ffmpeg") else
                  "matplotlib unavailable")
    ok = (len(plot) == 1 and ("->" in plot[0] if has_mpl else "skipped" in plot[0])
          and len(video) == 1 and want_video in video[0])
    print(f"evaluate -c --video on this machine (matplotlib "
          f"{'installed' if has_mpl else 'not installed'}, ffmpeg "
          f"{'installed' if shutil.which('ffmpeg') else 'not installed'}): {plot} {video} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"evaluate -c --video: plot lines {plot}, video lines {video}, "
                         f"want the video line to say {want_video!r}")


# The served forecast against `evaluate -c`'s of the same checkpoint:
# max|diff| over max|forecast| per variable, de-normalised, fp32.  Both
# run the same kernels in the same order, from the artifact's graph and
# from the eager model.
SERVE_TOL = 1e-5


def serve_and_compare(label: str, art: str, run_dir: str, cfg, eval_data: dict,
                      eval_rate: float, card: str):
    """`python -m dlwpbench_tpu_torch.serve -a ART -c RUN_DIR` on the card:
    every launch counter set to 0 just before and read just after, the
    launches the routing rule wants over the served batches (flash
    launches > 0), the served forecast within SERVE_TOL of `eval_data`'s
    (evaluate -c's outputs.nc) on the samples and leads both hold, and the
    serving rate beside evaluate's."""
    import numpy as np

    from dlwpbench_tpu_torch import serve
    from dlwpbench_tpu_torch.utils import netcdf3

    out_dir = os.path.join(run_dir, f"serving_{label.replace(' ', '_')}")
    counters = counters_of()
    reset_counters(counters)
    t0 = time.perf_counter()
    res = serve.main(["-a", art, "-c", run_dir, "--out-dir", out_dir, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    data, _ = netcdf3.read_dataset(os.path.join(out_dir, "outputs.nc"))
    names = res["variables"]
    n, T = data[names[0]].shape[:2]
    errs = {v: float(np.abs(data[v] - eval_data[v][:n, :T]).max()
                     / np.abs(eval_data[v][:n, :T]).max()) for v in names}
    B = 32
    want = expected_launches(build_for(cfg), counters, [(B, T, 1)] * (n // B))
    print(f"{label}: serve {n // B} batches of {B} x {T} steps, {wall:.1f} s wall (artifact "
          f"load, data, serving, files); steady {1e3 * res['steady_s_per_batch']:.1f} ms a batch, "
          f"{res['gridpoints_per_s']:.1f} grid-points/s (median batch) against evaluate -c's "
          f"{eval_rate:.1f} (mean over its batches after the first) [{card}]")
    print(f"{label}: served forecast against evaluate -c's, max|diff| / max|forecast| per "
          f"variable over {n} samples x {T} leads: "
          + ", ".join(f"{v} {e:.3e}" for v, e in errs.items()) + f" (tol {SERVE_TOL:.0e})")
    print(f"{label} launches {launches} (the routing rule wants {want})")
    if launches != want or not launches["flash_window_attention"]:
        raise SystemExit(f"{label}: launches {launches}, want {want}")
    fused = check_fused(label, counters, launches)
    if not max(errs.values()) <= SERVE_TOL:
        raise SystemExit(f"{label}: the served forecast leaves evaluate -c's by {errs}")
    return dict(launches=launches, fused=fused, gridpoints_per_s=res["gridpoints_per_s"],
                steady_s=res["steady_s_per_batch"], max_rel_err=max(errs.values()))


def run_serve_paths(run_dir: str, cfg, eval_res: dict, card: str):
    """The serving paths of the zarr run (after its `evaluate -c`): export
    the run with `python -m dlwpbench_tpu_torch.export_model` traced on the
    card (4 steps) and, a second artifact, traced on the CPU (2 steps): the
    autoregressive leads are those of evaluate's 16-step rollout, and the
    export's seconds (trace, save, load) grow with the steps; serve each on
    the card (`serve_and_compare`: the flash kernel launches for both, so
    the CPU trace baked no plain version in); round-trip the checkpoint
    through a module archive on the card."""
    import numpy as np
    import torch

    from dlwpbench_tpu_torch import export_model
    from dlwpbench_tpu_torch.evaluate import restore_run
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.training.module_checkpoint import (
        load_module_checkpoint,
        save_module_checkpoint,
    )
    from dlwpbench_tpu_torch.utils import netcdf3
    from dlwpbench_tpu_torch.utils.export import read_artifact

    clock = Clock("serving", card)
    eval_data, _ = netcdf3.read_dataset(os.path.join(run_dir, "evaluation", "outputs.nc"))
    out = {}
    for label, device, seq in (("swin serve", "cuda", 5), ("swin serve cpu export", "cpu", 3)):
        art = os.path.join(run_dir, f"swin_{device}.pt2")
        t0 = time.perf_counter()
        export_model.main(["-c", run_dir, "-o", art, "--batch-size", "32", "--sequence-length",
                           str(seq), "--device", device])
        export_s = time.perf_counter() - t0
        trace_s = read_artifact(art)[0]["trace_seconds"]
        print(f"{label}: torch.export traced the {seq - 1}-step rollout at batch 32 on {device} "
              f"in {trace_s:.2f} s, the CLI took {export_s:.2f} s (restore and save "
              f"included), {os.path.getsize(art) / 2**20:.1f} MiB [{card}]")
        out[label] = serve_and_compare(label, art, run_dir, cfg, eval_data,
                                       eval_res["gridpoints_per_s"], card)
        out[label].update(export_s=export_s, trace_s=trace_s)
        clock(f"{label}: export on {device}, serve on the card")

    _, model, _ = restore_run(run_dir, "cuda", ema=False)
    path = os.path.join(run_dir, "swin.mdlus.zip")
    save_module_checkpoint(path, model, cfg.model)
    loaded, _ = load_module_checkpoint(path, device="cuda",
                                       grid_shape=registry.data_grid_shape(cfg.data))
    a, b = model.state_dict(), loaded.state_dict()
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(f"module archive: {os.path.getsize(path) / 2**20:.2f} MiB, {len(a)} tensors, the "
          f"port's msgpack codec, saved and loaded on the card: every parameter equal bit "
          f"for bit {same} [{card}]")
    if not same or next(loaded.parameters()).device.type != "cuda":
        raise SystemExit("the module archive did not round-trip on the card")
    del model, loaded
    torch.cuda.empty_cache()
    clock("module archive")
    return out


def serve_pangu(run_dir: str, cfg, train_ds, card: str):
    """The Pangu training run's best checkpoint exported on the card and
    served one batch: the 5D window kernel launches (as the routing rule
    wants, counted), and the output matches the eager rollout of the same
    weights on the same batch."""
    import torch

    from dlwpbench_tpu_torch import export_model
    from dlwpbench_tpu_torch.evaluate import restore_run
    from dlwpbench_tpu_torch.utils.export import load_exported

    bs = int(cfg.training.batch_size)
    ctx = int(cfg.model.context_size)
    T = ctx + 1  # one step of the 16 blocks: the trace's seconds grow with its steps
    const, pres, prog, _ = next(train_ds.batches(bs))
    pres, prog = pres[:, :T], prog[:, :T]
    art = os.path.join(run_dir, "pangu.pt2")
    t0 = time.perf_counter()
    export_model.main(["-c", run_dir, "-o", art, "--batch-size", str(bs), "--sequence-length",
                       str(T), "--device", "cuda"])
    export_s = time.perf_counter() - t0
    run, meta = load_exported(art, device="cuda")
    counters = counters_of()
    reset_counters(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(const, pres, prog)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    fused = check_fused("pangu serve", counters, launches)  # before the eager reference's
    _, model, _ = restore_run(run_dir, "cuda", ema=False)
    with torch.no_grad():
        ref = model.eval()(*tensors_of(const, pres, prog, device="cuda"))
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    want = expected_launches(model, counters, [(bs, T - ctx, 1)])
    print(f"pangu serve: export on the card {export_s:.2f} s ({T - ctx}-step rollout at batch "
          f"{bs}; torch.export {meta['trace_seconds']:.2f} s, restore and save the rest); one "
          f"served batch {1e3 * serve_s:.1f} ms (its first call); "
          f"max|diff| / max|out| against the eager rollout {err:.3e} (tol {SERVE_TOL:.0e}); "
          f"launches {launches} (the routing rule wants {want}) [{card}]")
    if launches != want or not launches["window_attention_qkv5d"] or not err <= SERVE_TOL:
        raise SystemExit(f"pangu serve: launches {launches} (want {want}), error {err:.3e}")
    del model, got, ref
    torch.cuda.empty_cache()
    return dict(launches=launches, fused=fused, export_s=export_s,
                trace_s=meta["trace_seconds"], max_rel_err=err)


# ---------------------------------------------------------------- the HEALPix paths
# `configs/data/synthetic_hpx8.yaml` (the nside-8 faces of
# `configs/data/full_hpx8.yaml`, 4 + 1 + 3 channels); data.n_time is raised
# from 128 as on the lat-lon paths: 11 full training batches of 32 and 14
# validation windows at 1536 (the shipped 128 frames hold no 15-frame
# validation window), 96 biweekly test inits at 9060.  nside 32 is the
# ladder's rung (`scripts/benchmark_ladder.py:18-24`) on the same synthetic
# generator: 12,288 pixels a sample, the Swin's 96 x 128 rectangle.
HPX_SWIN = ["model=swintransformer", "model.type=SwinTransformerHPX", "model.mesh=healpix"]
HPX8_TRAIN_TAIL = ["data=synthetic_hpx8", "data.n_time=1536", "training.epochs=1"]
NSIDE32 = ["data.healpix_nside=32", "data.height=32", "data.width=32"]
# the U-Net's user path: 44 training batches of 32 (a small model: more
# steps for its s per step) and 64 test inits, two evaluate batches of 32
# (66 and three until the ModernUNet phases needed the time)
HPX_UNET_TRAIN_ARGV = ["model=unet_hpx", "data=synthetic_hpx8", "data.n_time=6000",
                       "training.epochs=1"]
HPX_SWIN_EVAL_ARGV = [*HPX_SWIN, "data=synthetic_hpx8", "data.n_time=9060", "--batch-size", "32",
                      "--sequence-length", "17", "--device", "cuda"]
HPX_SWIN_TRAIN_ARGV = [*HPX_SWIN, *HPX8_TRAIN_TAIL]
HPX_SWIN8_TRAIN_ARGV = [*HPX_SWIN, "model.window_size=[8,8]", "model.use_flash_attention=null",
                        *HPX8_TRAIN_TAIL, *NSIDE32]
# the ladder's unet_hpx family (`benchmark_ladder.py:24,108-110`) at nside 32;
# 900 frames give the training split 36 windows of 17 frames
HPX_UNET32 = ["model=unet_hpx", "model.hidden_channels=[64,128,256]", "data=synthetic_hpx8",
              "data.n_time=900", *NSIDE32]


def report_epoch(label: str, run: dict, cfg, train_ds, card: str):
    """A training path's busy share: one more epoch under the profiler,
    after an epoch whose steps run under set_sync_debug_mode("error")."""
    dev_ms, busy, ops = epoch_busy(cfg, train_ds, check_sync=True)
    run["device_ms"], run["busy"], run["device_ops_per_step"] = dev_ms, busy, ops
    print(f"{label}: an epoch's steps ran under set_sync_debug_mode('error') and raised "
          f"nothing; {run['seconds_per_step']:.4f} s per step, {run['gridpoints_per_s']:.1f} "
          f"grid-points/s; device " + ("not measured" if dev_ms is None else
                                       f"{dev_ms:.2f} ms a step, busy {100 * busy:.1f}% of the "
                                       f"steps' seconds, {ops:.1f} device ops (kernels, "
                                       f"copies, memsets) a step (one more epoch under the "
                                       f"profiler)")
          + f" [{card}]")


class _Tee(io.StringIO):
    """Standard output kept as well as printed."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def run_user_path(label: str, argv: list, card: str, batch: int = 32, remap: bool = False,
                  datasets=None):
    """A user's path, in a temporary working directory (the baselines and
    the evaluator's climatology live under `./outputs/`): `python -m
    dlwpbench_tpu_torch.train ARGV` (1 epoch) with its s per step,
    grid-points/s and busy share (`report_epoch`: an epoch's steps under
    set_sync_debug_mode("error")); `build_baselines -c RUN_DIR`; `evaluate
    -c RUN_DIR`: no attention launch, the forecast files on the data's
    lat-lon grid (a HEALPix run's remapped), every RMSE and ACC finite;
    with `remap`, then `python -m dlwpbench_tpu_torch.remap_healpix` both
    ways on the forecast file's first field, on the card by default,
    against `--device cpu`.  `datasets` as `run_train_path` takes them.
    Returns the train run, the evaluate launches, results and "Restored
    ..." line, the config and the training split."""
    from dlwpbench_tpu_torch import build_baselines, remap_healpix

    name = label.replace(" ", "_")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as work:
        os.chdir(work)
        try:
            run_dir = os.path.join(work, "runs", name)
            train, cfg, train_ds = run_train_path(f"{label} train", argv, run_dir, card,
                                                  datasets=datasets)
            report_epoch(f"{label} train", train, cfg, train_ds, card)
            base = build_baselines.main(["-c", run_dir])
            ev = evaluate_run_dir(label, run_dir, cfg, card, batch, base)
            if remap:
                check_remap_cli(remap_healpix.main, ev["data"][ev["res"]["variables"][0]],
                                work, card)
        finally:
            os.chdir(cwd)
    return dict(train=train, launches=ev["launches"], res=ev["res"], restored=ev["restored"],
                cfg=cfg, train_ds=train_ds)


def evaluate_run_dir(label: str, run_dir: str, cfg, card: str, batch: int, base: dict):
    """`python -m dlwpbench_tpu_torch.evaluate -c RUN_DIR` on the card in
    the working directory (ACC against its baselines' climatology, `base`
    the baselines' results): every launch counter set to 0 just before and
    read just after, none wanted; the forecast files on the data's lat-lon
    grid (a HEALPix run's remapped), every RMSE and ACC finite.  Returns
    the results, the launches, the "Restored ..." line and the forecast
    file's fields."""
    import contextlib

    import numpy as np

    from dlwpbench_tpu_torch import evaluate as eval_cli
    from dlwpbench_tpu_torch.utils import netcdf3

    name = os.path.basename(os.path.normpath(run_dir))
    counters = counters_of()
    reset_counters(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as out:
        res = eval_cli.main(["-c", run_dir, "--batch-size", str(batch), "--device", "cuda"])[name]
    wall = time.perf_counter() - t0
    restored = next(ln for ln in out.getvalue().splitlines() if ln.startswith("Restored"))
    launches = {n: fn.launches for n, fn in counters.items()}
    data, _ = netcdf3.read_dataset(os.path.join(run_dir, "evaluation", "outputs.nc"))
    names = res["variables"]
    n = sum(k for k, _ in res["batch_seconds"])
    steps = 17 - int(cfg.model.context_size)  # evaluate's --sequence-length 17
    want = (n, steps, int(cfg.data.height), int(cfg.data.width))
    shapes = {v: data[v].shape for v in names}
    rmse = np.array([res["rmse"][v] for v in names])
    acc = np.array([res["acc"][v] for v in names])
    print(f"{label} evaluate -c: {len(res['batch_seconds'])} batches of "
          f"{[k for k, _ in res['batch_seconds']]} x {steps} steps, {wall:.1f} s wall, "
          f"steady-state {res['gridpoints_per_s']} grid-points/s "
          f"({'HEALPix pixels' if cfg.data.get('healpix_nside') else 'the lat-lon grid'}); "
          f"outputs.nc {shapes}; RMSE var0 {np.round(res['rmse']['var0'], 4).tolist()}, "
          f"ACC var0 {np.round(res['acc']['var0'], 4).tolist()}; persistence RMSE var0 "
          f"at the last lead {base['persistence']['rmse']['var0'][-1]:.4f}; attention "
          f"launches {launches} (none wanted) [{card}]")
    if (any(launches.values()) or any(sh != want for sh in shapes.values())
            or not (np.isfinite(rmse).all() and np.isfinite(acc).all())):
        raise SystemExit(f"{label} evaluate -c: launches {launches}, outputs {shapes} "
                         f"(want {want}), RMSE finite {np.isfinite(rmse).all()}, "
                         f"ACC finite {np.isfinite(acc).all()}")
    return dict(res=res, launches=launches, restored=restored, data=data)


def run_hpx_unet_path(card: str):
    """The phase "HEALPix U-Net": `run_user_path` on `model=unet_hpx
    data=synthetic_hpx8`, with the remap CLI's check."""
    r = run_user_path("hpx unet", HPX_UNET_TRAIN_ARGV, card, remap=True)
    return r["train"], r["launches"]


def check_remap_cli(main, field, work: str, card: str):
    """The remap CLI's ll2hpx (nside 8) and hpx2ll (back to the field's
    grid) with no `--device`, which is the card, against `--device cpu` on
    the same file: relative max error at most 1e-6 (fp32, 4 taps)."""
    import numpy as np

    src = os.path.join(work, "remap_ll.npy")
    np.save(src, np.ascontiguousarray(field, dtype=np.float32))
    nlat, nlon = field.shape[-2:]
    t0 = time.perf_counter()
    got = {}
    for dev in ([], ["--device", "cpu"]):
        tag = dev[-1] if dev else "cuda"
        hpx = os.path.join(work, f"remap_hpx_{tag}.npy")
        got[tag] = (main(["ll2hpx", src, hpx, "--nside", "8", *dev]),
                    main(["hpx2ll", hpx, os.path.join(work, f"remap_ll_{tag}.npy"),
                          "--nlat", str(nlat), "--nlon", str(nlon), *dev]))
    errs = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
            for a, b in zip(got["cuda"], got["cpu"])]
    print(f"remap_healpix CLI on the card: {field.shape} -> {got['cuda'][0].shape} -> "
          f"{got['cuda'][1].shape}, relative max error vs --device cpu {errs} (tol 1e-6), "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    if not all(e <= 1e-6 for e in errs) or got["cuda"][1].shape != field.shape:
        raise SystemExit(f"remap_healpix CLI: card vs CPU relative error {errs} (tol 1e-6)")


def kernel_us_by_range(prof, names):
    """({name: us of the kernels launched inside a span of that name}, us
    of all kernels).  Each kernel is charged to the innermost such span
    around the host operator that launched it (the profiler ties each
    kernel to its operator by correlation id); names with no span in the
    trace are left out.  The spans (`profiling.span`) leave nothing on the
    card's timeline.  (The profiler's per-op `device_time_total` counted
    some kernels twice here: the ranges' shares summed past 100%.)"""
    events = prof.events()
    total = sum(e.time_range.end - e.time_range.start for e in events
                if str(e.device_type).endswith("CUDA"))
    out = {e.name: 0.0 for e in events if e.name in names and str(e.device_type).endswith("CPU")}
    for e in events:
        if not e.kernels or not str(e.device_type).endswith("CPU"):
            continue
        span = e.cpu_parent
        while span is not None and span.name not in names:
            span = span.cpu_parent
        if span is not None:
            out[span.name] += sum(k.duration for k in e.kernels)
    return out, total


def drive_hpx_unet_rollout(card: str):
    """The ladder's unet_hpx family at nside 32 (hidden 64, 128, 256), one
    batch of 32 x 16-step rollouts with the inputs on the card: ms a
    rollout (CUDA events over 3), grid-points/s, a profile with the
    HEALPix pad's share of device time (its gather, products and tap sum)
    beside the conv modules' and the concatenations', from a second
    profile with each of them in a span; no
    attention launch; card against CPU on 2 samples x 2 steps."""
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.ops import conv as conv_mod
    from dlwpbench_tpu_torch.training.config import load_config
    from dlwpbench_tpu_torch.utils import profiling

    cfg = load_config(cli.CONFIG_DIR, overrides=HPX_UNET32)
    cfg.training["sequence_length"] = 17
    train_ds = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing, 1)[0]
    batch = next(train_ds.batches(EVAL_BATCH))
    if batch[2].shape[0] != EVAL_BATCH:
        raise SystemExit(f"hpx unet rollout: a batch of {batch[2].shape[0]}, want {EVAL_BATCH}")
    model = build_for(cfg, seed=int(cfg.seed)).cuda().eval()
    args = [torch.from_numpy(a).cuda() for a in batch[:3]]
    counters = counters_of()
    reset_counters(counters)
    points = 16 * grid_points(cfg.data)
    pad = conv_mod.healpix_pad_channels_last
    conv_forwards = {cls: cls.forward for cls in (torch.nn.Conv2d, torch.nn.ConvTranspose2d)}
    cat = torch.cat

    def in_range(name, fn):
        def ranged(*a, **k):
            with profiling.span(name):
                return fn(*a, **k)
        return ranged

    def profiled():
        torch.cuda.synchronize()
        with profiling.trace() as prof:
            t0 = time.perf_counter()
            model(*args)
            torch.cuda.synchronize()
        return prof, (time.perf_counter() - t0) * 1e6

    with torch.no_grad():
        ms = cuda_ms(lambda: model(*args), 3)
        prof, wall_us = profiled()
        # the same rollout with the pad, every conv module and every
        # concatenation in a range
        conv_mod.healpix_pad_channels_last = in_range("healpix_pad", pad)
        torch.cat = in_range("concatenation", cat)
        for cls, fwd in conv_forwards.items():
            cls.forward = in_range("convolution", fwd)
        try:
            ranged, _ = profiled()
        finally:
            conv_mod.healpix_pad_channels_last = pad
            torch.cat = cat
            for cls, fwd in conv_forwards.items():
                cls.forward = fwd
    launches = {n: fn.launches for n, fn in counters.items()}
    rate = EVAL_BATCH * points / (ms / 1e3)
    print(f"hpx unet rollout nside 32: hidden {list(model.hidden_channels)}, batch {EVAL_BATCH} "
          f"x 16 steps, inputs on the card: {ms:.3f} ms a rollout, {rate:.1f} grid-points/s "
          f"(HEALPix pixels) [{card}]")
    _print_profile(prof, f"unet_hpx nside 32, one rollout of batch {EVAL_BATCH} x 16 steps",
                   wall_us, card, 10)
    by_op, total = kernel_us_by_range(ranged, ("healpix_pad", "convolution", "concatenation"))
    shares = {k: (v / 1e3, 100 * v / total) for k, v in by_op.items()} if total else {}
    print("hpx unet rollout nside 32: device time by range (its kernels; healpix_pad is the "
          "neighbour pad's gather, products and tap sum, convolution the Conv2d and "
          "ConvTranspose2d modules, layout conversions included, concatenation every "
          "torch.cat): " + ("; ".join(
              f"{name} {ms_:.2f} ms = {share:.1f}%" for name, (ms_, share) in shares.items())
              + f" of {total / 1e3:.2f} ms" if total else "not measured (no device time)")
          + f"; attention launches {launches} (none wanted) [{card}]")
    if any(launches.values()):
        raise SystemExit(f"hpx unet rollout: attention launches {launches}")
    check_rollout_vs_cpu(cfg)
    return dict(rollout_ms=ms, gridpoints_per_s=rate, shares=shares)


def run_hpx_swin_paths(card: str):
    """The phases "HEALPix Swin" at the shipped width (flash route: global
    windows over the 24 x 32 rectangle of nside-8 faces) and "HEALPix Swin,
    8x8 windows at nside 32" (the token-major route over the 96 x 128
    rectangle): the evaluate CLI (3 batches of 32, 16 steps) with the card
    against the CPU; 1 training epoch each through the train CLI, every
    launch on the new designs, their busy shares; card-vs-CPU gradients on
    the flash and on the token-major route; a profile of one flash-route
    training step."""
    paths, fused = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hpx_swin_eval_") as out_dir:
        _, paths["hpx_swin_evaluate"], cfg, fused["hpx_swin_evaluate"] = run_eval_path(
            "hpx swin evaluate", HPX_SWIN_EVAL_ARGV, out_dir, card)
    check_rollout_vs_cpu(cfg)

    runs = {}
    for key, argv, route in (("hpx_swin_train", HPX_SWIN_TRAIN_ARGV, True),
                             ("hpx_swin_win8_train", HPX_SWIN8_TRAIN_ARGV, "packed")):
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
            run, rcfg, rds = run_train_path(key.replace("_", " "), argv, run_dir, card)
        runs[key] = run
        paths[key], fused[key] = run["launches"], run["fused"]
        report_epoch(key.replace("_", " "), run, rcfg, rds, card)
        check_train_grads(rcfg, rds, card, card_route=route)
        if route is True:
            profile_train_step(rcfg, rds, card)
    return paths, fused, runs


# ---------------------------------------------------------------- the ModernUNet family
# `configs/model/modernunet.yaml` at its shipped width (hidden 64, 128, 256,
# 1024; 89,568,046 parameters on the 4 + 1 + 8 synthetic channels): the
# evaluate paths' 96 test inits and the training paths' 11 batches.  The
# reference's HEALPix ModernUNet (`modernunet_inverted_hpx.yaml`, hidden
# 136, 68, 34) and the HEALPix diffusion model on the training paths' 1,536
# frames (11 training batches, 16 test inits: one evaluate batch of 16, 75
# denoiser calls: 15 leads x 5 refinements), and so the lat-lon diffusion
# model (`diffusion_modernunet.yaml`, 80,678,024 parameters,
# `training=diffusion`; on 3,000 frames, 22 training batches and two
# evaluate batches, until the distributed phase needed the time).
MUNET_EVAL_ARGV = ["model=modernunet", *EVAL_TAIL]
MUNET_TRAIN_ARGV = ["model=modernunet", *TRAIN_TAIL, "training.epochs=1"]
MUNET_HPX_ARGV = ["model=modernunet_inverted_hpx", "data=synthetic_hpx8", "data.n_time=1536",
                  "training.epochs=1"]
DIFF_ARGV = ["model=diffusion_modernunet", "training=diffusion", "data=synthetic",
             "data.n_time=1536", "training.epochs=1"]
DIFF_HPX_ARGV = ["model=diffusion_modernunet", "model.type=DiffMUNetHPX", "model.mesh=healpix",
                 "training=diffusion", "data=synthetic_hpx8", "data.n_time=1536",
                 "training.epochs=1"]
# the op groups of a ModernUNet step's device time (CPU op names, forward
# and backward: cuDNN's forward, dgrad and wgrad convolutions and the
# transposes; GroupNorm and its backward; the skip concatenations)
STEP_GROUPS = {"convolution": ("conv",), "group_norm": ("group_norm",),
               "concatenation": ("aten::cat",)}


class Clock:
    """Prints the seconds since its last call beside a step's name."""

    def __init__(self, phase: str, card: str):
        self.phase, self.card, self.t = phase, card, time.perf_counter()

    def __call__(self, step: str):
        now = time.perf_counter()
        print(f"{self.phase} phase: {step} {now - self.t:.1f} s [{self.card}]")
        self.t = now


def profile_step_split(cfg, train_ds, card: str, groups=STEP_GROUPS):
    """One training step at batch 32 under the profiler (in the config's
    compute dtype), its device time by the op that launched each kernel:
    `groups` (by default the convolutions, GroupNorm and the
    concatenations) and the rest (the layout copies around GroupNorm, GELU,
    AdamW, ... by name)."""
    import torch

    from dlwpbench_tpu_torch.utils import profiling

    batch = next(train_ds.batches(int(cfg.training.batch_size)))
    model = build_for(cfg, {**cfg.model, "remat": True}, seed=int(cfg.seed)).cuda()
    trainer = run_trainer(cfg, model)
    state = trainer.init()
    tensors = trainer._to_device(batch)
    trainer.train_step(state, tensors, 1e-3)
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, tensors, 1e-3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dtype = cfg.training.get("compute_dtype") or "float32"
    what = (f"{cfg.model.name}, one training step at batch {len(batch[2])} ({dtype} compute, "
            f"{cfg.training.get('type', 'regular')})")
    _print_profile(prof, what, wall_us, card, 8)
    events = prof.key_averages()
    kernels = sum(e.self_device_time_total for e in events if str(e.device_type).endswith("CUDA"))
    ops = [e for e in events if not str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    if not kernels:
        return None
    shares = {g: sum(e.self_device_time_total for e in ops if any(k in e.key for k in keys))
              for g, keys in groups.items()}
    shares["rest"] = kernels - sum(shares.values())
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    print(f"profile: {what}: device time by the op that launched it: " + "; ".join(
        f"{g} {us / 1e3:.2f} ms = {100 * us / kernels:.1f}%" for g, us in shares.items())
        + f" of {kernels / 1e3:.2f} ms; top ops " + ", ".join(
        f"{e.key} {e.self_device_time_total / 1e3:.2f} ms" for e in top) + f" [{card}]")
    return {g: us / kernels for g, us in shares.items()}


def run_modern_unet_paths(card: str):
    """The phases "ModernUNet" (lat-lon, shipped width) and "MUNetHPX":
    the evaluate CLI (3 batches of 32 x 15 steps, fp32) with a profiled
    rollout and card vs CPU; 1 training epoch in fp32 and in bf16 compute
    through the train CLI, each with its busy share after an epoch under
    set_sync_debug_mode("error"), a profiled step split into
    convolutions, GroupNorm and concatenations, and the card's gradients
    against the CPU's (the bf16 ones as the bf16 check does); the HEALPix
    model's user path (train, build_baselines -c, evaluate -c with ACC)
    and its rollout card vs CPU.  No attention kernel launches anywhere."""
    paths, runs, clock = {}, {}, Clock("ModernUNet", card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_munet_eval_") as out_dir:
        _, paths["munet_evaluate"], cfg, _ = run_eval_path("modernunet evaluate", MUNET_EVAL_ARGV,
                                                           out_dir, card)
    clock("evaluate CLI")
    helper = helper_test_split(cfg)
    profile_rollout(cfg, card, test_ds=helper)
    weights = perturbed_state(cfg)
    check_rollout_vs_cpu(cfg, weights, test_ds=helper,
                         weights_label="seeded, moved by 0.01 N(0, 1)")
    clock("profile, card vs CPU rollout")
    splits = train_splits(MUNET_TRAIN_ARGV)  # both dtypes train on one build
    munet_ref = {}  # the fp32 check's batch and CPU gradients, for the bf16 one
    for key, argv in (("munet_train", MUNET_TRAIN_ARGV),
                      ("munet_train_bf16", [*MUNET_TRAIN_ARGV, "training.compute_dtype=bfloat16"])):
        label = key.replace("_", " ")
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
            run, rcfg, rds = run_train_path(label, argv, run_dir, card, datasets=splits)
        clock(f"{label} CLI")
        report_epoch(label, run, rcfg, rds, card)
        run["step_split"] = profile_step_split(rcfg, rds, card)
        clock(f"{label} busy share, step split")
        if rcfg.training.get("compute_dtype") == "bfloat16":
            check_train_grads_bf16(rcfg, rds, card, kernels=False, weights=weights,
                                   reference=munet_ref)
        else:
            check_train_grads(rcfg, rds, card, kernels=False, weights=weights,
                              reference=munet_ref)
        clock(f"{label} card vs CPU gradients")
        runs[key], paths[key] = run, run["launches"]
    a, b = runs["munet_train"], runs["munet_train_bf16"]
    print(f"training, fp32 against bf16 compute: modernunet {a['seconds_per_step']:.4f} against "
          f"{b['seconds_per_step']:.4f} s per step "
          f"({a['seconds_per_step'] / b['seconds_per_step']:.2f}x), peak {a['peak_gib']:.2f} "
          f"against {b['peak_gib']:.2f} GiB [{card}]")
    hpx = run_user_path("munet hpx", MUNET_HPX_ARGV, card)
    check_rollout_vs_cpu(hpx["cfg"], perturbed_state(hpx["cfg"]),
                         weights_label="seeded, moved by 0.01 N(0, 1)")
    clock("MUNetHPX user path, card vs CPU")
    runs["munet_hpx_train"] = hpx["train"]
    paths["munet_hpx_train"], paths["munet_hpx_evaluate"] = hpx["train"]["launches"], hpx["launches"]
    return paths, runs


def check_ema_replay(cfg, train_ds, card: str):
    """A diffusion training epoch through `Trainer.train_epoch`, its steps
    under set_sync_debug_mode("error"), the parameters copied on the card
    after each step: the EMA at the end equals e <- e * d + p * (1 - d)
    replayed in fp64 from the initial parameters over those copies (the
    trainer's fp32 lerp rounds each step: tol 1e-5 of each tensor's max)."""
    import torch


    model = build_for(cfg, seed=int(cfg.seed)).cuda()
    trainer = run_trainer(cfg, model, epochs=100)
    state = trainer.init()
    replay = {n: t.double() for n, t in state.ema.items()}
    snaps, step = [], trainer.train_step

    def step_and_keep(*a, **k):
        loss = step(*a, **k)
        snaps.append({n: p.detach().clone() for n, p in model.named_parameters()})
        return loss

    trainer.train_step = step_and_keep
    sync_free_epoch(trainer, state, train_ds, int(cfg.training.batch_size))
    d = trainer.ema_decay
    for snap in snaps:
        for n, e in replay.items():
            e.mul_(d).add_(snap[n].double(), alpha=1.0 - d)
    worst = max(((state.ema[n].double() - e).abs().max() / e.abs().max().clamp_min(1e-30)).item()
                for n, e in replay.items())
    moved = max((state.ema[n] - p).abs().max().item() for n, p in model.named_parameters())
    n_steps = len(snaps)
    snaps.clear()  # the closure on the trainer is a reference cycle: free the copies now
    del trainer.train_step
    print(f"{cfg.model.name} EMA: {n_steps} steps under set_sync_debug_mode('error'), decay "
          f"{d}; the EMA against the fp64 replay from the step parameters: worst max|diff| / "
          f"max|ema| over {len(replay)} tensors {worst:.3e} (tol 1e-5); max|ema - params| "
          f"{moved:.3e} [{card}]")
    if not (worst <= 1e-5 and n_steps == len(list(train_ds.batches(int(cfg.training.batch_size))))
            and moved > 0):
        raise SystemExit(f"{cfg.model.name} EMA: replay error {worst}, {n_steps} steps")
    return worst


def check_diffusion_vs_cpu(cfg, card: str):
    """The full-width diffusion model (seeded, every parameter moved by
    0.01 x N(0, 1) so that the zero-initialised convs carry signal) on the
    card against the CPU: `single_forward` at timesteps 800 and 999 on 2
    training samples, its loss and every parameter gradient; the 3-step
    rollout of 2 test samples for both samplers, fed the same noise.  No
    attention kernel launches."""
    import torch

    from dlwpbench_tpu_torch.data.sources import build_datasets

    cfg.testing["sequence_length"] = int(cfg.model.context_size) + 3
    train_ds, _, test_ds, _ = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                             int(cfg.model.context_size))
    g = torch.Generator().manual_seed(0)
    cpu = build_for(cfg, seed=int(cfg.seed))
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    card_model = build_for(cfg, seed=int(cfg.seed)).cuda()
    card_model.load_state_dict(cpu.state_dict())
    counters = counters_of()
    before = {n: fn.launches for n, fn in counters.items()}
    ctx = int(cfg.model.context_size)
    const, pres, prog, target = (torch.from_numpy(a) for a in next(train_ds.batches(2)))
    y, w = torch.randn(target.shape, generator=g), torch.randn(target[:, 0].shape, generator=g)
    k = torch.tensor([800, 999])
    grads = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card_model, "cuda")):
        args = [a.to(dev) for a in (const, pres[:, :ctx], prog[:, :ctx], y, k)]
        loss = (model.single_forward(*args) * w.to(dev)).mean()
        loss.backward()
        grads[name] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = grads["cpu"], grads["cuda"]
    worst = max(((g_card[n] - t).abs().max() / t.abs().max().clamp_min(1e-30)).item()
                for n, t in g_cpu.items())
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    tc, tp, tg, _ = (torch.from_numpy(a) for a in next(test_ds.batches(2)))
    shape = (2, 1, *tg.shape[2:])
    noise = [[torch.randn(shape, generator=g) for _ in range(6)] for _ in range(3)]
    errs = {}
    with torch.no_grad():
        for sampler in ("mean", "reference"):
            cpu.sampler = card_model.sampler = sampler
            ref = cpu(tc, tp, tg, noise=noise)
            got = card_model(tc.cuda(), tp.cuda(), tg.cuda(),
                             noise=[[z.cuda() for z in step] for step in noise]).cpu()
            errs[sampler] = ((got - ref).abs().max() / ref.abs().max()).item()
    used = {n: fn.launches - before[n] for n, fn in counters.items() if fn.launches != before[n]}
    tol = 1e-3  # fp32 both sides; cuDNN against ATen's CPU convolutions, other orders
    print(f"{cfg.model.name} card vs CPU (full width, {cfg.model.type}): single_forward at k "
          f"{k.tolist()} on 2 samples, loss rel {loss_rel:.2e}, worst max|diff|/max|grad| over "
          f"{len(g_cpu)} tensors {worst:.3e}; 3-step rollout with the same noise, max|diff| / "
          f"max|ref| {', '.join(f'{s} {e:.3e}' for s, e in errs.items())} (tol {tol:.0e}); "
          f"attention launches {used} (none wanted) [{card}]")
    if used or not (worst <= tol and loss_rel <= 1e-5 and max(errs.values()) <= tol):
        raise SystemExit(f"{cfg.model.name}: the card disagrees with the CPU")
    return worst, errs


def run_diffusion_paths(card: str):
    """The phases "DiffModernUNet" and "DiffMUNetHPX" (the author's
    HEALPix + diffusion path): each user path (`run_user_path`: train 1
    epoch with the v-prediction objective and the EMA, an epoch's steps
    under set_sync_debug_mode("error"), build_baselines -c, evaluate -c on
    the EMA weights with ACC), the card against the CPU
    (`check_diffusion_vs_cpu`); on the lat-lon model also the EMA against
    its replay (`check_ema_replay`)."""
    paths, runs, clock = {}, {}, Clock("diffusion", card)
    for key, argv in (("diffusion", DIFF_ARGV), ("diffusion_hpx", DIFF_HPX_ARGV)):
        r = run_user_path(key.replace("_", " "), argv, card, batch=16)
        if "EMA weights" not in r["restored"]:
            raise SystemExit(f"{key} evaluate -c: {r['restored']!r}, want the EMA weights")
        clock(f"{key} user path")
        if key == "diffusion":
            check_ema_replay(r["cfg"], r["train_ds"], card)
            clock("EMA replay")
        check_diffusion_vs_cpu(r["cfg"], card)
        profile_step_split(r["cfg"], r["train_ds"], card)
        clock(f"{key} card vs CPU, step split")
        runs[f"{key}_train"] = r["train"]
        paths[f"{key}_train"], paths[f"{key}_evaluate"] = r["train"]["launches"], r["launches"]
    return paths, runs


# ---------------------------------------------------------------- Navier-Stokes and the recurrent models
# `configs/data/navier_stokes.yaml` (n 64, 16 trajectories, 50 records)
# with 400 solver steps a record where it ships 1,000 (time only, as the
# wb_learnable generator's: every entry point regenerates the dataset, five
# generations of host-bound solver steps; the shapes and splits as
# shipped; the forced flow spins up, and the check's last-over-middle
# enstrophy ratio is 2.02 at 300 steps, 1.92 at 350 and 1.82 at 400 (the
# CPU solver from the same field), 1.59 at 500 on the card; 500 until the
# graph phase needed the time); ConvLSTM with the shipped training
# defaults but 10 epochs where they ship 30 (time only: a host-bound path,
# cut to make room for the graph phase), batch 32, DISTANA 1 epoch; both
# evaluated at batch 4 (the test split's 8 windows of 17 frames: two batches)
NS_CONVLSTM_ARGV = ["model=convlstm", "data=navier_stokes", "data.inner_steps=400",
                    "training.epochs=10"]
NS_DISTANA_ARGV = ["model=distana", "data=navier_stokes", "data.inner_steps=400",
                   "training.epochs=1"]
NS_EVAL_BATCH = 4
RECURRENT_HPX_ARGV = {
    "convlstm_hpx": ["model=convlstm", "model.type=ConvLSTMHPX", "model.mesh=healpix",
                     *HPX8_TRAIN_TAIL],
    "distana_hpx": ["model=distana", "model.type=DISTANAHPX", *HPX8_TRAIN_TAIL],
}
# the wb_learnable store at `configs/data/wb_learnable.yaml`'s years; 2
# solver steps a frame where the generator's default is 600 (time only:
# the solver's steps are host-bound, 11,680 of them here)
WB_ARGS = ["--years", "1979", "1982", "--inner-steps", "2"]
NS_TOL = 1e-4  # the solver, card vs CPU: max|diff| / max|w|, fp32, cuFFT vs pocketfft


def profile_solver(n: int, batch: int, card: str):
    """The solver's launches per step (the kernels of 20 profiled steps less
    those of 10, over 10: the tables and cuFFT's plans exist already) and
    its busy share over 200 steps (device time over the wall)."""
    import torch

    from dlwpbench_tpu_torch.data import ns2d
    from dlwpbench_tpu_torch.utils import profiling

    w0 = ns2d.initial_field(0, n, batch).cuda()
    ns2d.simulate(w0, n=n, record_steps=1, inner_steps=2)
    kernels, device_us, wall_us = [], 0.0, 0.0
    for steps in (10, 20, 200):
        torch.cuda.synchronize()
        with profiling.trace(host=False) as prof:
            t0 = time.perf_counter()
            ns2d.simulate(w0, n=n, record_steps=1, inner_steps=steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        kernels.append(sum(e.count for e in events))
        device_us = sum(e.self_device_time_total for e in events)
    per_step = (kernels[1] - kernels[0]) / 10 if kernels[0] else None
    busy = device_us / wall_us if device_us else None
    print(f"NS solver at n {n}, batch {batch}: "
          + ("launches not measured (no device events)" if per_step is None else
             f"{per_step:.1f} launches per solver step (kernels of 20 steps less 10, over 10)")
          + "; " + ("busy not measured" if busy is None else
                    f"busy {100 * busy:.1f}% over 200 steps ({wall_us / 200:.1f} us a step, "
                    f"device {device_us / 200:.1f} us)") + f" [{card}]")
    return per_step, busy


def check_solver(gen: dict, cfg, card: str):
    """The first generation of the dataset (`gen`: its raw trajectories,
    seconds and peak memory): finite, the mean vorticity below 1e-3, no
    growth over the forced run's second half (the enstrophy of the last
    record below twice the middle one's); the same initial field (n 64,
    batch 2) through 2 records of 50 steps on the card against the CPU,
    whose enstrophy at the end stays below twice the largest at the start
    (`tests/test_data.py:22-23`, at its horizon)."""
    import numpy as np

    from dlwpbench_tpu_torch.data import ns2d

    d = cfg.data
    raw, seconds = gen["traj"], gen["seconds"]
    n, T = raw.shape[-1], raw.shape[1]
    ens = (raw ** 2).mean(axis=(2, 3))
    finite = bool(np.isfinite(raw).all())
    mean = float(raw.mean(dtype=np.float64))
    steps = int(d.record_steps) * int(d.inner_steps)
    print(f"NS dataset: {raw.shape[0]} trajectories x {T} frames of {n} x {n} "
          f"(navier_stokes.yaml), {steps} solver steps in {seconds:.2f} s "
          f"({steps / seconds:.1f} steps/s, {raw.shape[0] * steps / seconds:.1f} "
          f"trajectory-steps/s; the train CLI's generation), peak device memory "
          f"{gen['peak'] / 2**20:.1f} MiB; finite {finite}, mean vorticity {mean:.3e}, std "
          f"{raw.std():.4f}, enstrophy (largest over the trajectories) first "
          f"{ens[:, 0].max():.4f}, middle {ens[:, T // 2].max():.4f}, last "
          f"{ens[:, -1].max():.4f} [{card}]")
    if not (finite and abs(mean) < 1e-3 and ens[:, -1].max() < 2.0 * ens[:, T // 2].max()):
        raise SystemExit("NS dataset: not finite, not mean-free or its enstrophy grew")
    w0 = ns2d.initial_field(int(d.seed), n, 2)
    kw = dict(n=n, nu=float(d.nu), dt=float(d.dt), record_steps=2, inner_steps=50)
    ref = ns2d.simulate(w0, **kw)
    got = ns2d.simulate(w0.cuda(), **kw).cpu()
    errs = [((got[:, r] - ref[:, r]).abs().max() / ref[:, r].abs().max()).item() for r in (1, 2)]
    ens = (got ** 2).mean(dim=(2, 3))
    print(f"NS solver card vs CPU: the same initial field, n {n}, batch 2, 2 records x 50 steps: "
          f"max|diff| / max|w| per record {[f'{e:.3e}' for e in errs]} (tol {NS_TOL:.0e}); "
          f"enstrophy first {ens[:, 0].max().item():.4f} last {ens[:, -1].max().item():.4f}")
    if not (max(errs) <= NS_TOL and ens[:, -1].max() < 2.0 * ens[:, 0].max()):
        raise SystemExit("NS solver: the card disagrees with the CPU, or the enstrophy grew")
    return max(errs)


class GenerationLog(list):
    """While active, every `ns2d.generate_dataset` call (each entry point's
    own, through `build_datasets`) is timed: its seconds (it ends in a copy
    to the host), peak device memory and raw trajectories are appended."""

    def __enter__(self):
        import torch

        from dlwpbench_tpu_torch.data import ns2d

        self.real = real = ns2d.generate_dataset

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            traj = real(*args, **kwargs)
            self.append(dict(seconds=time.perf_counter() - t0, traj=traj,
                             peak=torch.cuda.max_memory_allocated()))
            return traj

        ns2d.generate_dataset = timed
        return self

    def __exit__(self, *exc):
        from dlwpbench_tpu_torch.data import ns2d

        ns2d.generate_dataset = self.real


def run_ns_paths(card: str):
    """The phase "Navier-Stokes and the recurrent models", in one temporary
    working directory: ConvLSTM's user path (`train model=convlstm
    data=navier_stokes` with the shipped training defaults but 10 epochs, its busy share,
    card-vs-CPU rollout and gradients, `build_baselines -c`, `evaluate -c`
    with ACC, the RMSE per lead beside persistence's) and DISTANA's (1
    epoch, the same checks, `evaluate -c` against the same climatology).
    Each entry point generates `navier_stokes.yaml`'s dataset on the card,
    as the JAX CLIs do, and each generation is timed (`GenerationLog`);
    the first one's trajectories are checked and the solver is profiled
    and held against the CPU (`check_solver`, `profile_solver`).  The
    checks beside the CLIs (expected launches, busy share, card vs CPU) run
    on a split of the same shape from 10 solver steps a record.  Then
    ConvLSTMHPX and DISTANAHPX 1 epoch each on `synthetic_hpx8` with
    card-vs-CPU gradients, and the wb_learnable generator.  No attention
    kernel launches anywhere."""
    import numpy as np

    from dlwpbench_tpu_torch import build_baselines
    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    paths, runs, clock = {}, {}, Clock("Navier-Stokes", card)
    t_phase = time.perf_counter()
    cfg = load_config(cli.CONFIG_DIR, overrides=[*NS_CONVLSTM_ARGV, "data.inner_steps=10"])
    train_ds, val_ds, test_ds, _ = build_datasets(
        cfg.data, cfg.training, cfg.validation, cfg.testing, int(cfg.model.context_size),
        device="cuda")
    cwd = os.getcwd()
    with GenerationLog() as gens, tempfile.TemporaryDirectory(prefix="chip_smoke_ns_") as work:
        os.chdir(work)
        try:
            base = None
            for key, argv in (("ns_convlstm", NS_CONVLSTM_ARGV), ("ns_distana", NS_DISTANA_ARGV)):
                label = key.replace("_", " ")
                run_dir = os.path.join(work, "runs", key.split("_")[1])
                run, rcfg, _ = run_train_path(f"{label} train", argv, run_dir, card,
                                              datasets=(train_ds, val_ds))
                if base is None:
                    check_solver(gens[0], rcfg, card)
                    per_step, gen_busy = profile_solver(int(rcfg.data.n),
                                                        int(rcfg.data.n_trajectories), card)
                report_epoch(f"{label} train", run, rcfg, train_ds, card)
                check_train_grads(rcfg, train_ds, card, kernels=False)
                check_rollout_vs_cpu(rcfg, perturbed_state(rcfg), test_ds=test_ds,
                                     weights_label="seeded, moved by 0.01 N(0, 1)")
                clock(f"{label} train, busy share, card vs CPU")
                if base is None:
                    base = build_baselines.main(["-c", run_dir])
                    clock("build_baselines -c")
                ev = evaluate_run_dir(label, run_dir, rcfg, card, NS_EVAL_BATCH, base)
                rmse = ev["res"]["rmse"]["var0"]
                pers = base["persistence"]["rmse"]["var0"]
                print(f"{label}: RMSE of the vorticity per lead (1 .. {len(rmse)}) "
                      f"{np.round(rmse, 4).tolist()}, persistence's "
                      f"{np.round(pers, 4).tolist()} (random init, {rcfg.training.epochs} "
                      f"epoch(s)) [{card}]")
                clock(f"{label} evaluate -c")
                runs[f"{key}_train"] = run
                paths[f"{key}_train"], paths[f"{key}_evaluate"] = run["launches"], ev["launches"]
        finally:
            os.chdir(cwd)
    gen_s = [g["seconds"] for g in gens]
    print(f"NS generations: {len(gens)} (train, build_baselines, evaluate; train, evaluate), "
          f"seconds {[round(s, 2) for s in gen_s]} [{card}]")
    if len(gens) != 5:
        raise SystemExit(f"NS phase: {len(gens)} generations, want 5")

    for key, argv in RECURRENT_HPX_ARGV.items():
        label = key.replace("_", " ")
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
            run, rcfg, rds = run_train_path(f"{label} train", argv, run_dir, card)
        mesh = build_for(rcfg).mesh
        if mesh != "healpix":
            raise SystemExit(f"{label}: mesh {mesh}, want healpix")
        check_train_grads(rcfg, rds, card, kernels=False)
        clock(f"{label} train, card vs CPU gradients")
        runs[f"{key}_train"], paths[f"{key}_train"] = run, run["launches"]

    run_wb_learnable(card)
    clock("wb_learnable")
    used = {p: {n: c for n, c in launches.items() if c} for p, launches in paths.items()}
    print(f"Navier-Stokes phase: {time.perf_counter() - t_phase:.1f} s; the NS generations "
          f"{[round(s, 2) for s in gen_s]} s, {per_step} launches per solver step, busy "
          f"{gen_busy}; attention launches on its {len(paths)} paths {used} (none wanted) "
          f"[{card}]")
    if any(used.values()):
        raise SystemExit(f"Navier-Stokes phase: attention launches {used}")
    return paths, runs


def run_wb_learnable(card: str):
    """`python -m dlwpbench_tpu_torch.make_wb_learnable` (on the card) into
    a temporary root at wb_learnable.yaml's years, timed; the store loaded
    by `build_datasets` on `data=wb_learnable`, its prognostic channels'
    lag autocorrelations."""
    import numpy as np

    from dlwpbench_tpu_torch import make_wb_learnable as wb
    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_wb_") as root:
        t0 = time.perf_counter()
        res = wb.main(["--root", root, *WB_ARGS])
        gen_s = time.perf_counter() - t0
        cfg = load_config(cli.CONFIG_DIR, overrides=["model=convlstm", "data=wb_learnable",
                                                     f"data.data_path={root}"])
        t0 = time.perf_counter()
        train_ds, _, test_ds, _ = build_datasets(cfg.data, cfg.training, cfg.validation,
                                                 cfg.testing, int(cfg.model.context_size))
        load_s = time.perf_counter() - t0
    prog = train_ds.prognostic
    lags = {v: wb.lag_autocorrelations(prog[:, i]) for i, v in
            enumerate(("msl", "stream250", "stream500"))}
    steps = res["frames"] * int(WB_ARGS[-1])
    print(f"wb_learnable: make_wb_learnable {' '.join(WB_ARGS)}: {res['frames']} frames, "
          f"{steps} solver steps, {gen_s:.1f} s (the store written); build_datasets on "
          f"data=wb_learnable {load_s:.2f} s: training {prog.shape}, test {test_ds.prognostic.shape}"
          f"; lag autocorrelations of the training split "
          + "; ".join(f"{v} " + ", ".join(f"lag {k} {r:.3f}" for k, r in lg.items())
                      for v, lg in lags.items()) + f" [{card}]")
    if not (np.isfinite(prog).all() and all(0 < lg[1] <= 1 for lg in lags.values())):
        raise SystemExit(f"wb_learnable: training split finite {np.isfinite(prog).all()}, "
                         f"lags {lags}")
    return gen_s, lags


# ---------------------------------------------------------------- the spectral families
# The shipped configs on 768 synthetic frames (5 full batches of 32 a
# training epoch, 6 validation windows, 7 test inits; half the training
# paths' 1,536 to fit the script's time), on the 32 x 64 grid of
# `BASELINE.json` configs[2] and [3], 4 + 1 + 8 channels: TFNO (`fno.yaml`), FNO
# (`model.type=FNO2DModule`), FourCastNet (`fourcastnet.yaml`, AFNO),
# FourCastNetv2 (`fourcastnetv2.yaml`, the SFNO mixer), SFNO (`sfno.yaml`,
# 18,756,872 parameters) and the ModernUNet with its Fourier block at level 0
# (`modernunet.yaml` + `model.use_fourier=true`).  "user": the user's path
# (train, build_baselines -c, evaluate -c with ACC); else the train CLI only.
SPECTRAL_TAIL = ["data=synthetic", "data.n_time=768", "training.epochs=1"]
SPECTRAL_PATHS = {
    "tfno": (["model=fno", *SPECTRAL_TAIL], True),
    "fno": (["model=fno", "model.type=FNO2DModule", *SPECTRAL_TAIL], False),
    "fourcastnet": (["model=fourcastnet", *SPECTRAL_TAIL], True),
    "fourcastnetv2": (["model=fourcastnetv2", *SPECTRAL_TAIL], False),
    "sfno": (["model=sfno", *SPECTRAL_TAIL], True),
    "munet_fourier": (["model=modernunet", "model.use_fourier=true", *SPECTRAL_TAIL], False),
}
FFT_TOL = 1e-4  # matmul against fft: max|diff| / max|value|, fp32 (DFT sums vs cuFFT)
# Samples of each path's card-vs-CPU gradient check.  The AFNO filter's
# ReLU and softshrink have kinks: an fp32 value within rounding of one
# lands on either side on the two devices and moves one position's term of
# a bias gradient (`b1` sums 32 x 17 positions a sample), by 4.7e-4 and
# 8.3e-4 of that gradient's max at 2 samples in 2 of 12 batches (fp32
# against fp64 on one CPU), at most 2.9e-4 at 8 samples over 12 batches:
# FourCastNet's check takes 8, so that one such term stays well inside the
# tolerance (1e-3); the smooth models take 2, as every earlier path, but
# the ModernUNet with its Fourier block 1, as GraphCast (its CPU side, 89 M
# parameters, dominated the path; 2 until the distributed phase needed the
# time).
GRAD_SAMPLES = {"fourcastnet": 8, "munet_fourier": 1}


def compare_fft_impls(card: str, train_ds):
    """The two `fft_impl` branches of SFNO's `SphericalConv` ([32, 32, 64,
    256], lmax 32) and FourCastNet's `AFNO2DFilter` ([32, 32, 64, 64], 4
    blocks) at the shipped shapes, on one set of weights: the output and
    the input's and every weight's gradient held against each other, the
    forward's and forward + backward's device ms; then one SFNO training
    step at batch 32 both ways (the shipped model, seeded) on `train_ds`."""
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.models.sfno import SphericalConv
    from dlwpbench_tpu_torch.ops.spectral import FFT_IMPLS, AFNO2DFilter
    from dlwpbench_tpu_torch.training.config import load_config

    g = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for name, build, shape in (
        ("SphericalConv", lambda impl: SphericalConv(256, 256, 32, 64, fft_impl=impl),
         (32, 32, 64, 256)),
        ("AFNO2DFilter", lambda impl: AFNO2DFilter(64, 4, fft_impl=impl), (32, 32, 64, 64)),
    ):
        mods = {impl: build(impl).cuda() for impl in FFT_IMPLS}
        mods["fft"].load_state_dict(mods["matmul"].state_dict())
        x = torch.randn(*shape, device="cuda", generator=g)
        w = torch.randn(*shape, device="cuda", generator=g)
        got = {}
        for impl, mod in mods.items():
            xx = x.clone().requires_grad_(True)
            out = mod(xx)
            (out * w).sum().backward()
            got[impl] = {"out": out.detach(), "x": xx.grad,
                         **{n: p.grad for n, p in mod.named_parameters()}}

            def fwd(mod=mod):
                with torch.no_grad():
                    mod(x)

            def fwd_bwd(mod=mod):
                xx = x.detach().requires_grad_(True)
                (mod(xx) * w).sum().backward()

            times[(name, impl)] = (cuda_ms(fwd, 10), cuda_ms(fwd_bwd, 10))
        worst = max(((got["fft"][k] - v).abs().max().item() / v.abs().max().item(), k)
                    for k, v in got["matmul"].items())
        print(f"fft_impl: {name} {list(shape)}: matmul forward {times[(name, 'matmul')][0]:.4f} "
              f"ms, forward + backward {times[(name, 'matmul')][1]:.4f} ms; fft (cuFFT) "
              f"{times[(name, 'fft')][0]:.4f} / {times[(name, 'fft')][1]:.4f} ms; fft against "
              f"matmul worst max|diff|/max {worst[0]:.3e} ({worst[1]}, tol {FFT_TOL:.0e}) [{card}]")
        if not worst[0] <= FFT_TOL:
            raise SystemExit(f"{name}: the fft branch disagrees with the matmul branch")

    cfg = load_config(cli.CONFIG_DIR, overrides=SPECTRAL_PATHS["sfno"][0])
    batch = next(train_ds.batches(int(cfg.training.batch_size)))
    step_ms, losses = {}, {}
    for impl in FFT_IMPLS:
        model = build_for(cfg, {**cfg.model, "fft_impl": impl, "remat": True},
                                     seed=int(cfg.seed)).cuda()
        trainer = run_trainer(cfg, model)
        state = trainer.init()
        tensors = trainer._to_device(batch)
        losses[impl] = trainer.train_step(state, tensors, 1e-3).item()
        step_ms[impl] = cuda_ms(lambda: trainer.train_step(state, tensors, 1e-3), 5)
    rel = abs(losses["fft"] - losses["matmul"]) / abs(losses["matmul"])
    print(f"fft_impl: sfno training step at batch {len(batch[2])}: matmul {step_ms['matmul']:.2f} "
          f"ms, fft {step_ms['fft']:.2f} ms (CUDA events, 5 steps after 2); first-step loss "
          f"matmul {losses['matmul']:.8f} fft {losses['fft']:.8f} (rel {rel:.2e}) [{card}]")
    if not rel <= 1e-5:
        raise SystemExit("sfno: the fft branch's loss disagrees with the matmul branch's")
    return times, step_ms


def run_spectral_paths(card: str):
    """The phase "spectral families": each path of `SPECTRAL_PATHS` through
    the train CLI (1 epoch at batch 32, no attention launch) with its s per
    step, grid-points/s, device ops per step, busy share and peak memory
    after an epoch under set_sync_debug_mode("error"); TFNO's,
    FourCastNet's and SFNO's user paths on through `build_baselines -c`
    and `evaluate -c` with ACC; every model's 2-step rollout and gradients
    card vs CPU (seeded weights moved by 0.01 N(0, 1)); SFNO's profiled
    training step and its epoch in bf16 compute; both `fft_impl` branches
    against each other (`compare_fft_impls`)."""
    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    paths, runs, clock = {}, {}, Clock("spectral", card)
    t_phase = time.perf_counter()
    splits = {}  # context size -> (train, val, test): the paths share one data config
    for key, (argv, user) in SPECTRAL_PATHS.items():
        label = key.replace("_", " ")
        cfg = load_config(cli.CONFIG_DIR, overrides=argv)
        ctx = int(cfg.model.context_size)
        if ctx not in splits:
            splits[ctx] = build_datasets(cfg.data, cfg.training, cfg.validation, cfg.testing,
                                         ctx)[:3]
        train_ds, val_ds, test_ds = splits[ctx]
        if user:
            r = run_user_path(label, argv, card, datasets=(train_ds, val_ds))
            run, rcfg, rds = r["train"], r["cfg"], r["train_ds"]
            paths[f"{key}_evaluate"] = r["launches"]
        else:
            with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
                run, rcfg, rds = run_train_path(f"{label} train", argv, run_dir, card,
                                                datasets=(train_ds, val_ds))
            report_epoch(f"{label} train", run, rcfg, rds, card)
        weights = perturbed_state(rcfg)
        check_rollout_vs_cpu(rcfg, weights, test_ds=test_ds,
                             weights_label="seeded, moved by 0.01 N(0, 1)")
        check_train_grads(rcfg, rds, card, kernels=False, weights=weights,
                          samples=GRAD_SAMPLES.get(key, 2))
        runs[f"{key}_train"], paths[f"{key}_train"] = run, run["launches"]
        clock(f"{label} path, card vs CPU")
        if key == "sfno":
            profile_train_step(rcfg, rds, card)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_sfno_bf16_") as run_dir:
                b16, bcfg, bds = run_train_path(
                    "sfno train bf16", [*argv, "training.compute_dtype=bfloat16"], run_dir, card)
            report_epoch("sfno train bf16", b16, bcfg, bds, card)
            runs["sfno_train_bf16"], paths["sfno_train_bf16"] = b16, b16["launches"]
            print(f"training, fp32 against bf16 compute: sfno {run['seconds_per_step']:.4f} "
                  f"against {b16['seconds_per_step']:.4f} s per step "
                  f"({run['seconds_per_step'] / b16['seconds_per_step']:.2f}x), peak "
                  f"{run['peak_gib']:.2f} against {b16['peak_gib']:.2f} GiB [{card}]")
            clock("sfno profiled step, bf16 epoch")
    fft_times, sfno_step_ms = compare_fft_impls(card, splits[1][0])
    clock("fft_impl comparison")
    used = {p: {n: c for n, c in launches.items() if c} for p, launches in paths.items()}
    print("spectral phase: " + "; ".join(
        f"{k} {r['seconds_per_step']:.4f} s a step, {r['gridpoints_per_s']:.1f} grid-points/s, "
        + ("device not measured" if r["busy"] is None else
           f"{r['device_ops_per_step']:.1f} device ops a step, busy {100 * r['busy']:.1f}%")
        + f", peak {r['peak_gib']:.2f} GiB" for k, r in runs.items())
        + f" [{card}]")
    print(f"spectral phase: {time.perf_counter() - t_phase:.1f} s; attention launches on its "
          f"{len(paths)} paths {used} (none wanted) [{card}]")
    if any(used.values()):
        raise SystemExit(f"spectral phase: attention launches {used}")
    return paths, runs, dict(fft_ms=fft_times, sfno_step_ms=sfno_step_ms)


# ---------------------------------------------------------------- the graph families
# The shipped configs on 448 synthetic frames (3 full training batches of
# 32 and one of 7, 3 validation windows, 4 test inits; under the spectral
# paths' 768, to fit the script's time) on the 32 x 64 grid of
# `BASELINE.json` configs[4], 4 + 1 + 8 channels: GraphCast
# (`graphcast.yaml`: mesh level 3, hidden 512, 16 processor layers,
# 35,232,264 parameters; 2,048 grid nodes, 642 mesh vertices, 5,100
# multimesh edges) and MeshGraphNet (`meshgraphnet.yaml`: its Delaunay graph
# through the edge list, 50,452 parameters) through their user paths;
# MeshGraphNet on the 8-stencil (the stencil movement) through the train CLI.
GRAPH_TAIL = ["data=synthetic", "data.n_time=448", "training.epochs=1"]
GRAPH_PATHS = {
    "graphcast": (["model=graphcast", *GRAPH_TAIL], True),
    "mgn": (["model=meshgraphnet", *GRAPH_TAIL], True),
    "mgn_stencil": (["model=meshgraphnet", "model.graph_type=grid_2d_8stencil", *GRAPH_TAIL],
                    False),
}
# the op groups of a graph model's step device time (CPU op names, forward
# and backward): cuBLAS's products, the gathers with their backward and the
# per-node sums (index_select, index_add, gather), the stencil's rolls and
# zero-filled shifts, LayerNorm and its backward
GRAPH_STEP_GROUPS = {"GEMM": ("aten::mm", "aten::addmm", "aten::bmm"),
                     "gather and index_add": ("index_select", "index_add", "aten::gather"),
                     "roll and pad": ("aten::roll", "constant_pad_nd"),
                     "layer_norm": ("layer_norm",)}
# The onehot form rounds its operands to bf16: the two forms agree within
# one bf16 ulp (2^-8) of each tensor's max.
ONEHOT_TOL = 2.0**-8
# evaluate -c's batch on the graph paths: the 4 test inits as two batches
# of 2, so that one batch after the first gives a steady-state rate
GRAPH_EVAL_BATCH = 2
# Samples of each graph path's card-vs-CPU gradient check: GraphCast's CPU
# side takes about 1.8 TFLOP a sample (2 steps, remat, backward), 1 sample
# keeps it in seconds; the small MeshGraphNets take 2 like the other paths.
GRAPH_GRAD_SAMPLES = {"graphcast": 1}


def compare_movements(card: str):
    """One GraphCast processor layer at the shipped shapes (`MeshEdgeBlock`
    + `MeshNodeBlock`, width 512, batch 32, the multimesh's 5,100 edges and
    642 vertices) on the gather form ("auto", the default) and the onehot
    form, one set of weights: the outputs, the inputs' and every weight's
    gradients against each other within the onehot operands' bf16 rounding;
    the forward's and the forward + backward's device ms (CUDA events)."""
    import torch

    from dlwpbench_tpu_torch.models.graphcast import _movements
    from dlwpbench_tpu_torch.ops.graph_ops import MeshEdgeBlock, MeshNodeBlock

    D, B = 512, 32
    torch.manual_seed(0)
    edge, node = MeshEdgeBlock(3 * D, D, D, 1).cuda(), MeshNodeBlock(2 * D, D, D, 1).cuda()
    mvs = {impl: _movements((32, 64, 3, "cell_centers", "rad"), impl)[1]
           for impl in ("gather", "onehot")}
    E, V = mvs["gather"].src.size, mvs["gather"].n_src
    g = torch.Generator(device="cuda").manual_seed(0)
    e, n, we, wn = (torch.randn(B, m, D, device="cuda", generator=g) for m in (E, V, E, V))

    def layer(ee, nn_, mv):
        ee = edge(ee, nn_, nn_, mv)
        return ee, node(ee, nn_, mv)

    got, times = {}, {}
    for impl, mv in mvs.items():
        edge.zero_grad(set_to_none=True)  # the other form's timed backward passes added to them
        node.zero_grad(set_to_none=True)
        ee, nn_ = e.clone().requires_grad_(True), n.clone().requires_grad_(True)
        oe, on = layer(ee, nn_, mv)
        ((oe * we).sum() + (on * wn).sum()).backward()
        got[impl] = {"edges": oe.detach(), "nodes": on.detach(), "d_edges": ee.grad,
                     "d_nodes": nn_.grad,
                     **{f"edge.{k}": p.grad.clone() for k, p in edge.named_parameters()},
                     **{f"node.{k}": p.grad.clone() for k, p in node.named_parameters()}}

        def fwd(mv=mv):
            with torch.no_grad():
                layer(e, n, mv)

        def fwd_bwd(mv=mv):
            ee, nn_ = e.detach().requires_grad_(True), n.detach().requires_grad_(True)
            oe, on = layer(ee, nn_, mv)
            ((oe * we).sum() + (on * wn).sum()).backward()

        times[impl] = (cuda_ms(fwd, 10), cuda_ms(fwd_bwd, 5))
    worst = max(((got["onehot"][k] - v).abs().max().item() / v.abs().max().item(), k)
                for k, v in got["gather"].items())
    (gf, gfb), (of, ofb) = times["gather"], times["onehot"]
    print(f"movement: one GraphCast processor layer [{B}, {E} edges, {V} vertices, {D}]: "
          f"gather (index_select, index_add) forward {gf:.4f} ms, forward + backward "
          f"{gfb:.4f} ms; onehot (incidence products on cuBLAS, fp32) {of:.4f} / {ofb:.4f} ms "
          f"({of / gf:.2f}x / {ofb / gfb:.2f}x gather's); onehot against gather worst "
          f"max|diff|/max {worst[0]:.3e} ({worst[1]}, tol {ONEHOT_TOL:.1e}, the onehot "
          f"operands' bf16 rounding) [{card}]")
    if not worst[0] <= ONEHOT_TOL:
        raise SystemExit("movement: the onehot form disagrees with the gather form")
    return times


def run_graph_paths(card: str):
    """The phase "graph families": each path of `GRAPH_PATHS` through the
    train CLI (1 epoch at batch 32, no attention launch) with its s per
    step, grid-points/s, device ops per step, busy share and peak memory
    after an epoch under set_sync_debug_mode("error"); GraphCast's and
    MeshGraphNet's user paths on through `build_baselines -c` and `evaluate
    -c` with ACC; every model's 2-step rollout on 2 samples and its
    gradients on `GRAPH_GRAD_SAMPLES` card vs CPU (seeded weights moved by
    0.01 N(0, 1)); each model's profiled training step split
    into GEMMs, gathers and index_add, rolls and pads, LayerNorm and the
    rest; GraphCast's epoch in bf16 compute (the CLI's epoch alone); the
    two movement forms at
    the shipped processor layer's shapes (`compare_movements`)."""
    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.data.sources import build_datasets
    from dlwpbench_tpu_torch.training.config import load_config

    paths, runs, clock = {}, {}, Clock("graph", card)
    t_phase = time.perf_counter()
    cfg = load_config(cli.CONFIG_DIR, overrides=GRAPH_PATHS["graphcast"][0])
    train_ds, val_ds, test_ds = build_datasets(cfg.data, cfg.training, cfg.validation,
                                               cfg.testing, int(cfg.model.context_size))[:3]
    eval_gps = {}
    for key, (argv, user) in GRAPH_PATHS.items():
        label = key.replace("_", " ")
        if user:
            r = run_user_path(label, argv, card, batch=GRAPH_EVAL_BATCH,
                              datasets=(train_ds, val_ds))
            run, rcfg, rds = r["train"], r["cfg"], r["train_ds"]
            paths[f"{key}_evaluate"] = r["launches"]
            eval_gps[key] = r["res"]["gridpoints_per_s"]
        else:
            with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
                run, rcfg, rds = run_train_path(f"{label} train", argv, run_dir, card,
                                                datasets=(train_ds, val_ds))
            report_epoch(f"{label} train", run, rcfg, rds, card)
        runs[f"{key}_train"], paths[f"{key}_train"] = run, run["launches"]
        clock(f"{label} path")
        weights = perturbed_state(rcfg)
        check_rollout_vs_cpu(rcfg, weights, test_ds=test_ds,
                             weights_label="seeded, moved by 0.01 N(0, 1)")
        check_train_grads(rcfg, rds, card, kernels=False, weights=weights,
                          samples=GRAPH_GRAD_SAMPLES.get(key, 2))
        run["step_split"] = profile_step_split(rcfg, rds, card, GRAPH_STEP_GROUPS)
        clock(f"{label} card vs CPU, profiled step")
        if key == "graphcast":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_graphcast_bf16_") as run_dir:
                b16, _, _ = run_train_path(
                    "graphcast train bf16", [*argv, "training.compute_dtype=bfloat16"], run_dir,
                    card, datasets=(train_ds, val_ds))
            b16["busy"] = None  # not profiled: the CLI's epoch alone, to save the time
            runs["graphcast_train_bf16"], paths["graphcast_train_bf16"] = b16, b16["launches"]
            print(f"training, fp32 against bf16 compute: graphcast {run['seconds_per_step']:.4f} "
                  f"against {b16['seconds_per_step']:.4f} s per step "
                  f"({run['seconds_per_step'] / b16['seconds_per_step']:.2f}x), peak "
                  f"{run['peak_gib']:.2f} against {b16['peak_gib']:.2f} GiB [{card}]")
            clock("graphcast bf16 epoch")
    movement_ms = compare_movements(card)
    clock("movement forms")
    used = {p: {n: c for n, c in launches.items() if c} for p, launches in paths.items()}
    print("graph phase: " + "; ".join(
        f"{k} {r['seconds_per_step']:.4f} s a step, {r['gridpoints_per_s']:.1f} grid-points/s, "
        + ("device not measured" if r["busy"] is None else
           f"{r['device_ops_per_step']:.1f} device ops a step, busy {100 * r['busy']:.1f}%")
        + f", peak {r['peak_gib']:.2f} GiB" for k, r in runs.items())
        + f"; evaluate -c at batch {GRAPH_EVAL_BATCH} " + ", ".join(
            f"{k} {v} grid-points/s" for k, v in eval_gps.items())
        + f" [{card}]")
    print(f"graph phase: {time.perf_counter() - t_phase:.1f} s; attention launches on its "
          f"{len(paths)} paths {used} (none wanted) [{card}]")
    if any(used.values()):
        raise SystemExit(f"graph phase: attention launches {used}")
    return paths, runs, dict(movement_ms=movement_ms, evaluate_gridpoints_per_s=eval_gps)


# ---------------------------------------------------------------- the packed path
PACKED_STEPS = 3


def run_packed_path(card: str):
    """Three emulated Pangu attention steps at batch 32 through the public
    `packed_window_attention`: in each, forward and backward at every one
    of the shipped Pangu's 16 blocks' shapes (from its own block plan), the
    shift mask on the odd blocks of each layer and none on the even, and the
    query-major bias expanded from a per-block earth-position table, as the
    model expands its own.  Every counter is set to 0 just before and read
    just after; B5 must launch once per block and step each way and no
    other kernel at all."""
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.models.pangu import expand_earth_bias, shift_window_mask
    from dlwpbench_tpu_torch.ops import packed_attention as pk
    from dlwpbench_tpu_torch.training.config import load_config

    cfg = load_config(cli.CONFIG_DIR, overrides=PANGU_TRAIN_ARGV)
    model = build_for(cfg)  # its geometry only
    win = model.window_size
    N = win[0] * win[1] * win[2]
    gen = torch.Generator(device="cuda").manual_seed(5)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    blocks = []
    for blk in model._block_plan():
        pad = blk["pad_res"]
        nW, nLon = (pad[0] // win[0]) * (pad[1] // win[1]), pad[2] // win[2]
        nh, hd = blk["heads"], blk["dim"] // blk["heads"]
        BW = EVAL_BATCH * nLon * nW
        mask = None
        if blk["shift"]:
            shift = tuple(w // 2 for w in win)
            mask = torch.as_tensor(shift_window_mask(pad, win, shift), device="cuda")
        leaves = [randn(BW, nh, N, hd).requires_grad_() for _ in range(3)]
        table = randn(win[0] ** 2 * win[1] ** 2 * (2 * win[2] - 1), nW, nh).requires_grad_()
        blocks.append((leaves, table, mask, randn(BW, nh, N, hd)))
    del model
    leaves_all = [t for lv, table, _, _ in blocks for t in (*lv, table)]

    counters = counters_of()
    reset_counters(counters)
    step_s = []
    for _ in range(PACKED_STEPS):
        for t in leaves_all:
            t.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [pk.packed_window_attention(
                    *lv, expand_earth_bias(table, win).transpose(-1, -2).contiguous(), mask)
                for lv, table, mask, _ in blocks]
        torch.autograd.backward(outs, [g for *_, g in blocks])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        del outs
    launches = {name: fn.launches for name, fn in counters.items()}

    per_step = len(blocks)
    want = {name: 0 for name in counters}
    want["packed_window_attention"] = want["packed_window_attention_bwd"] = per_step * PACKED_STEPS
    shifted = sum(m is not None for _, _, m, _ in blocks)
    finite = all(torch.isfinite(t.grad).all().item() for t in leaves_all)
    print(f"packed path: {PACKED_STEPS} emulated Pangu attention steps at batch {EVAL_BATCH}, "
          f"forward + backward through packed_window_attention at each of {per_step} blocks "
          f"({shifted} with the shift mask), fp32: step seconds "
          f"{[round(s, 4) for s in step_s]}, steady-state {sum(step_s[1:]) / len(step_s[1:]):.4f} "
          f"s per step; gradients finite {finite} [{card}]")
    print(f"packed path launches {launches} (wants {want})")
    if launches != want or not finite:
        raise SystemExit(f"packed path: launches {launches}, want {want}; finite {finite}")
    return launches, check_fused("packed path", counters, launches)


# ---------------------------------------------------------------- the ladder phase
# The reference's parameter ladder through `python -m
# dlwpbench_tpu_torch.benchmark_ladder` (called in-process), one row a
# call, each the remat train step at batch 1 and sequence length 15 (14
# rollout steps; the steps timed and counted: `LADDER_TIMING`).  The
# attention rows run in this process beside the attention paths: the Swin
# at head dims 56 (the flash kernels' mma designs), 80 and 120 (their row
# kernels), Pangu at batch 1 and 2 (head dim 16), the 8x8 windowed Swin at
# 2.0 degrees on the token-major kernels (276 windows >= 64), the Swin in
# bf16 compute.  The second process runs the kernel-free
# rows, the graph FLOP backfill and the rollout and training matrices.
# (family, rung, extra argv, the kernels the row must launch: "mma" all on
# the tensor-core design, "rows" all on the row kernels, "bf16" all on the
# bf16 instance, "any" at least once; every other kernel 0 times).  A row
# at another batch than the ladder's 1 goes to a file of its own, its key
# being the batch-1 row's.
LADDER_CARD_ROWS = [
    ("swin", "8m", [], {"flash_window_attention": "mma", "flash_window_attention_bwd": "mma"}),
    ("swin", "16m", [], {"flash_window_attention": "rows", "flash_window_attention_bwd": "rows"}),
    ("swin", "32m", [], {"flash_window_attention": "rows", "flash_window_attention_bwd": "rows"}),
    # at batch 1 the routing rule (B*nLon*nW >= 64, as JAX's) sends all of
    # Pangu's windows to einsum (36 at stage 1, 9 at stage 2): no kernel; at
    # batch 2 its stage-1 blocks (72 windows) take the 5D kernels
    ("pangu", "8m", [], {}),
    ("pangu", "8m", ["--batch", "2"],
     {"window_attention_qkv5d": "any", "window_attention_qkv5d_bwd": "any"}),
    ("swin_win8", "2m", ["--grid", "90x180"],
     {"window_attention_qkv": "any", "window_attention_qkv_bwd": "any"}),
    ("swin", "8m", ["--compute-dtype", "bfloat16"],
     {"flash_window_attention": "bf16", "flash_window_attention_bwd": "bf16"}),
]
# The SFNO rows feed `scaling_model`: its SFNO families' single-card step
# (sfno2d@8m) and the bf16 / fp32 step ratio of its bf16-exchange rows
# (sfno2d@32m in both)
LADDER_SIDE_ROWS = [("unet", "8m", [], {}), ("graphcast", "2m", [], {}),
                    ("diffusion", "2m", [], {}), ("sfno2d", "8m", [], {}),
                    ("sfno2d", "32m", [], {}),
                    ("sfno2d", "32m", ["--compute-dtype", "bfloat16"], {})]
# JAX's ladder on its TPU (`results/ladder.json`, read only): the widths
# the port's `solve_width` must give for the same keys
JAX_LADDER = os.path.join(REPO, "results", "ladder.json")
# the smoke's timing of a row (and of the training matrix): the first call
# of one step, one timed step and the counted one, where the entry's
# default of 4 x 3 runs 17 steps (eager steps of 0.3 .. 2 s at batch 1
# while the two processes share the host and the card): a reading that
# the row runs, not the row's time
LADDER_TIMING = ["--repeats", "1", "--iters", "1"]


def ladder_key(family: str, rung: str, extra: list) -> tuple[str, str]:
    """(the row's key in its ladder file, its label: the key and any batch
    other than 1)."""
    grid = extra[extra.index("--grid") + 1] if "--grid" in extra else "32x64"
    key = f"{family}@{rung}@{grid}" + ("@bf16" if "--compute-dtype" in extra else "")
    batch = extra[extra.index("--batch") + 1] if "--batch" in extra else None
    return key, key + (f" batch {batch}" if batch else "")


def _launch_ok(fn_launches: int, new: int | None, bf16: int, want: str) -> bool:
    if fn_launches <= 0:
        return False
    if want == "mma":
        return new == fn_launches
    if want == "rows":
        return new == 0
    if want == "bf16":
        return bf16 == fn_launches
    return True


def run_ladder_rows(card: str, out: str, rows: list) -> dict:
    """Each row through `benchmark_ladder.main` into `out` (a row at
    another batch into a file beside it), every launch counter set to 0
    just before and read just after; prints the row's parameters, width,
    step ms, epoch(2014) s, peak MB, TFLOP/s and launches by kernel, and
    checks it: no `error`, JAX's width and parameter count for the key,
    the kernels `rows` names launched on their designs and no other
    kernel.  Returns each row's launches, by path ("ladder <label>")."""
    import torch

    from dlwpbench_tpu_torch import benchmark_ladder

    with open(JAX_LADDER) as f:
        jax_ladder = json.load(f)
    counters = counters_of()
    paths, failures = {}, []
    for family, rung, extra, want in rows:
        key, label = ladder_key(family, rung, extra)
        path = out if label == key else out[:-5] + "_" + label.split()[-1] + ".json"
        reset_counters(counters)
        res = benchmark_ladder.main(["--families", family, "--rungs", rung, "--out", path,
                                     *LADDER_TIMING, *extra])
        launches = _launches(counters)
        new = new_design_launches(counters)
        # a row that names "mma" reads that design's own counter (the flash
        # backward's new design is wgmma; the ladder's D 56 takes the mma)
        new.update({n: counters[n].mma_launches for n, d in want.items() if d == "mma"})
        bf16 = {n: fn.bf16_launches for n, fn in counters.items()}
        e, ref = res[key], jax_ladder.get(key.removesuffix("@bf16"), {})
        ok = ("error" not in e and e.get("width") == ref.get("width")
              and e.get("params") == ref.get("params") and bool(e.get("device"))
              and all(_launch_ok(launches[n], new.get(n), bf16[n], want[n]) if n in want
                      else launches[n] == 0 for n in counters))
        paths[f"ladder {label}"] = launches
        fired = {n: c for n, c in launches.items() if c}
        designs = {n: c for n, c in new.items() if launches[n]}
        bf16_fired = {n: c for n, c in bf16.items() if c}
        row = (f"FAILED {e['error']}" if "error" in e else
               f"{e['params']:,} parameters, width {e['width']} (JAX {ref.get('width')}, "
               f"{ref.get('params', 0):,}), step {e['step_s'] * 1e3:.1f} ms, epoch(2014) "
               f"{e['epoch_s_2014_protocol']:.2f} s, peak {e.get('peak_mb')} MB, "
               f"{e.get('achieved_tflops')} TFLOP/s ({e.get('flops_per_step', 0):.4e} FLOP a "
               f"step, attention {e.get('attention_flops_per_step', 0):.4e}), first call "
               f"{e['compile_s']} s")
        print(f"ladder {label}: {row}; launches {fired or 'none'} (tensor-core design "
              f"{designs}, bf16 {bf16_fired}; want {want or 'none'}) {'ok' if ok else 'FAIL'} "
              f"[{card}]")
        if not ok:
            failures.append(label)
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"ladder rows failed their checks: {failures}")
    return paths


def wait_for_build(timeout_s: float = 900.0):
    """Waits until every kernel library the first process builds exists
    (the second process loads them; it never builds)."""
    from dlwpbench_tpu_torch.ops import _build

    names = [os.path.basename(p)[:-3] for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))]
    t0 = time.perf_counter()
    while not all(os.path.exists(_build.library_path(n)) for n in names):
        if time.perf_counter() - t0 > timeout_s:
            raise SystemExit(f"the kernels were not built within {timeout_s:.0f} s")
        time.sleep(2.0)
    return time.perf_counter() - t0


def ladder_side_phase(card: str) -> dict:
    """The second process's part of the ladder phase: the kernel-free rows
    (U-Net, GraphCast, the diffusion model's denoiser step), the graph
    FLOP backfill on JAX's recorded GraphCast entry for the same key (the
    port's gather-form count must be its own row's executed one, JAX's
    one-hot count and times untouched), then the zoo's rollout matrix
    (`python -m dlwpbench_tpu_torch.benchmark_models`, every model, 4 lead
    steps, 1 timed group) and the training matrix (`python -m
    dlwpbench_tpu_torch.benchmark_training --models unet,swin`, batch 32),
    which reach the attention kernels through the Swin and Pangu (built by
    the first process: this one waits for the libraries).  Returns the
    launches by path and the ladder's entries."""
    from dlwpbench_tpu_torch import backfill_graph_flops, benchmark_models, benchmark_training

    clock = Clock("ladder (second process)", card)
    work = tempfile.mkdtemp(prefix="chip_smoke_ladder_side_")
    out = os.path.join(work, "ladder.json")
    try:
        paths = run_ladder_rows(card, out, LADDER_SIDE_ROWS)
        clock("kernel-free rows")
        gkey = next(ladder_key(*row[:3])[0] for row in LADDER_SIDE_ROWS if row[0] == "graphcast")
        with open(JAX_LADDER) as f:
            jax_entry = json.load(f)[gkey]
        with open(out) as f:
            own = json.load(f)[gkey]
        jax_file = os.path.join(work, "jax_ladder.json")
        with open(jax_file, "w") as f:
            json.dump({gkey: jax_entry}, f)
        res = backfill_graph_flops.main(["--ladder", jax_file, "--force", "--training",
                                         os.path.join(work, "benchmark_training.json")])
        g = res["ladder"][gkey]
        ok = (g.get("algorithmic_flops_per_step") == own.get("flops_per_step") > 0
              and all(g[k] == jax_entry[k] for k in ("flops_per_step", "step_s", "width")))
        print(f"backfill_graph_flops on JAX's {gkey}: algorithmic "
              f"{g.get('algorithmic_flops_per_step', 0):.4e} FLOP a step (JAX's recorded "
              f"{jax_entry.get('algorithmic_flops_per_step', 0):.4e}), the port's row executed "
              f"{own.get('flops_per_step', 0):.4e} (the gather form both), JAX's one-hot "
              f"{g['flops_per_step']:.4e} and step {g['step_s']} s kept, "
              f"{g.get('algorithmic_tflops')} TFLOP/s at JAX's step {'ok' if ok else 'FAIL'} "
              f"[{card}]")
        if not ok:
            raise SystemExit("backfill_graph_flops: the gather form's count is not the port's "
                             "executed one, or JAX's figures changed")
        clock("graph FLOP backfill")
        waited = wait_for_build()
        counters = counters_of()
        for label, fn, argv, want in (
            ("matrix benchmark_models", benchmark_models.main,
             ["--steps", "4", "--iters", "1", "--out-dir", work],
             ("flash_window_attention",)),  # Pangu at batch 1: einsum (36 and 9 windows)
            ("matrix benchmark_training", benchmark_training.main,
             ["--models", "unet,swin", *LADDER_TIMING, "--out-dir", work],
             ("flash_window_attention", "flash_window_attention_bwd")),
        ):
            reset_counters(counters)
            payload = fn(argv)
            paths[label] = launches = _launches(counters)
            rows = payload["results"]
            bad = [n for n, r in rows.items() if "error" in r]
            for name, r in rows.items():
                if "error" in r:
                    print(f"{label} {name}: FAILED {r['error']}")
                    continue
                rate = (f"rollout {r['rollout_s'] * 1e3:.2f} ms, {r['gridpoints_per_s']:,.1f} "
                        "grid-points/s" if "rollout_s" in r else
                        f"step {r['train_step_s'] * 1e3:.1f} ms at batch {payload['batch']}, "
                        f"epoch equivalent {r['epoch_equivalent_s']:.2f} s, "
                        f"{r.get('achieved_tflops')} TFLOP/s")
                print(f"{label} {name}: {r['params']:,} parameters, {rate}, peak "
                      f"{r.get('peak_mb')} MB [{card}]")
            fired = {n: c for n, c in launches.items() if c}
            ok = not bad and all(launches[n] > 0 for n in want)
            print(f"{label}: {len(rows)} models, launches {fired} (want {list(want)} > 0) "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise SystemExit(f"{label}: failed rows {bad}, launches {fired}")
            clock(label + (f" (waited {waited:.1f} s for the build first)"
                           if label.endswith("models") else ""))
        with open(out) as f:
            entries = json.load(f)
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    return {"paths": paths, "entries": entries}


def ladder_tables_of(card: str, out: str):
    """`python -m dlwpbench_tpu_torch.ladder_tables` on the phase's ladder
    file (both processes' rows): prints its tables; the figure is skipped
    where matplotlib is not installed."""
    from dlwpbench_tpu_torch import ladder_tables

    lines = ladder_tables.main(["--ladder", out, "--out-md", out[:-5] + "_tables.md",
                                "--out-png", out[:-5] + "_over_params.png"])
    tables = [ln for ln in lines if ln.startswith(("|", "## ", "Device:"))]
    print("\n".join(tables))
    if not any(ln.startswith("| 8m |") for ln in tables):
        raise SystemExit("ladder_tables: no 8m row in the phase's tables")


# ---------------------------------------------------------------- the distributed phase
# Two ranks, one process each, share the one card through gloo (NCCL
# refuses two ranks on one device); the collectives move CUDA tensors
# through pinned host memory (`parallel/launch.py`).  The parent built the
# kernels; each rank loads them from build/cuda/.
DIST_RANKS = 2
DIST_TIMEOUT_S = 600  # a rank that hangs fails the phase
# ring attention on the card: the Swin's stage 0 (its global window, the
# shifted bias) and Pangu's flash route at stage 1 (the grouped bias with
# the shift mask, one group per (lon, window))
RING_CASES = [("swin stage0 shifted", EVAL_BATCH, 4, 2048, 24, 1, "swin-shift"),
              # the shifted mask keeps each rank's queries on its own keys
              # (the other chunk's weights underflow), so the unshifted
              # bias is what exercises the merge at this shape
              ("swin stage0 unshifted", EVAL_BATCH, 4, 2048, 24, 0, "random"),
              ("pangu stage1 flash G=36", EVAL_BATCH * 36, 6, 144, 32, 36, "pangu-shift")]
# the ring against one kernel call on the same inputs, fp32, relative to
# each tensor's max: the chunked log-sum-exp merge sums in another order
# (FLASH_TOL's 5e-5 for the output, FLASH_BWD_TOL's 1e-4 for gradients)
RING_TOL = {"out": 5e-5, "grad": 1e-4}
# the sharded model forwards (the Swin with spmd_mesh, the partitioned
# GraphCast, the halo and the HEALPix pad) against the single-device ones
# on the card, relative to the output's max: the same ops on other row
# splits (cuBLAS picks kernels by shape; the graph sums are atomics)
SHARDED_TOL = 1e-4
# the spectral models with spmd_mesh against the single rank on the same
# weights: fp32 exchanges within SHARDED_TOL of each tensor's max (outputs
# and every parameter gradient summed over the ranks); bf16 compute (and
# so, under dist_comm_bf16 "auto", bf16 exchanges) within JAX's 3e-2 of
# the fp32 output's max (`tests/test_parallel.py`'s bf16-comm bound)
SPECTRAL_BF16_TOL = 3e-2
SPECTRAL_BATCH = 4
SPECTRAL_CASES = [("sfno per_conv", ["model=sfno"], {}),
                  ("sfno fused", ["model=sfno"], {"dist_schedule": "fused"}),
                  ("fourcastnet", ["model=fourcastnet"], {}),
                  ("fourcastnetv2", ["model=fourcastnetv2"], {}),
                  # the FNO2D mixer: the token rows gathered for the operator
                  ("fourcastnet fno2d", ["model=fourcastnet", "model.filter=FNO2D"], {})]
# the data-parallel training against the single-rank train path, as
# `tests/test_torch_trainer.py` holds the port's trainer against JAX's:
# per-step losses rtol 1e-5, final parameters within lr / 100 (Adam moves
# each parameter by about lr a step, so a wrong update to any tensor fails)
DP_LOSS_RTOL = 1e-5
DP_PARAM_ATOL = 1e-3 / 100  # training.learning_rate / 100


def spawn_ranks(work: str, n: int = DIST_RANKS, entry: str = "dist_rank") -> list:
    """Run `n` ranks (`entry`: `dist_rank`, or `mesh_rank` for the 2x2
    meshes) on the card, print their output, and return each rank's
    results; a rank that fails or hangs fails the script."""
    import pickle

    from dlwpbench_tpu_torch.parallel import launch

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(launch.free_port()),
               WORLD_SIZE=str(n))
    code = f"import sys, chip_smoke; sys.exit(chip_smoke.{entry}(sys.argv[1]))"
    procs = [subprocess.Popen([sys.executable, "-c", code, work], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"[rank {r}] {line}")
        if p.returncode != 0:
            raise SystemExit(f"{entry}: rank {r} of {n} exited {p.returncode}")
    results = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def dist_rank(work: str) -> int:
    """One rank of the distributed phase: joins the gloo group from the
    torch-style variables, runs `dp_suite`, `exchanges_suite` and
    `spectral_suite` on cuda:0 (one process start for all), writes its
    results to `work/rank<r>.pkl`."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlwpbench_tpu_torch.parallel import launch

    if not launch.initialize(backend="gloo"):
        raise SystemExit("no distributed job in the environment")
    rank, world = launch.host_info()
    t0 = time.perf_counter()
    res = {"dp": dp_suite(rank, world, work)}
    t1 = time.perf_counter()
    res["exchanges"] = exchanges_suite(rank, world, work)
    t2 = time.perf_counter()
    res["spectral"] = spectral_suite(rank, world)
    res["seconds"] = {"dp": t1 - t0, "exchanges": t2 - t1, "spectral": time.perf_counter() - t2}
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _launches(counters) -> dict:
    return {n: fn.launches for n, fn in counters.items()}


def dp_suite(rank: int, world: int, work: str) -> dict:
    """The shipped Swin's train path (TRAIN_ARGV: its data, seed and
    epochs) with `training.data_parallel=2`: each rank its half of every
    global batch, the gradients summed over the ranks."""
    from dlwpbench_tpu_torch import train as cli

    counters = counters_of()
    reset_counters(counters)
    run_dir = os.path.join(work, "dp_run")
    t0 = time.perf_counter()
    res = cli.main([*TRAIN_ARGV, "training.data_parallel=2", f"run_dir={run_dir}",
                    "--device", "cuda:0"])
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, launches=_launches(counters), fused=new_design_launches(counters),
                step_losses=res["step_losses"], step_seconds=res["step_seconds"],
                train_loss=res["train_loss"], val_loss=res["val_loss"], rank=res["rank"],
                params={n: p.detach().cpu() for n, p in res["state"].model.named_parameters()})


def _rel(a, b) -> float:
    """max|a - b| / max|b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def _host_ms(fn, iters: int = 5) -> float:
    """Wall ms of `fn` after one warm-up, the card synchronised around it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def exchanges_suite(rank: int, world: int, work: str) -> dict:
    """Ring attention at the Swin's and Pangu's shapes, a Swin forward with
    `spmd_mesh`, the halo, the sharded HEALPix pad at nside 32 and a
    partitioned GraphCast forward at its shipped width, each against the
    single-device result on the card; the launches of each ring path."""
    import torch
    import torch.nn.functional as F

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.ops import flash_attention as fa
    from dlwpbench_tpu_torch.ops.padding import cylinder_pad, healpix_pad_channels_last
    from dlwpbench_tpu_torch.parallel import halo, healpix_sharded, launch, ring_attention
    from dlwpbench_tpu_torch.training.config import load_config

    mesh = launch.global_mesh(data=1, x=world)
    group = mesh.get_group("x")
    counters = counters_of()
    res = {"ring": []}
    for label, B, H, N, D, G, kind in RING_CASES:
        gen = torch.Generator(device="cuda").manual_seed(7)  # the same inputs on every rank
        q, k, v, bias = _flash_inputs(B, H, N, D, G, kind, torch.float32, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        reset_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_attention.ring_attention_sharded(*leaves, mesh, axis="x")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.backward(do)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, fused = _launches(counters), new_design_launches(counters)
        # one kernel call each way on the same inputs (not counted)
        ref = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        ref_out = fa.flash_window_attention(*ref)
        ref_out.backward(do)
        errs = {"out": _rel(out, ref_out)}
        errs.update({f"d{n}": _rel(a.grad, b.grad) for n, a, b in zip("qkvb", leaves, ref)})
        # one round's exchange alone: this rank's kv chunk on to the next
        kc, vc = (t[:, :, : N // world].contiguous() for t in (k, v))
        ko, vo = torch.empty_like(kc), torch.empty_like(vc)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        exch_ms = _host_ms(lambda: launch.Exchange([(kc, nxt), (vc, nxt)],
                                                   [(ko, prv), (vo, prv)], group).wait())
        res["ring"].append(dict(case=label, B=B, H=H, N=N, D=D, bias=list(bias.shape),
                                fwd_s=t1 - t0, bwd_s=t2 - t1, launches=launches, fused=fused,
                                errors=errs, exchange_ms=exch_ms,
                                chunk_mb=2 * kc.numel() * 4 / 1e6))
        del q, k, v, bias, do, leaves, out, ref, ref_out, kc, vc, ko, vo
        torch.cuda.empty_cache()

    # the shipped Swin, one forward (4 samples, 1 step) with and without spmd_mesh
    cfg = load_config(cli.CONFIG_DIR, overrides=["model=swintransformer", "data=synthetic"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    d = cfg.data
    inputs = [torch.randn(4, t, c, d.height, d.width, device="cuda", generator=gen)
              for t, c in ((1, d.constant_channels), (2, d.prescribed_channels),
                           (2, d.prognostic_channels))]
    with torch.no_grad():
        single = build_for(cfg, seed=int(cfg.seed)).cuda().eval()
        want = single(*inputs)
        ring_model = build_for(cfg, seed=int(cfg.seed), spmd_mesh=mesh).cuda().eval()
        reset_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ring_model(*inputs)
        torch.cuda.synchronize()
        res["swin"] = dict(seconds=time.perf_counter() - t0, launches=_launches(counters),
                           fused=new_design_launches(counters), err=_rel(got, want),
                           blocks=sum(single.depths))
        del single, ring_model, want, got

    # the halo: rows of [4, 64, 32, 64] split over the ranks, d(sum of a
    # valid 3x3 conv squared) against the single-device cylinder pad
    x = torch.randn(4, 64, 32, 64, device="cuda", generator=gen)
    kern = torch.randn(1, 1, 3, 3, device="cuda", generator=gen)
    conv = lambda y: F.conv2d(y.reshape(-1, 1, *y.shape[-2:]), kern)  # noqa: E731
    hl = x.shape[-2] // world
    xl = x[..., rank * hl:(rank + 1) * hl, :].contiguous().requires_grad_()
    got = halo.sharded_cylinder_pad(xl, 1)
    (conv(got) ** 2).sum().backward()
    xs = x.clone().requires_grad_()
    want = cylinder_pad(xs, 1)
    (conv(want) ** 2).sum().backward()
    res["halo"] = dict(err=_rel(got, want[..., rank * hl: rank * hl + hl + 2, :]),
                       grad_err=_rel(xl.grad, xs.grad[..., rank * hl:(rank + 1) * hl, :]),
                       ms=_host_ms(lambda: halo.sharded_cylinder_pad(xl.detach(), 1)),
                       shape=list(x.shape))

    # the sharded HEALPix pad at nside 32, 64 channels, and its gradient
    x = torch.randn(12, 32, 32, 64, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(12, 34, 34, 64, device="cuda", generator=gen)
    pad = healpix_sharded.make_sharded_healpix_pad(mesh, 32, 1)
    got = pad(x)
    (got * w).sum().backward()
    g_sharded = x.grad.clone()
    x.grad = None
    want = healpix_pad_channels_last(x[None], 1)[0]
    (want * w).sum().backward()
    res["hpx_pad"] = dict(err=_rel(got, want), grad_err=_rel(g_sharded, x.grad),
                          ms=_host_ms(lambda: pad(x.detach())), shape=list(x.shape))
    del x, w, got, want

    # the partitioned GraphCast at graphcast.yaml's width, one forward at batch 1
    gcfg = load_config(cli.CONFIG_DIR, overrides=["model=graphcast", "data=synthetic"])
    inputs = [t[:1] for t in inputs]
    with torch.no_grad():
        single = build_for(gcfg, seed=int(gcfg.seed)).cuda().eval()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = single(*inputs)
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        part = build_for(gcfg, seed=int(gcfg.seed), spmd_mesh=mesh).cuda().eval()
        part(*inputs)  # the first call builds the plans' device tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = part(*inputs)
        torch.cuda.synchronize()
        res["graphcast"] = dict(err=_rel(got, want), seconds=time.perf_counter() - t0,
                                single_seconds=t_single)
    return res


def _fused_tree(tree: dict, layers: int) -> dict:
    """The per-conv SFNO's flax tree as the fused schedule's (JAX
    `models/sfno.py:_fused_blocks`): per block its spectral weight, the
    skip Dense and the MLP's two on the root as `blocks_{i}_*`, the
    encoder and decoder Dense_0, 1 and 2, 3."""
    out = {k: v for k, v in tree.items() if k in ("Dense_0", "Dense_1", "pos_embed")}
    for i in range(layers):
        out[f"blocks_{i}_spec"] = tree[f"SphericalConv_{i}"]["weight"]
        for name, d in (("skip", 2 + 3 * i), ("mlp1", 3 + 3 * i), ("mlp2", 4 + 3 * i)):
            out[f"blocks_{i}_{name}_kernel"] = tree[f"Dense_{d}"]["kernel"]
            out[f"blocks_{i}_{name}_bias"] = tree[f"Dense_{d}"]["bias"]
    out["Dense_2"], out["Dense_3"] = tree[f"Dense_{2 + 3 * layers}"], tree[f"Dense_{3 + 3 * layers}"]
    return out


def _worst_grad_err(got: dict, want: dict) -> tuple:
    """(max over tensors of max|got - want| / max|want|, its name); a
    tensor whose gradient is zero in exact arithmetic (max under 1e-6 of
    the largest) is held to the largest."""
    top = max(float(abs(w).max()) for w in want.values())
    worst = (0.0, None)
    for name, w in want.items():
        scale = float(abs(w).max())
        if scale < 1e-6 * top:
            scale = top
        worst = max(worst, (float(abs(got[name] - w).max()) / scale, name))
    return worst


def spectral_suite(rank: int, world: int) -> dict:
    """The distributed spectral models on the card (`SPECTRAL_CASES` at
    their shipped widths on the synthetic grid, one batch of
    `SPECTRAL_BATCH` samples x 1 step): each with `spmd_mesh` against the
    single rank on the same weights, the forward and every parameter
    gradient (summed over the ranks, as the trainer does); the SFNO's two
    schedules in bf16 compute too; the transforms alone on [4, 256, 32,
    64]; one all-to-all; the attention launches of each meshed run."""
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch import weights
    from dlwpbench_tpu_torch.ops.sht import isht, sht, sht_tables
    from dlwpbench_tpu_torch.parallel import fft, launch, sht_dist
    from dlwpbench_tpu_torch.training.config import load_config

    mesh = launch.global_mesh(data=1, x=world)
    group = mesh.get_group("x")
    counters = counters_of()
    res = {"models": []}
    gen = torch.Generator(device="cuda").manual_seed(13)
    d = load_config(cli.CONFIG_DIR, overrides=["model=sfno", "data=synthetic"]).data
    inputs = [torch.randn(SPECTRAL_BATCH, t, c, d.height, d.width, device="cuda", generator=gen)
              for t, c in ((1, d.constant_channels), (2, d.prescribed_channels),
                           (2, d.prognostic_channels))]

    def fwd_bwd(model, xs):
        model.zero_grad(set_to_none=True)
        out = model(*xs)
        (out.float() ** 2).mean().backward()
        return out.detach().float()

    def flax_grads(model):
        return weights.flatten_tree(weights.to_flax_tree(
            model, {n: p.grad for n, p in model.named_parameters()}))

    for label, overrides, kw in SPECTRAL_CASES:
        cfg = load_config(cli.CONFIG_DIR, overrides=[*overrides, "data=synthetic"])
        single = build_for(cfg, seed=int(cfg.seed)).cuda()
        want = fwd_bwd(single, inputs)
        want_grads = flax_grads(single)
        single_ms = _host_ms(lambda: fwd_bwd(single, inputs), iters=3)
        tree = weights.to_flax_tree(single)
        meshed = build_for(cfg, seed=int(cfg.seed), spmd_mesh=mesh, **kw).cuda()
        fused = kw.get("dist_schedule") == "fused"
        weights.load_flax_params(meshed, _fused_tree(tree, meshed.num_layers) if fused else tree)
        if fused:
            want_grads = weights.flatten_tree(_fused_tree(weights.unflatten_tree(want_grads),
                                                          meshed.num_layers))
        reset_counters(counters)
        got = fwd_bwd(meshed, inputs)
        launch.all_reduce_([p.grad for p in meshed.parameters()], meshed.partition_group)
        torch.cuda.synchronize()
        launches = _launches(counters)
        grad_err, grad_name = _worst_grad_err(flax_grads(meshed), want_grads)
        meshed_ms = _host_ms(lambda: fwd_bwd(meshed, inputs), iters=3)
        case = dict(case=label, err=_rel(got, want), grad_err=grad_err, grad_name=grad_name,
                    n_grads=len(want_grads), launches=launches, ms=meshed_ms,
                    single_ms=single_ms, params=sum(p.numel() for p in single.parameters()))
        if label.startswith("sfno"):  # bf16 compute: "auto" ships bf16 exchanges
            meshed.to(torch.bfloat16)
            out16 = fwd_bwd(meshed, [x.to(torch.bfloat16) for x in inputs])
            case["bf16_err"] = _rel(out16, want)
        res["models"].append(case)
        del single, meshed
        torch.cuda.empty_cache()

    # the transforms alone on [4, 256, 32, 64], this rank's rows
    x = torch.randn(4, 256, d.height, d.width, device="cuda", generator=gen)
    t = sht_tables(d.height, d.width)
    h = d.height // world
    xl = x[..., rank * h:(rank + 1) * h, :].contiguous()
    a = sht_dist.dist_sht(xl, t, group)
    y = sht_dist.dist_isht(a, t, group)
    a_single = sht(x, t)
    m_loc = a.shape[-1]
    lo, hi = rank * m_loc, min((rank + 1) * m_loc, t.mmax)
    X = fft.dist_rfft2(xl, group)
    back = fft.dist_irfft2(X, d.width, group)
    X_single = torch.fft.fft(torch.fft.rfft(x, dim=-1), dim=-2)
    wf = X.shape[-1]
    crel = lambda u, v: _rel(torch.view_as_real(u), torch.view_as_real(v))  # noqa: E731
    res["transforms"] = dict(
        shape=list(x.shape),
        sht_err=crel(a[..., : hi - lo], a_single[..., lo:hi]),
        isht_err=_rel(y, isht(a_single, t)[..., rank * h:(rank + 1) * h, :]),
        rfft2_err=crel(X[..., : max(0, min(wf, X_single.shape[-1] - rank * wf))],
                       X_single[..., rank * wf:(rank + 1) * wf]),
        rfft2_round_trip_err=_rel(back, xl),
        sht_pair_ms=_host_ms(lambda: sht_dist.dist_isht(sht_dist.dist_sht(xl, t, group), t,
                                                        group)),
        sht_pair_single_ms=_host_ms(lambda: isht(sht(x, t), t)),
        rfft2_pair_ms=_host_ms(lambda: fft.dist_irfft2(fft.dist_rfft2(xl, group), d.width,
                                                       group)),
        rfft2_pair_single_ms=_host_ms(lambda: torch.fft.irfft2(torch.fft.rfft2(x), s=x.shape[-2:])))
    # one all-to-all: the SHT's forward exchange as real pairs
    pay = torch.view_as_real(torch.zeros(world, 4, 256, h, m_loc, dtype=torch.complex64,
                                         device="cuda"))
    res["a2a"] = dict(bytes=pay.numel() * pay.element_size(),
                      ms=_host_ms(lambda: launch.all_to_all_single(pay, group)))
    del x, xl, a, y, a_single, X, back, X_single, pay
    torch.cuda.empty_cache()
    return res


def check_nccl_one_rank(card: str) -> dict:
    """A one-rank NCCL group on cuda:0: the collectives the port uses
    (all-reduce, all_to_all_single, and point-to-point to itself through
    `batch_isend_irecv`) on CUDA tensors.  Two ranks of NCCL need two
    cards, which this machine lacks."""
    import torch
    import torch.distributed as dist

    from dlwpbench_tpu_torch.parallel import launch

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda:0"))
    try:
        x = torch.arange(4096, dtype=torch.float32, device="cuda")
        y = x.clone()
        launch.all_reduce_([y])
        z = launch.all_to_all_single(x.view(1, -1))
        p2p = torch.empty_like(x)
        launch.Exchange([(x, 0)], [(p2p, 0)]).wait()
        torch.cuda.synchronize()
        ran = {"all_reduce": torch.equal(x, y), "all_to_all_single": torch.equal(x, z[0]),
               "p2p_self": torch.equal(x, p2p), "backend": dist.get_backend()}
    finally:
        dist.destroy_process_group()
    print(f"NCCL, one rank on cuda:0: {ran} [{card}]")
    if not all(v for k, v in ran.items() if k != "backend"):
        raise SystemExit(f"NCCL one-rank collectives disagree: {ran}")
    return ran


def run_distributed_paths(card: str, train_ref: dict) -> dict:
    """The phase "distributed": the data-parallel Swin training on 2 ranks
    against the single-rank train path `train_ref` (its per-step losses
    and final parameters; the two ranks' parameters equal bit for bit;
    the flash launches per rank those of the single-rank path), the ring
    attention and sharded paths on 2 ranks against the single-device
    results, the spectral models with `spmd_mesh` and the distributed
    transforms (`spectral_suite`, no attention launch wanted), and the
    one-rank NCCL collectives.  Returns the launch counts of each path,
    by kernel."""
    import numpy as np
    import torch

    clock = Clock("distributed", card)
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as work:
        ranks = spawn_ranks(work)
        # rank 0 alone writes; its writer has finished once its process has
        checkpoint = os.path.exists(os.path.join(work, "dp_run", "checkpoints", "swin_last.ckpt"))
    clock("2 ranks, data-parallel training, ring attention, the sharded paths and the "
          f"spectral models (in the ranks: {ranks[0]['seconds']['dp']:.1f} s, "
          f"{ranks[0]['seconds']['exchanges']:.1f} s and {ranks[0]['seconds']['spectral']:.1f} s)")
    ref_losses = np.asarray(train_ref["step_losses"])
    for r, res in enumerate(rank["dp"] for rank in ranks):
        losses = np.asarray(res["step_losses"])
        loss_err = float(np.abs(losses - ref_losses).max() / np.abs(ref_losses).max())
        param_err = max((res["params"][n] - p).abs().max().item()
                        for n, p in train_ref["params"].items())
        same = all(torch.equal(res["params"][n], ranks[0]["dp"]["params"][n])
                   for n in res["params"])
        full = [s for n, s in res["step_seconds"] if n == 32][1:]
        per_step = sum(full) / len(full)
        print(f"data-parallel rank {r}: {len(losses)} steps, per-step losses within "
              f"{loss_err:.3e} of the single-rank path's (rtol {DP_LOSS_RTOL:.0e}), final "
              f"parameters within {param_err:.3e} (atol {DP_PARAM_ATOL:.0e}), equal to rank 0's "
              f"{'bit for bit' if same else 'NOT bit for bit'}; launches {res['launches']} "
              f"(the single-rank path's {train_ref['launches']}), mma {res['fused']}; "
              f"{per_step:.4f} s per step against the single rank's "
              f"{train_ref['seconds_per_step']:.4f} at the global batch 32; {res['wall_s']:.1f} s "
              f"wall; the run's checkpoint {'written' if checkpoint else 'MISSING'} [{card}]")
        bad = (len(losses) != len(ref_losses) or loss_err > DP_LOSS_RTOL
               or param_err > DP_PARAM_ATOL or not same or not checkpoint
               or res["launches"] != train_ref["launches"]
               or any(res["fused"][n] != res["launches"][n] for n in res["fused"]))
        if bad:
            raise SystemExit(f"data-parallel rank {r} disagrees with the single-rank path")
        paths[f"dp_train_rank{r}"] = res["launches"]

    for r, res in enumerate(rank["exchanges"] for rank in ranks):
        for c in res["ring"]:
            ok = (c["errors"]["out"] <= RING_TOL["out"]
                  and all(e <= RING_TOL["grad"] for n, e in c["errors"].items() if n != "out")
                  and c["launches"]["flash_window_attention"] == DIST_RANKS
                  and c["launches"]["flash_window_attention_bwd"] == DIST_RANKS
                  and all(c["fused"][n] == c["launches"][n] for n in c["fused"]))
            print(f"ring attention rank {r}, {c['case']} q[{c['B']},{c['H']},{c['N']},{c['D']}] "
                  f"bias{c['bias']}: against one kernel call "
                  + " ".join(f"{n} {e:.3e}" for n, e in c["errors"].items())
                  + f" (tol {RING_TOL['out']:.0e} out, {RING_TOL['grad']:.0e} gradients, x max); "
                  f"forward {c['fwd_s'] * 1e3:.1f} ms, backward {c['bwd_s'] * 1e3:.1f} ms "
                  f"(first calls, host clock); one round's kv exchange ({c['chunk_mb']:.1f} MB) "
                  f"{c['exchange_ms']:.2f} ms; launches {c['launches']} "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise SystemExit(f"ring attention rank {r} {c['case']} disagrees")
            paths[f"ring {c['case'].split(' G=')[0]} rank{r}".replace(" ", "_")] = c["launches"]
        s = res["swin"]
        ok = (s["err"] <= SHARDED_TOL
              and s["launches"]["flash_window_attention"] == s["blocks"] * DIST_RANKS
              and all(s["fused"][n] == s["launches"][n] for n in s["fused"]))
        print(f"Swin forward with spmd_mesh, rank {r}: within {s['err']:.3e} of the single-device "
              f"forward (tol {SHARDED_TOL:.0e} x max), {s['seconds']:.3f} s, launches "
              f"{s['launches']} ({s['blocks']} blocks x {DIST_RANKS} rounds) "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise SystemExit(f"Swin with spmd_mesh rank {r} disagrees")
        paths[f"ring_swin_model_rank{r}"] = s["launches"]
        for key, what in (("halo", "halo (sharded_cylinder_pad)"),
                          ("hpx_pad", "sharded HEALPix pad, nside 32")):
            h = res[key]
            ok = h["err"] <= SHARDED_TOL and h["grad_err"] <= SHARDED_TOL
            print(f"{what} rank {r} on {h['shape']}: within {h['err']:.3e}, gradient "
                  f"{h['grad_err']:.3e} (tol {SHARDED_TOL:.0e} x max); {h['ms']:.2f} ms a call "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise SystemExit(f"{what} rank {r} disagrees")
        g = res["graphcast"]
        print(f"partitioned GraphCast (graphcast.yaml, batch 1) rank {r}: within {g['err']:.3e} "
              f"of the single-device forward (tol {SHARDED_TOL:.0e} x max); {g['seconds']:.3f} s "
              f"against {g['single_seconds']:.3f} s single [{card}]")
        if g["err"] > SHARDED_TOL:
            raise SystemExit(f"partitioned GraphCast rank {r} disagrees")
    for r, res in enumerate(rank["spectral"] for rank in ranks):
        for c in res["models"]:
            ok = (c["err"] <= SHARDED_TOL and c["grad_err"] <= SHARDED_TOL
                  and not any(c["launches"].values())
                  and c.get("bf16_err", 0.0) <= SPECTRAL_BF16_TOL)
            bf16 = (f"; bf16 compute (bf16 exchanges) within {c['bf16_err']:.3e} of the fp32 "
                    f"output (tol {SPECTRAL_BF16_TOL:.0e})" if "bf16_err" in c else "")
            print(f"{c['case']} with spmd_mesh rank {r} ({c['params']:,} parameters, batch "
                  f"{SPECTRAL_BATCH} x 1 step): forward within {c['err']:.3e} of the single "
                  f"rank's, the {c['n_grads']} parameter gradients summed over the ranks within "
                  f"{c['grad_err']:.3e} (worst {c['grad_name']}; tol {SHARDED_TOL:.0e} x max)"
                  f"{bf16}; forward + backward {c['ms']:.2f} ms against the single rank's "
                  f"{c['single_ms']:.2f} ms; attention launches {c['launches']} (none wanted) "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise SystemExit(f"{c['case']} with spmd_mesh rank {r} disagrees")
            paths[f"spectral_{c['case'].replace(' ', '_')}_rank{r}"] = c["launches"]
        t, a2a = res["transforms"], res["a2a"]
        ok = all(t[k] <= SHARDED_TOL for k in ("sht_err", "isht_err", "rfft2_err",
                                                "rfft2_round_trip_err"))
        print(f"distributed transforms rank {r} on {t['shape']}: SHT within {t['sht_err']:.3e}, "
              f"inverse {t['isht_err']:.3e}, rFFT2 {t['rfft2_err']:.3e}, its round trip "
              f"{t['rfft2_round_trip_err']:.3e} (tol {SHARDED_TOL:.0e} x max); one SHT pair "
              f"{t['sht_pair_ms']:.3f} ms (one rank alone on the whole field "
              f"{t['sht_pair_single_ms']:.3f} ms), one rFFT2 pair {t['rfft2_pair_ms']:.3f} ms "
              f"(alone {t['rfft2_pair_single_ms']:.3f} ms); one all-to-all of "
              f"{a2a['bytes'] / 1e6:.2f} MB {a2a['ms']:.3f} ms "
              f"({a2a['bytes'] / a2a['ms'] / 1e6:.3f} GB/s) {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise SystemExit(f"distributed transforms rank {r} disagree")
    check_nccl_one_rank(card)
    clock("NCCL one rank")
    return paths


# ---------------------------------------------------------------- the 2x2 meshes
# Four ranks share the one card through gloo, as the distributed phase's
# two do, in the analysis process after its entries (`run_mesh_paths`):
# the schedules that need a (2, 2) mesh.
MESH_RANKS = 4
# the 2D (sequence x head) ring on a (2, 2) ("x", "h") mesh: each head
# group's ring over 2 ranks, so each round is half the heads against a
# half-sequence kv chunk (`RING_2D_ROUNDS`); against one kernel call within
# RING_TOL, 2 forward and 2 backward launches a rank, all mma
RING_2D_CASES = RING_CASES[1:]  # the unshifted Swin stage 0, Pangu's flash route
# the fused SFNO block stack on a (2, 2) ("x", "c") mesh at sfno.yaml's
# width (embed 256, 4 layers, its equiangular 32 x 64 grid), channels and
# the MLP's hidden dim split over "c", K = 4 channel chunks; output and
# every gradient (the input's, and each weight's summed over the 4 ranks)
# against the single-device stack on the same draws: fp32 exchanges within
# SHARDED_TOL, bf16 exchanges within SPECTRAL_BF16_TOL, of each tensor's max
SFNO_2D_BATCH = 4
SFNO_2D_CHUNKS = 4
# `training.model_parallel=2` under multihost on the 4 ranks: a (2, 2)
# ("data", "x") mesh, each x pair one host reading 16 rows a step, so the
# global batch and the step count are the 2-rank data-parallel check's (32
# and 12); against the single-rank trainer on the same global batches (the
# two hosts' rows, host after host: a single-rank run reads another
# permutation) with DP_LOSS_RTOL and DP_PARAM_ATOL, each x pair's
# parameters equal bit for bit
MP_ARGV = [*TRAIN_ARGV, "training.multihost=true", "training.model_parallel=2",
           "training.batch_size=16"]
MP_HOSTS = 2


def mesh_rank(work: str) -> int:
    """One rank of the 2x2 meshes: joins the gloo group from the
    torch-style variables, runs `mesh_suite` on cuda:0, writes its results
    (its peak device memory among them) to `work/rank<r>.pkl`."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # 4 ranks beside the script's three processes
    from dlwpbench_tpu_torch.parallel import launch

    if not launch.initialize(backend="gloo"):
        raise SystemExit("no distributed job in the environment")
    rank, world = launch.host_info()
    res = mesh_suite(rank, world, work)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _sfno_blocks_single(x, layers, tables):
    """The fused SFNO block stack on the whole [B, nlat, nlon, C] field, one
    device: spherical conv + skip Dense -> gelu -> MLP residual (the
    schedules' math, `parallel/spectral_dist.py::dist_sfno_blocks`)."""
    import torch
    import torch.nn.functional as F

    from dlwpbench_tpu_torch.ops.sht import isht, sht

    for L in layers:
        w = torch.complex(L["spec"][..., 0], L["spec"][..., 1])
        y = isht(torch.einsum("bilm,iol->bolm", sht(x.movedim(-1, -3), tables), w), tables)
        z = F.gelu(y.movedim(-3, -1) + x @ L["skip_k"] + L["skip_b"], approximate="tanh")
        h = F.gelu(z @ L["mlp1_k"] + L["mlp1_b"], approximate="tanh")
        x = z + h @ L["mlp2_k"] + L["mlp2_b"]
    return x


def mesh_suite(rank: int, world: int, work: str) -> dict:
    """The 2D ring (`RING_2D_CASES`), the 2D fused SFNO (fp32 and bf16
    exchanges) and the Swin's train path under `MP_ARGV`, on this rank."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.ops import flash_attention as fa
    from dlwpbench_tpu_torch.ops.sht import sht_tables
    from dlwpbench_tpu_torch.parallel import launch, ring_attention
    from dlwpbench_tpu_torch.parallel import spectral_dist as sd
    from dlwpbench_tpu_torch.training.config import load_config

    counters = counters_of()
    res = {"ring": [], "seconds": {}}
    t_start = time.perf_counter()
    mesh_xh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "h"))
    for label, B, H, N, D, G, kind in RING_2D_CASES:
        gen = torch.Generator(device="cuda").manual_seed(7)  # the same inputs on every rank
        q, k, v, bias = _flash_inputs(B, H, N, D, G, kind, torch.float32, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        reset_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_attention.ring_attention_sharded(*leaves, mesh_xh, axis="x", head_axis="h")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.backward(do)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, fused = _launches(counters), new_design_launches(counters)
        ref = [t.clone().requires_grad_() for t in (q, k, v, bias)]  # one call, not counted
        ref_out = fa.flash_window_attention(*ref)
        ref_out.backward(do)
        errs = {"out": _rel(out, ref_out)}
        errs.update({f"d{n}": _rel(a.grad, b.grad) for n, a, b in zip("qkvb", leaves, ref)})
        res["ring"].append(dict(case=label, B=B, H=H, N=N, D=D, bias=list(bias.shape),
                                fwd_s=t1 - t0, bwd_s=t2 - t1, launches=launches, fused=fused,
                                errors=errs))
        del q, k, v, bias, do, leaves, out, ref, ref_out
        torch.cuda.empty_cache()
    res["seconds"]["ring"] = time.perf_counter() - t_start

    # the fused SFNO stack on the (latitude x channel) mesh
    t0 = time.perf_counter()
    cfg = load_config(cli.CONFIG_DIR, overrides=["model=sfno", "data=synthetic"])
    C, n_layers = int(cfg.model.embed_dim), int(cfg.model.num_layers)
    tables = sht_tables(int(cfg.data.height), int(cfg.data.width), grid=str(cfg.model.grid))
    gen = torch.Generator(device="cuda").manual_seed(17)

    def draw(shape, scale):
        return torch.randn(shape, device="cuda", generator=gen) * scale

    layers = [dict(spec=draw((C, C, tables.lmax, 2), 1.0 / C), skip_k=draw((C, C), C ** -0.5),
                   skip_b=draw((C,), 0.1), mlp1_k=draw((C, 2 * C), C ** -0.5),
                   mlp1_b=draw((2 * C,), 0.1), mlp2_k=draw((2 * C, C), (2 * C) ** -0.5),
                   mlp2_b=draw((C,), 0.1)) for _ in range(n_layers)]
    x = draw((SFNO_2D_BATCH, int(cfg.data.height), int(cfg.data.width), C), 1.0)

    def fwd_bwd(fn):
        xl = x.clone().requires_grad_()
        ll = [{n: t.clone().requires_grad_() for n, t in L.items()} for L in layers]
        y = fn(xl, ll)
        (y ** 2).mean().backward()
        grads = {f"layer{i}/{n}": t.grad for i, L in enumerate(ll) for n, t in L.items()}
        return y.detach(), xl.grad, grads

    want, want_dx, want_grads = fwd_bwd(lambda a, ll: _sfno_blocks_single(a, ll, tables))
    single_ms = _host_ms(lambda: fwd_bwd(lambda a, ll: _sfno_blocks_single(a, ll, tables)),
                         iters=2)
    mesh_xc = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "c"))
    res["sfno"] = []
    for comm, comm_dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        fn = sd.make_dist_sfno_blocks_2d(mesh_xc, tables, pipeline_chunks=SFNO_2D_CHUNKS,
                                         comm_dtype=comm_dtype)
        reset_counters(counters)
        got, dx, grads = fwd_bwd(fn)
        launch.all_reduce_(list(grads.values()))  # each rank's share, over the whole mesh
        grad_err, grad_name = _worst_grad_err({"x": dx, **grads}, {"x": want_dx, **want_grads})
        res["sfno"].append(dict(comm=comm, err=_rel(got, want), grad_err=grad_err,
                                grad_name=grad_name, n_grads=1 + len(grads),
                                launches=_launches(counters),
                                ms=_host_ms(lambda fn=fn: fwd_bwd(fn), iters=2),
                                single_ms=single_ms))
    res["sfno_shape"] = [SFNO_2D_BATCH, int(cfg.data.height), int(cfg.data.width), C, n_layers]
    del x, layers, want, want_dx, want_grads
    torch.cuda.empty_cache()
    res["seconds"]["sfno"] = time.perf_counter() - t0

    # the Swin's train path with training.model_parallel=2 under multihost
    t0 = time.perf_counter()
    reset_counters(counters)
    run = cli.main([*MP_ARGV, f"run_dir={os.path.join(work, 'mp_run')}", "--device", "cuda:0"])
    res["mp"] = dict(launches=_launches(counters), fused=new_design_launches(counters),
                     step_losses=run["step_losses"], step_seconds=run["step_seconds"],
                     train_loss=run["train_loss"], val_loss=run["val_loss"],
                     params={n: p.detach().cpu() for n, p in run["state"].model.named_parameters()})
    res["seconds"]["mp"] = time.perf_counter() - t0
    return res


def replay_global_batches(argv: list, n_hosts: int) -> dict:
    """The single-rank trainer (`train.build_trainer`, the one the train
    CLI builds for `argv`, TF32 off) stepped on the global batches of a
    multihost run of `argv` with `n_hosts` hosts: each step the hosts'
    batches of epoch 0, host after host.  Returns the per-step losses and
    the final parameters."""
    import numpy as np
    import torch

    from dlwpbench_tpu_torch import train as cli
    from dlwpbench_tpu_torch.training.config import load_config
    from dlwpbench_tpu_torch.training.trainer import cosine_lr

    cfg = load_config(cli.CONFIG_DIR, overrides=argv)
    trainer = cli.build_trainer(cfg, torch.device("cuda"))
    state = trainer.init()
    state.model.train()
    train_ds = train_splits(argv)[0]  # no noise: the hosts' shards read no generator
    lr = cosine_lr(0, trainer.base_lr, trainer.epochs)
    shards = [train_ds.batches(int(cfg.training.batch_size), shuffle=True, host_id=i,
                               n_hosts=n_hosts, epoch=0) for i in range(n_hosts)]
    losses = []
    for parts in zip(*shards):
        batch = tuple(None if p[0] is None else np.concatenate(p) for p in zip(*parts))
        losses.append(trainer.train_step(state, trainer._to_device(batch), lr).item())
    return dict(step_losses=losses,
                params={n: p.detach().cpu() for n, p in state.model.named_parameters()})


def run_mesh_paths(card: str) -> dict:
    """The 2x2 meshes, in the analysis process: `MESH_RANKS` ranks of
    `mesh_rank`, then the single-rank replay of the model-parallel run's
    global batches; returns what `check_mesh_paths` holds (numbers only:
    the parameters are compared here)."""
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as work:
        ranks = spawn_ranks(work, MESH_RANKS, "mesh_rank")
    t_ranks = time.perf_counter() - t0
    ref = replay_global_batches(MP_ARGV, MP_HOSTS)
    ref_losses = torch.tensor(ref["step_losses"], dtype=torch.float64)
    mp = []
    for r, res in enumerate(rank["mp"] for rank in ranks):
        losses = torch.tensor(res["step_losses"], dtype=torch.float64)
        partner = ranks[r ^ 1]["mp"]["params"]  # the x pairs: ranks (0, 1) and (2, 3)
        mp.append(dict(
            steps=len(losses), ref_steps=len(ref_losses),
            loss_err=((losses - ref_losses).abs().max() / ref_losses.abs().max()).item()
            if len(losses) == len(ref_losses) else float("inf"),
            param_err=max((res["params"][n] - p).abs().max().item()
                          for n, p in ref["params"].items()),
            pair_equal=all(torch.equal(p, partner[n]) for n, p in res["params"].items()),
            launches=res["launches"], fused=res["fused"], train_loss=res["train_loss"],
            val_loss=res["val_loss"],
            per_step_s=[s for n, s in res["step_seconds"] if n == 16][1:]))
    for rank in ranks:
        del rank["mp"]
    return dict(ranks=ranks, mp=mp, ranks_s=t_ranks, replay_s=time.perf_counter() - t0 - t_ranks)


def check_mesh_paths(card: str, res: dict) -> dict:
    """The 2x2 meshes' checks (see `RING_2D_CASES`, `SFNO_2D_BATCH`,
    `MP_ARGV`); prints each rank's peak device memory.  Returns each
    path's launches by kernel."""
    paths, failures = {}, []
    print(f"2x2 meshes: {MESH_RANKS} gloo ranks on cuda:0, {res['ranks_s']:.1f} s for the ranks "
          f"(in each: " + ", ".join(f"{k} {v:.1f} s" for k, v in res["ranks"][0]["seconds"].items())
          + f"), the single-rank replay {res['replay_s']:.1f} s [{card}]")
    for r, rank in enumerate(res["ranks"]):
        for c in rank["ring"]:
            ok = (c["errors"]["out"] <= RING_TOL["out"]
                  and all(e <= RING_TOL["grad"] for n, e in c["errors"].items() if n != "out")
                  and c["launches"]["flash_window_attention"] == 2
                  and c["launches"]["flash_window_attention_bwd"] == 2
                  and _attention_launches(c["launches"]) == 4
                  and all(c["fused"][n] == c["launches"][n] for n in c["fused"]))
            print(f"2D ring attention (x 2 x h 2) rank {r}, {c['case']} q[{c['B']},{c['H']},"
                  f"{c['N']},{c['D']}] bias{c['bias']}, rounds q[{c['B']},{c['H'] // 2},"
                  f"{c['N'] // 2},{c['D']}]: against one kernel call "
                  + " ".join(f"{n} {e:.3e}" for n, e in c["errors"].items())
                  + f" (tol {RING_TOL['out']:.0e} out, {RING_TOL['grad']:.0e} gradients, x max); "
                  f"forward {c['fwd_s'] * 1e3:.1f} ms, backward {c['bwd_s'] * 1e3:.1f} ms (first "
                  f"calls, host clock); launches {c['launches']}, mma {c['fused']} "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                failures.append(f"2D ring rank {r} {c['case']}")
            paths[f"ring_2d {c['case'].split(' G=')[0]} rank{r}".replace(" ", "_")] = c["launches"]
        B, H, W, C, L = rank["sfno_shape"]
        for c in rank["sfno"]:
            tol = SHARDED_TOL if c["comm"] == "fp32" else SPECTRAL_BF16_TOL
            ok = (c["err"] <= tol and c["grad_err"] <= tol
                  and not _attention_launches(c["launches"]))
            print(f"2D fused SFNO (x 2 x c 2) rank {r}, {c['comm']} exchanges, [{B},{H},{W},{C}] x "
                  f"{L} blocks, K {SFNO_2D_CHUNKS}: output within {c['err']:.3e} of the single "
                  f"device's, the {c['n_grads']} gradients (input, and each weight summed over "
                  f"the ranks) within {c['grad_err']:.3e} (worst {c['grad_name']}; tol {tol:.0e}"
                  f" x max); forward + backward {c['ms']:.2f} ms against the single device's "
                  f"{c['single_ms']:.2f} ms; attention launches "
                  f"{_attention_launches(c['launches'])} (none wanted) {'ok' if ok else 'FAIL'} "
                  f"[{card}]")
            if not ok:
                failures.append(f"2D fused SFNO rank {r} {c['comm']}")
    for r, m in enumerate(res["mp"]):
        fl = {n: m["launches"][n] for n in ("flash_window_attention", "flash_window_attention_bwd")}
        ok = (m["steps"] == m["ref_steps"] > 0 and m["loss_err"] <= DP_LOSS_RTOL
              and m["param_err"] <= DP_PARAM_ATOL and m["pair_equal"] and all(fl.values())
              and all(m["fused"][n] == m["launches"][n] for n in m["fused"])
              and m["launches"] == res["mp"][0]["launches"])
        step = sum(m["per_step_s"]) / max(1, len(m["per_step_s"]))
        print(f"model_parallel=2 (multihost, mesh data 2 x x 2) rank {r}: {m['steps']} steps, "
              f"per-step losses within {m['loss_err']:.3e} of the single-rank trainer on the "
              f"same global batches (rtol {DP_LOSS_RTOL:.0e}), final parameters within "
              f"{m['param_err']:.3e} (atol {DP_PARAM_ATOL:.0e}), equal to its x partner's "
              f"{'bit for bit' if m['pair_equal'] else 'NOT bit for bit'}; train "
              f"{m['train_loss']}, val {m['val_loss']}; launches {fl}, mma "
              f"{ {n: m['fused'][n] for n in fl} }; {step:.4f} s per step at 16 rows a rank "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(f"model_parallel rank {r}")
        paths[f"mp_train_rank{r}"] = m["launches"]
    print("2x2 meshes, max_memory_allocated by rank: "
          + ", ".join(f"{r['max_memory_allocated'] / 2**20:.1f} MiB" for r in res["ranks"])
          + f" [{card}]")
    if failures:
        raise SystemExit(f"the 2x2 meshes failed: {failures}")
    return paths


def run_profile_paths(card: str) -> dict:
    """The profile entry (`python -m dlwpbench_tpu_torch.profile_model`,
    called in this process): the U-Net's rollout and the Swin's train step
    at the zoo's widths, each `profile.json` with its steps, median
    seconds, a FLOP count over one step and the achieved rate; the Swin's
    count holds every block's attention (4 B heads N^2 D per block
    forward, each window; `profile_model.ATTENTION_OPS`' FLOP formulas).
    Returns each run's launches by kernel."""
    from dlwpbench_tpu_torch import profile_model

    clock = Clock("profile", card)
    counters = counters_of()
    paths = {}
    B, T = 4, 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as work:
        for label, argv in (("unet", ["--model", "unet", "--steps", "3"]),
                            ("swin_train", ["--model", "swin", "--train", "--batch", str(B),
                                            "--seq", str(T), "--steps", "3"])):
            out_dir = os.path.join(work, label)
            reset_counters(counters)
            info = profile_model.main([*argv, "--out-dir", out_dir])
            paths[f"profile_{label}"] = _launches(counters)
            with open(os.path.join(out_dir, "profile.json")) as f:
                saved = json.load(f)
            trace = any(n.endswith(".pt.trace.json") for n in os.listdir(out_dir))
            ok = (saved == json.loads(json.dumps(info)) and trace and saved["steps"] == 3
                  and saved["median_s"] > 0 and saved["flops_per_step"] > 0
                  and saved["achieved_tflops"] > 0 and "cost_error" not in saved)
            bound = 0
            if label == "swin_train":
                model = profile_model.model_zoo(B, 32, 64)["swin"]()
                bound = B * (T - model.context_size) * sum(
                    4 * (st["Hp"] // st["wh"]) * (st["Wp"] // st["ww"])
                    * (st["wh"] * st["ww"]) ** 2 * model.embed_dim * 2 ** i * depth
                    for i, (st, depth) in enumerate(zip(model.plan, model.depths)))
                ok = ok and saved["attention_flops_per_step"] >= bound and all(
                    paths[f"profile_{label}"][n] > 0
                    for n in ("flash_window_attention", "flash_window_attention_bwd"))
            print(f"profile entry {label}: {saved['steps']} steps, median "
                  f"{saved['median_s']:.4f} s, {saved['flops_per_step']:.4e} FLOP a step "
                  f"(attention {saved['attention_flops_per_step']:.4e}, the blocks' forwards "
                  f"alone {bound:.4e}), {saved['achieved_tflops']:.3f} TFLOP/s, peak "
                  f"{saved['max_memory_allocated_mb']:.1f} MB; trace "
                  f"{'written' if trace else 'MISSING'}; launches {paths[f'profile_{label}']} "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise SystemExit(f"profile entry {label} failed its checks")
            clock(label)
    return paths


# ---------------------------------------------------------------- the analysis phase
# The multi-device analysis entries on the card, each through its own `-m`
# ranks (`launch.spawn_local`): 2 ranks share cuda:0 over gloo (NCCL
# refuses two ranks on one card), the microbench once more on one NCCL
# rank.  They run in a process of their own (`analysis_process`), started
# once the kernels are built, beside this process's attention paths and
# the second process's phases: each entry's ranks spend most of their
# seconds reaching the card, which the paths beside them barely feel.
# Their readings are taken while those paths run.  The scaling model runs
# here after the join, on the phase's ladder.
ANALYSIS_RANKS = 2
BYTE_RATIO_TOL = 0.01  # the byte audit's all-to-all bytes within 1% of the model's claim
ANALYSIS_TIMEOUT_S = 900


def _entry(module: str, argv: list) -> dict:
    """`dlwpbench_tpu_torch.<module>.main(argv)` in this process (the
    launcher; its ranks are `python -m` processes of their own)."""
    import importlib

    return importlib.import_module(f"dlwpbench_tpu_torch.{module}").main(argv)


def _attention_launches(launches: dict) -> int:
    return sum(v for k, v in launches.items() if "." not in k)


def analysis_process(out_path: str) -> int:
    """The analysis phase's card part, in a process of its own
    (`ScriptProcess`): `collective_microbench` on 2 gloo ranks and on one
    NCCL rank, `schedule_audit` on 2 gloo ranks, `benchmark_scaling` on 1
    and 2 gloo ranks and with `--spatial 2` on 2 and 4, then the 2x2 meshes
    (`run_mesh_paths`); their outputs to `out_path` as JSON (the microbench
    file's content among them, for the scaling model)."""
    import torch

    sys.path.insert(0, REPO)
    card = card_line()
    clock = Clock("analysis", card)
    t0 = time.perf_counter()
    work = os.path.dirname(out_path)
    n = str(ANALYSIS_RANKS)
    mb_file = os.path.join(work, "collective_microbench.json")
    res = {}
    res["mb"] = _entry("collective_microbench", ["--devices", n, "--backend", "gloo",
                                                 "--out", mb_file])
    res["mb1"] = _entry("collective_microbench", ["--devices", "1", "--backend", "nccl", "--out",
                                                  os.path.join(work, "microbench_nccl.json")])
    clock("collective_microbench, 2 gloo ranks and 1 NCCL rank")
    res["sa"] = _entry("schedule_audit", ["--devices", n, "--backend", "gloo", "--out", mb_file])
    clock("schedule_audit, 2 gloo ranks")
    res["scaling"] = _entry("benchmark_scaling", ["--devices", f"1,{n}", "--backend", "gloo",
                                                  "--steps", "2", "--out",
                                                  os.path.join(work, "scaling.json")])
    clock("benchmark_scaling, 1 and 2 gloo ranks")
    res["spatial"] = _entry("benchmark_scaling", ["--devices", f"{n},{MESH_RANKS}", "--spatial",
                                                  n, "--backend", "gloo", "--steps", "2", "--out",
                                                  os.path.join(work, "scaling_spatial.json")])
    clock(f"benchmark_scaling --spatial 2, 2 and {MESH_RANKS} gloo ranks")
    with open(mb_file) as f:
        res["microbench_json"] = json.load(f)  # the scaling model's input, after the join
    res["mesh"] = run_mesh_paths(card)
    clock(f"the 2x2 meshes, {MESH_RANKS} gloo ranks and the single-rank replay")
    res["seconds"] = time.perf_counter() - t0
    print(f"analysis phase: {res['seconds']:.1f} s in its own process [{card}]")
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def check_analysis(card: str, res: dict, ladder_file: str) -> dict:
    """The phase "analysis", its checks in this process: the byte ratio
    within 1% of 1 on both microbench runs, the fit's rows; the ring's
    rounds launch the flash forward, all on the mma design, and nothing
    else launches an attention kernel; both audits' collectives; both
    scaling rows and both `--spatial` rows (meshes 1x2 and 2x2); the 2x2
    meshes (`check_mesh_paths`); then `scaling_model` on the ladder
    phase's ladder and the phase's microbench file, no row with an error,
    the bf16-exchange rows of every SFNO family present.  Returns each
    path's launches by kernel."""
    t0 = time.perf_counter()
    paths, failures = {}, []
    for label, r in (("microbench gloo", res["mb"]), ("microbench nccl", res["mb1"])):
        audit, timing = r["byte_audit"], r["timing"]
        ok = (abs(audit["ratio_vs_model"] - 1.0) <= BYTE_RATIO_TOL
              and len(set(audit["all_to_all_bytes_by_rank"])) == 1
              and [row["payload_mb"] for row in timing["rows"]] == [1, 4, 16, 64]
              and all(row["time_s"] > 0 for row in timing["rows"])
              and not _attention_launches(r["attention_launches"]))
        paths[f"analysis_{label.replace(' ', '_')}"] = r["attention_launches"]
        bw = timing["effective_bw_gbps"]
        print(f"collective_microbench ({label}, {r['devices']} rank(s), backend "
              f"{r['backend']}, ranks_per_card {r['ranks_per_card']}): all-to-all "
              f"{audit['all_to_all_bytes_per_device']:,} B a rank against the model's "
              f"{audit['model_claim_bytes_per_device']:,} (ratio {audit['ratio_vs_model']:.6f}, "
              f"tol {BYTE_RATIO_TOL}), every collective {audit['collective_bytes_per_device']}; "
              "all_to_all " + ", ".join(f"{row['payload_mb']} MB {row['time_s'] * 1e3:.4f} ms"
                                        for row in timing["rows"])
              + f"; fit latency {timing['latency_s'] * 1e3:.4f} ms, bandwidth "
              f"{'n/a' if bw is None else f'{bw:.4f}'} GB/s, R^2 {timing['r2_linear_in_bytes']}"
              f" {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(label)
    sa = res["sa"]
    ring, sfno = sa["ring_attention"], sa["fused_sfno"]
    fl = ring["attention_launches"]
    ring_ok = (fl["flash_window_attention"] > 0
               and fl["flash_window_attention.mma"] == fl["flash_window_attention"]
               and _attention_launches(fl) == fl["flash_window_attention"]
               and ring["n_collectives"] == ANALYSIS_RANKS - 1
               and ring["n_collectives_with_zero_overlap_window"] == 0)
    sfno_ok = sfno["n_collectives"] > 0 and not _attention_launches(sfno["attention_launches"])
    paths["analysis_ring_audit"] = fl
    paths["analysis_sfno_audit"] = sfno["attention_launches"]
    for label, a, ok in (("ring attention", ring, ring_ok), ("fused SFNO", sfno, sfno_ok)):
        windows = "; ".join(
            f"{w['name']} {w['independent_compute_ops']} launch(es) inside, "
            f"{w['overlapped_device_us']} device us overlapped" for w in a.get("windows", []))
        print(f"schedule_audit {label} ({sa['backend']}, ranks_per_card {sa['ranks_per_card']}): "
              f"{a['n_collectives']} collectives, {a['n_compute_ops']} compute launches, zero "
              f"windows {a['n_collectives_with_zero_overlap_window']}, min independent "
              f"{a['min_independent_compute']}, overlapped device "
              f"{a['overlapped_device_us']} us{'; ' + windows if windows else ''}; launches "
              f"{ {k: v for k, v in a['attention_launches'].items() if v} } "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(f"schedule_audit {label}")
    K = sa["fused_step_time_s"]
    print(f"fused SFNO step, {ANALYSIS_RANKS} ranks on one card: K1 {K['K1'] * 1e3:.4f} ms, K8 "
          f"{K['K8'] * 1e3:.4f} ms (K8/K1 {K['K8'] / K['K1']:.3f}; CUDA events) [{card}]")
    for count in ("1", str(ANALYSIS_RANKS)):
        row = res["scaling"].get(count, {"error": "missing"})
        ok = ("error" not in row and row["step_s"] > 0
              and not _attention_launches(row["attention_launches"]))
        if "error" in row:
            print(f"benchmark_scaling {count} rank(s): FAILED {row['error']}")
        else:
            paths[f"analysis_scaling_{count}"] = row["attention_launches"]
            print(f"benchmark_scaling {count} rank(s) ({row['backend']}, ranks_per_card "
                  f"{row['ranks_per_card']}): {row['step_s'] * 1e3:.2f} ms a step, "
                  f"{row['gridpoints_per_s']:,.1f} grid-points/s, efficiency "
                  f"{row['efficiency']:.4f} {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(f"benchmark_scaling {count}")
    base = res["scaling"].get("1", {})
    for count, mesh in ((ANALYSIS_RANKS, f"1x{ANALYSIS_RANKS}"),
                        (MESH_RANKS, f"{MESH_RANKS // ANALYSIS_RANKS}x{ANALYSIS_RANKS}")):
        row = res["spatial"].get(str(count), {"error": "missing"})
        ok = ("error" not in row and row["mesh"] == mesh and row["step_s"] > 0
              and not _attention_launches(row["attention_launches"]))
        if "error" in row:
            print(f"benchmark_scaling --spatial {ANALYSIS_RANKS}, {count} ranks: FAILED "
                  f"{row['error']}")
        else:
            paths[f"analysis_scaling_spatial_{count}"] = row["attention_launches"]
            print(f"benchmark_scaling --spatial {ANALYSIS_RANKS}, {count} ranks (mesh "
                  f"{row['mesh']}, the U-Net on latitude rows, {row['backend']}, ranks_per_card "
                  f"{row['ranks_per_card']}): {row['step_s'] * 1e3:.2f} ms a step at global "
                  f"batch {row['global_batch']}, {row['gridpoints_per_s']:,.1f} grid-points/s "
                  f"(one rank at batch {base.get('global_batch')}: "
                  f"{base.get('step_s', 0) * 1e3:.2f} ms) {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(f"benchmark_scaling --spatial, {count} ranks")
    paths.update(check_mesh_paths(card, res["mesh"]))
    work = os.path.dirname(ladder_file)
    mb_file = os.path.join(work, "collective_microbench.json")
    with open(mb_file, "w") as f:
        json.dump(res["microbench_json"], f)
    model = _entry("scaling_model", ["--ladder", ladder_file, "--microbench", mb_file,
                                     "--training", os.path.join(work, "absent.json"), "--out",
                                     os.path.join(work, "scaling_model.json")])
    rows = {k: v for k, v in model.items() if not k.startswith("_")}
    print(f"scaling_model inputs: {model['_inputs']}; {len(rows)} rows, link "
          f"{sorted({v['link_source'] for v in rows.values()})}")
    if not rows or any("error" in v for v in rows.values()):
        failures.append("scaling_model")
    # the bf16-exchange rows of every SFNO family on both grids: their
    # single-card step (sfno2d@8m) and bf16 / fp32 step ratio (sfno2d@32m)
    # are ladder rows read while the card ran the script's other processes
    want = [f"h100-sxm5:{grid}:{fam}:bf16comm" for grid in ("5.625deg", "1.0deg")
            for fam in ("sfno2d", "sfno2d_fused", "sfno2d_fused_2d")]
    for key in want:
        if key in rows:
            print(f"scaling_model {key} (shared-card figures: the ladder's sfno2d rows were read "
                  f"beside the script's other processes on the card): single-card step "
                  f"{rows[key]['single_chip_step_s']} s, efficiency "
                  f"{rows[key]['efficiency_by_chips']} [{card}]")
    if [k for k in want if k not in rows]:
        failures.append(f"scaling_model bf16-exchange rows missing: "
                        f"{[k for k in want if k not in rows]}")
    print(f"analysis phase: {res['seconds']:.1f} s in its own process beside the paths, "
          f"{time.perf_counter() - t0:.1f} s here (its checks and the scaling model) [{card}]")
    if failures:
        raise SystemExit(f"analysis phase failed: {failures}")
    return paths


SHARED_DRAWS_ENV = "CHIP_SMOKE_SHARED_DRAWS"


def memoise_synthetic_generator():
    """The synthetic generator's arrays kept for this process's run: the
    entry points rebuild their data on each call (splits, statistics,
    normalisation), but the evaluate paths of the U-Net, the Swin, Pangu
    and the ModernUNet draw the same 9,060 frames, and the user paths the
    same frames for train, build_baselines and evaluate; the generator is
    deterministic in its arguments, so each set is drawn once (about 1.7
    ms of host a frame) and handed out read-only.  While the directory
    named by `SHARED_DRAWS_ENV` exists, each draw is also kept there
    (written whole, then renamed into place) and read back by the other
    process of the run instead of drawn again."""
    import functools
    import hashlib

    import numpy as np

    from dlwpbench_tpu_torch.data import sources

    draw = sources.synthetic_weatherbench

    def shared_path(kwargs):
        shared = os.environ.get(SHARED_DRAWS_ENV)
        if not shared or not os.path.isdir(shared):
            return None
        key = hashlib.sha256(repr(sorted(kwargs.items())).encode()).hexdigest()[:16]
        return os.path.join(shared, f"{key}.npz")

    @functools.lru_cache(maxsize=16)
    def memo(**kwargs):
        path = shared_path(kwargs)
        if path and os.path.exists(path):
            with np.load(path) as z:
                arrays = tuple(z[f"a{i}"] if f"a{i}" in z.files else None
                               for i in range(int(z["n"])))
        else:
            arrays = draw(**kwargs)
            if path:
                tmp = f"{path}.{os.getpid()}.tmp.npz"
                np.savez(tmp, n=len(arrays),
                         **{f"a{i}": a for i, a in enumerate(arrays) if a is not None})
                os.replace(tmp, path)
        for a in arrays:
            if a is not None:
                a.flags.writeable = False
        return arrays

    sources.synthetic_weatherbench = memo


def kernel_free_phases(card: str):
    """The phases that launch no attention kernel, each asserting 0
    launches of every kernel: the graph families first (GraphCast's 47.6
    GiB peak while the main process runs only the U-Net beside the build),
    the ModernUNet family and diffusion, Navier-Stokes and the recurrent
    models, the spectral families.  Returns each path's launch counts and
    each training run's results, by path."""
    import torch

    paths, runs = {}, {}
    # GraphCast and MeshGraphNet (its Delaunay edge list and its 8-stencil)
    # through the CLIs, card vs CPU, and the two movement forms of a
    # GraphCast processor layer against each other
    graph_paths, graph_runs, _ = run_graph_paths(card)
    paths.update(graph_paths)
    runs.update(graph_runs)
    torch.cuda.empty_cache()  # GraphCast's blocks back to the card

    # the lat-lon ModernUNet at its shipped width (evaluate, fp32 and bf16
    # training), the HEALPix one's user path, and both diffusion models'
    # user paths (v-prediction, EMA, evaluate -c on the EMA weights)
    phase_s = {}
    t0 = time.perf_counter()
    munet_paths, munet_runs = run_modern_unet_paths(card)
    phase_s["ModernUNet and MUNetHPX"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff_paths, diff_runs = run_diffusion_paths(card)
    phase_s["DiffModernUNet and DiffMUNetHPX"] = time.perf_counter() - t0
    for p, r in ((munet_paths, munet_runs), (diff_paths, diff_runs)):
        paths.update(p)
        runs.update(r)
    print("ModernUNet phases, seconds: " + "; ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f" [{card}]")

    # the solver's dataset on the card, ConvLSTM's and DISTANA's user paths
    # on it, both on HEALPix faces, the wb_learnable generator
    ns_paths, ns_runs = run_ns_paths(card)
    paths.update(ns_paths)
    runs.update(ns_runs)

    # TFNO, FNO, FourCastNet, FourCastNetv2, SFNO and the ModernUNet's
    # Fourier block through the CLIs, card vs CPU, and the two fft_impl
    # branches against each other
    spectral_paths, spectral_runs, _ = run_spectral_paths(card)
    paths.update(spectral_paths)
    runs.update(spectral_runs)
    return paths, runs


def side_threads() -> int:
    """Host threads for the CPU references of each of the two processes
    while both run: half of torch's default each, so they do not
    oversubscribe the cores."""
    import torch

    return max(1, torch.get_num_threads() // 2)


def side_process(out_path: str) -> int:
    """The second process of the run (`ScriptProcess`): `kernel_free_phases`
    on the card, its results written to `out_path` as JSON (each path's
    launch counts, each training run's bf16-instance launches)."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(side_threads())
    memoise_synthetic_generator()
    card = card_line()
    t0 = time.perf_counter()
    paths, runs = kernel_free_phases(card)
    print(f"kernel-free phases: {time.perf_counter() - t0:.1f} s in the second process [{card}]")
    t0 = time.perf_counter()
    ladder = ladder_side_phase(card)
    paths.update(ladder["paths"])
    print(f"ladder phase: {time.perf_counter() - t0:.1f} s in the second process [{card}]")
    with open(out_path, "w") as f:
        json.dump({"paths": paths, "bf16": {k: r["bf16"] for k, r in runs.items()},
                   "ladder": ladder["entries"]}, f)
    return 0


SIDE_TIMEOUT_S = 1100


class ScriptProcess:
    """`entry(out_path)` of this script in a process of its own (its own
    session, so that `stop` ends it with every rank it started), its
    output kept in a file and printed at `join`.  The second process
    (`side_process`) starts before the build: the card waits on the host
    for most of every path (the busy shares printed), so the kernel-free
    phases and the build and attention paths of this process overlap.  The
    analysis process (`analysis_process`) starts once the kernels are
    built, beside the attention paths.  The paths' seconds, busy shares and
    rates are taken while the processes share the card and the host; the
    kernel checks and the distributed phase run after `join`, alone."""

    def __init__(self, entry: str, what: str, timeout_s: float, share_draws: bool = False):
        self.what, self.timeout_s, self.share_draws = what, timeout_s, share_draws
        self.work = tempfile.mkdtemp(prefix=f"chip_smoke_{entry}_")
        self.log_path = os.path.join(self.work, f"{entry}.log")
        self.out_path = os.path.join(self.work, f"{entry}.json")
        env = dict(os.environ)
        if share_draws:
            os.makedirs(os.path.join(self.work, "draws"))
            env[SHARED_DRAWS_ENV] = os.environ[SHARED_DRAWS_ENV] = os.path.join(self.work,
                                                                               "draws")
        code = f"import sys, chip_smoke; sys.exit(chip_smoke.{entry}(sys.argv[1]))"
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen([sys.executable, "-u", "-c", code, self.out_path],
                                         cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                                         start_new_session=True)
        self.t0 = time.perf_counter()

    def _fail(self, why: str):
        self.stop(keep_log=True)
        with open(self.log_path) as f:
            sys.stdout.write(f.read())
        raise SystemExit(f"the process of {self.what} {why}")

    def check(self):
        """Fails the run at once if the process has failed."""
        rc = self.proc.poll()
        if rc not in (None, 0):
            self._fail(f"exited {rc}")

    def join(self, card: str) -> dict:
        t_wait = time.perf_counter()
        try:
            self.proc.wait(timeout=max(1.0, self.timeout_s - (t_wait - self.t0)))
        except subprocess.TimeoutExpired:
            self._fail(f"was still running after {self.timeout_s} s")
        if self.proc.returncode != 0:
            self._fail(f"exited {self.proc.returncode}")
        print(f"---- {self.what}, run in a process of its own beside the phases above: "
              "its output ----")
        with open(self.log_path) as f:
            sys.stdout.write(f.read())
        print(f"---- that process ran {time.perf_counter() - self.t0:.1f} s; this one "
              f"waited {time.perf_counter() - t_wait:.1f} s for it [{card}] ----")
        with open(self.out_path) as f:
            return json.load(f)

    def stop(self, keep_log: bool = False):
        """Ends the process and what it started if it still runs; removes
        its files (and the shared draws)."""
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        else:  # its ranks, should any have outlived it
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if self.share_draws:
            os.environ.pop(SHARED_DRAWS_ENV, None)
        if not keep_log:
            import shutil

            shutil.rmtree(self.work, ignore_errors=True)


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
    memoise_synthetic_generator()

    t_start = time.perf_counter()
    card = card_line()
    clock = Clock("chip_smoke", card)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    import importlib.util  # the evaluator's plots need it (ROADMAP item 6)
    print(f"card machine: matplotlib "
          f"{'installed' if importlib.util.find_spec('matplotlib') else 'not installed'}")
    # the kernel-free phases run in a second process from here on, beside
    # the build and the attention paths; the kernel checks and the
    # distributed phase wait for it and run alone
    n_threads = torch.get_num_threads()
    torch.set_num_threads(side_threads())
    side = ScriptProcess("side_process", "the kernel-free phases", SIDE_TIMEOUT_S,
                         share_draws=True)
    analysis = None
    try:
        paths, fused_by_path, bf16_by_path = {}, {}, {}
        train_runs = {}

        def tick(step: str):
            clock(step)
            side.check()
            if analysis is not None:
                analysis.check()

        # while nvcc builds: the U-Net at bench.py's shape (the evaluate
        # CLI in fp32, the same rollout in fp32 and bf16, card vs CPU on 2
        # samples x 2 steps), its training in fp32 and bf16 compute at the
        # shipped config, and the HEALPix U-Net's user path and rollout; no
        # attention kernel launches on any of them
        build_log = []
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            building = pool.submit(build_all, build_log.append)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_unet_eval_") as out_dir:
                _, paths["unet_evaluate"], ucfg, fused_by_path["unet_evaluate"] = run_eval_path(
                    "unet evaluate", UNET_EVAL_ARGV, out_dir, card)
            drive_unet_rollout(ucfg, card)
            ucfg.data["n_time"] = 1536  # 2 samples need no 256 test inits
            check_rollout_vs_cpu(ucfg)
            tick("U-Net evaluate (beside the build)")
            # the Swin, Pangu, swin_win8 and U-Net training paths and the
            # bf16 ones below share one build of TRAIN_TAIL's splits
            # (context 1)
            syn_splits = train_splits(TRAIN_ARGV)
            for key, argv in (("unet_train", UNET_TRAIN_ARGV),
                              ("unet_train_bf16",
                               [*UNET_TRAIN_ARGV, "training.compute_dtype=bfloat16"])):
                with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
                    run, _, _ = run_train_path(key.replace("_", " "), argv, run_dir, card,
                                               datasets=syn_splits)
                train_runs[key] = run
                paths[key], fused_by_path[key] = run["launches"], run["fused"]
            tick("U-Net training, fp32 and bf16 (beside the build)")
            hpx_unet, paths["hpx_unet_evaluate"] = run_hpx_unet_path(card)
            train_runs["hpx_unet_train"] = hpx_unet
            paths["hpx_unet_train"] = hpx_unet["launches"]
            tick("HEALPix U-Net (beside the build)")
            drive_hpx_unet_rollout(card)
            tick("HEALPix U-Net rollout, nside 32 (beside the build)")
            building.result()
        for line in build_log:
            print(line)
        # the analysis entries, in a process of their own from here on (the
        # schedule audit's ring needs the flash kernel)
        analysis = ScriptProcess("analysis_process", "the analysis phase", ANALYSIS_TIMEOUT_S)
        tick("build (the time past the U-Net paths)")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as out_dir:
            _, paths["evaluate"], cfg, fused_by_path["evaluate"] = run_eval_path(
                "main path", MAIN_ARGV, out_dir, card)
        helper = helper_test_split(cfg)
        check_rollout_vs_cpu(cfg, test_ds=helper)
        profile_rollout(cfg, card, test_ds=helper)
        tick("Swin evaluate")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
            train, tcfg, train_ds = run_train_path("train path", TRAIN_ARGV, run_dir, card,
                                                   datasets=syn_splits, keep_params=True)
        paths["train"], fused_by_path["train"] = train["launches"], train["fused"]
        train_runs["train"] = train
        swin_ref = {}  # the batch and the CPU's fp32 gradients, for the bf16 check
        check_train_grads(tcfg, train_ds, card, reference=swin_ref)
        profile_train_step(tcfg, train_ds, card)
        tick("Swin train")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_pangu_eval_") as out_dir:
            _, paths["pangu_evaluate"], pcfg, fused_by_path["pangu_evaluate"] = run_eval_path(
                "pangu evaluate", PANGU_EVAL_ARGV, out_dir, card)
        profile_rollout(pcfg, card, test_ds=helper)  # the Swin's: the same data config
        tick("Pangu evaluate")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_pangu_train_") as run_dir:
            ptrain, ptcfg, ptrain_ds = run_train_path("pangu train", PANGU_TRAIN_ARGV, run_dir,
                                                      card, datasets=syn_splits)
            pserve = serve_pangu(run_dir, ptcfg, ptrain_ds, card)
        paths["pangu_train"], fused_by_path["pangu_train"] = ptrain["launches"], ptrain["fused"]
        paths["pangu_serve"], fused_by_path["pangu_serve"] = pserve["launches"], pserve["fused"]
        train_runs["pangu_train"] = ptrain
        # at 2 samples stage 2 would take einsum under auto (2 * 3 * 3 < 64);
        # the three routes share one CPU reference (and its batch), and so
        # does the bf16 check's fp32 scale below
        pangu_ref = {}
        check_train_grads(ptcfg, ptrain_ds, card, card_route="packed5d", reference=pangu_ref)
        # Pangu's flash route (`use_flash_attention: true`): every block's
        # windows through the flash forward and backward (N 144, D 32)
        check_train_grads(ptcfg, ptrain_ds, card, card_route=True, reference=pangu_ref)
        # Pangu's token-major route (`use_flash_attention: "packed"`): every
        # block's windows through the token-major forward and backward
        check_train_grads(ptcfg, ptrain_ds, card, card_route="packed", reference=pangu_ref)
        profile_train_step(ptcfg, ptrain_ds, card)
        tick("Pangu train")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_swin8_train_") as run_dir:
            s8, s8cfg, s8_ds = run_train_path("swin_win8 train", SWIN8_TRAIN_ARGV, run_dir, card,
                                              datasets=syn_splits)
        paths["swin_win8_train"], fused_by_path["swin_win8_train"] = s8["launches"], s8["fused"]
        train_runs["swin_win8_train"] = s8
        # at 2 samples stage 1 would take einsum under auto (2 * 8 < 64)
        check_train_grads(s8cfg, s8_ds, card, card_route="packed")
        profile_train_step(s8cfg, s8_ds, card)
        # the prefetch's turns on half the training frames (768: 5 full
        # batches and one of 18 an epoch; 1,536 until the graph phase
        # needed the time)
        prefetch = compare_prefetch(
            s8cfg, train_splits([*SWIN8_TRAIN_ARGV, "data.n_time=768"])[0], card)
        paths["swin_win8_prefetch"] = prefetch["launches"]
        tick("swin_win8 train and the prefetch")
        paths["packed"], fused_by_path["packed"] = run_packed_path(card)
        tick("packed path")

        # one epoch each of the Swin and Pangu in bf16 compute beside their
        # fp32 paths above
        for key, argv in (
            ("swin_train_bf16", ["model=swintransformer", *TRAIN_TAIL, "training.epochs=1",
                                 "training.compute_dtype=bfloat16"]),
            ("pangu_train_bf16", ["model=panguweather", *TRAIN_TAIL, "training.epochs=1",
                                  "training.compute_dtype=bfloat16"]),
        ):
            with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{key}_") as run_dir:
                run, rcfg, rds = run_train_path(key.replace("_", " "), argv, run_dir, card,
                                                datasets=syn_splits)
            train_runs[key] = run
            paths[key], fused_by_path[key] = run["launches"], run["fused"]
            if key == "swin_train_bf16":
                check_train_grads_bf16(rcfg, rds, card, reference=swin_ref)
            else:
                check_train_grads_bf16(rcfg, rds, card, card_route="packed5d",
                                       reference=pangu_ref)
                profile_train_step(rcfg, rds, card, compute_dtype="bfloat16")
        for model, fp32_key in (("unet", "unet_train"), ("swin", "train"),
                                ("pangu", "pangu_train")):
            a, b = train_runs[fp32_key], train_runs[f"{model}_train_bf16"]
            print(f"training, fp32 against bf16 compute: {model} {a['seconds_per_step']:.4f} "
                  f"against {b['seconds_per_step']:.4f} s per step "
                  f"({a['seconds_per_step'] / b['seconds_per_step']:.2f}x), "
                  f"{a['samples_per_s']:.2f} against {b['samples_per_s']:.2f} samples/s, peak "
                  f"{a['peak_gib']:.2f} against {b['peak_gib']:.2f} GiB [{card}]")
        tick("Swin and Pangu bf16 training")

        # the real-data path: the WeatherBench zarr tree, the native batcher
        # and decoder, the Swin trained and evaluated with ACC against the
        # baselines
        zarr = run_zarr_path(card, (train, tcfg, train_ds))
        train_runs["zarr_train"] = zarr["train"]
        paths["zarr_train"], fused_by_path["zarr_train"] = (zarr["train"]["launches"],
                                                            zarr["train"]["fused"])
        paths["zarr_evaluate"], fused_by_path["zarr_evaluate"] = (zarr["eval_launches"],
                                                                  zarr["eval_fused"])
        for label, run in zarr["serving"].items():
            key = label.replace(" ", "_")
            paths[key], fused_by_path[key] = run["launches"], run["fused"]
        tick("zarr path and serving")

        # the HEALPix Swin at the shipped width (flash) and with 8x8 windows
        # at nside 32 (token-major)
        hpx_paths, hpx_fused, hpx_runs = run_hpx_swin_paths(card)
        paths.update(hpx_paths)
        fused_by_path.update(hpx_fused)
        train_runs.update(hpx_runs)
        tick("HEALPix Swin (both)")

        # the ladder's attention rows: the Swin at head dims 56, 80 and 120,
        # Pangu at batch 1 and 2, the windowed Swin at 2.0 degrees, the Swin
        # in bf16 compute (the kernel-free rows and the matrices run in the
        # second process)
        ladder_dir = tempfile.mkdtemp(prefix="chip_smoke_ladder_")
        ladder_out = os.path.join(ladder_dir, "ladder.json")
        t_ladder = time.perf_counter()
        paths.update(run_ladder_rows(card, ladder_out, LADDER_CARD_ROWS))
        ladder_s = time.perf_counter() - t_ladder
        tick("ladder rows")

        # the second process's paths: the graph families, the ModernUNet
        # family and diffusion, Navier-Stokes and the recurrent models, the
        # spectral families
        analysis_res = analysis.join(card)
        side_res = side.join(card)
        paths.update(side_res["paths"])
        bf16_by_path.update(side_res["bf16"])
    finally:
        side.stop()
        if analysis is not None:
            analysis.stop()
    torch.set_num_threads(n_threads)
    clock("waiting for the kernel-free phases")
    # the tables of the phase's ladder: both processes' rows at batch 1
    t_ladder = time.perf_counter()
    with open(ladder_out) as f:
        entries = json.load(f)
    with open(ladder_out, "w") as f:
        json.dump({**entries, **side_res["ladder"]}, f, indent=1, sort_keys=True)
    ladder_tables_of(card, ladder_out)
    print(f"ladder phase: {ladder_s + time.perf_counter() - t_ladder:.1f} s in this process "
          f"(its rows and tables) [{card}]")
    # the analysis phase's checks and the scaling model on this run's ladder
    paths.update(check_analysis(card, analysis_res, ladder_out))
    import shutil

    shutil.rmtree(ladder_dir, ignore_errors=True)

    flash = check_flash(card)
    flash_bwd = check_flash_bwd(card)
    window = check_window(card)
    packed = check_packed(card)
    check_packed_vs_5d(card)
    clock("kernel checks")

    # the distributed phase: the Swin's train path with data_parallel=2
    # against the one above, ring attention, the halo, the sharded HEALPix
    # pad, the partitioned GraphCast and the spectral models on 2 ranks
    # sharing the card (gloo), the one-rank NCCL collectives
    paths.update(run_distributed_paths(card, train))
    # the profile entry: the U-Net's rollout and the Swin's train step
    paths.update(run_profile_paths(card))
    bf16_by_path.update({k: r["bf16"] for k, r in train_runs.items()})

    # Each kernel's times at its path's largest case in fp32 (the paths'
    # dtype); the error is the worst over its fp32 cases.  `launches`
    # counts the path of the kernel's slice, `launches_by_path` every path.
    # A kernel with two designs adds its new design's launches on that path
    # (`fused_launches`; `mma_launches` for the flash kernels), the design
    # its case took, and the old design's time there (`old_ms`: the row
    # forwards, the four-pass packed backward, the flash backward's row
    # passes).
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
            bf16_launches_by_path={p: c[name] for p, c in bf16_by_path.items()},
            **({"mma_launches": fused_by_path["train"][name], "design": head["design"],
                "old_ms": head["old_ms"]} if "design" in head else {}),
            max_abs_err=max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=f"{head['case']} q[{head['B']},{head['H']},{head['N']},{head['D']}] {head['dtype']}",
            **{f"{kind}_cases": [
                {k: c[k] for k in ("case", "B", "H", "N", "D", "bias", "dtype", "max_abs_err",
                                   "design", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}
                for c in cases if c["case"].startswith(kind)]
               for kind in ("hpx", "ladder", "ring")},
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
                bf16_launches_by_path={p: c[kname] for p, c in bf16_by_path.items()},
                fused_launches=fused_by_path[slice_path][kname],
                design=head["bwd_route"] if pre else head["fwd_route"],
                **({} if pre else {"old_ms": head["row_ms"]}),
                max_abs_err=max(c[err] for c in fp32),
                ms=head[f"{pre}ms"], plain_ms=head[f"plain_{pre}ms"],
                bound_ms=head[f"{pre}bound_ms"], bound_by=head[f"{pre}bound_by"],
                library_ms=head[f"library_{pre}ms"],
                shape=f"{head['case']} qkv{head['shape']} nh {head['nh']} {head['dtype']}",
                **{f"{kind}_cases": [
                    {"case": c["case"], "shape": c["shape"], "dtype": c["dtype"],
                     "max_abs_err": c[err], **{k: c[pre + k] for k in (
                         "ms", "bound_ms", "bound_by")},
                     "plain_ms": c[f"plain_{pre}ms"], "library_ms": c[f"library_{pre}ms"]}
                    for c in window if c["case"].startswith(kind) and c["layout"] == layout]
                   for kind in ("hpx", "ladder")},
            ))
    fp32 = [c for c in packed if c["dtype"] == "float32"]
    head = next(c for c in fp32 if c["case"] == "pangu stage1 shifted")
    for kname, pre, rep, err in (("packed_window_attention", "", f"{pa}:967", "fwd_max_abs_err"),
                                 ("packed_window_attention_bwd", "bwd_", f"{pa}:1033",
                                  "bwd_max_abs_err")):
        kernels.append(dict(
            name=kname, route="cuda", source=f"{csrc}/packed_window_attention.cu",
            replaces=rep, launches=paths["packed"][kname],
            launches_by_path={p: c[kname] for p, c in paths.items()},
            bf16_launches_by_path={p: c[kname] for p, c in bf16_by_path.items()},
            fused_launches=fused_by_path["packed"][kname],
            design=head["bwd_route"] if pre else head["fwd_route"],
            old_ms=head["four_pass_bwd_ms"] if pre else head["row_ms"],
            max_abs_err=max(c[err] for c in fp32),
            ms=head[f"{pre}ms"], plain_ms=head[f"plain_{pre}ms"],
            bound_ms=head[f"{pre}bound_ms"], bound_by=head[f"{pre}bound_by"],
            library_ms=head[f"library_{pre}ms"],
            shape=f"{head['case']} q{head['q']} mask {list(head['mask'])} {head['dtype']}",
        ))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start to the kernels line")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
