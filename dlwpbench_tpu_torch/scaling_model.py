"""Analytic multi-card scaling model for the flagship families, on the
H100's own figures (counterpart of `scripts/scaling_model.py`).

The model combines MEASURED single-card step times (the port's ladder,
`benchmark_ladder`, and training matrix, `benchmark_training`) with an
analytic communication model of each family's distributed design
(`parallel/`).  The algebra is JAX's, unchanged: `sfno_layer_flops`,
`model_families` (unet, sfno2d, sfno2d_fused, sfno2d_fused_2d, graphcast,
swin_ring, swin_ring_2d: each family's cross-card bytes a training step,
its pipeline depth K and its overlappable fraction alpha), the K-chunk
overlap `efficiency`, the per-part FLOP `compute_scale` from 5.625 to 1.0
degrees, and the batch-32 hybrid (data x 2-way spatial) training rows.

What the port puts in place of JAX's TPU figures:
- the link: one H100 SXM5 (`CHIPS`), NVLink 4 with 18 links, 900 GB/s a
  card both ways, 450 GB/s a direction (NVIDIA's H100 datasheet); where
  the microbench file (`collective_microbench`) was written over NCCL
  with one rank a card and several ranks, its fitted `effective_bw_gbps`
  instead.  Each row names the figure it used (`link_bytes_per_s`,
  `link_source`);
- step times measured on the H100 itself: no FLOP ratio between chips;
- the fused schedule's single-card overhead: the port's own
  `fused_step_time_s` K8 / K1 (`schedule_audit`, from the microbench
  file); without it the fused rows are left out;
- the bf16 compute factor of the SFNO rows with bf16 exchanges: the
  port's measured `sfno2d@32m@32x64@bf16` / `sfno2d@32m@32x64` step ratio
  from the ladder; without that pair those rows are left out.

    python -m dlwpbench_tpu_torch.scaling_model [--ladder outputs/ladder.json]
        [--microbench outputs/collective_microbench.json]
        [--training outputs/benchmark_training.json] [--out outputs/scaling_model.json]

Writes `--out`: `_assumptions`, `_validation` and one entry per
`h100-sxm5:<grid>:<family>[:<payload>comm]` with JAX's keys.
"""

from __future__ import annotations

import argparse
import json
import math
import os

# one H100 SXM5: NVLink 4, 18 links, 900 GB/s a card both ways (NVIDIA
# H100 datasheet), 450 GB/s a direction, in bytes a second
CHIPS = {"h100-sxm5": {"link_bytes_per_s": 450e9, "link_source":
                       "datasheet: NVLink 4, 18 links, 450 GB/s a direction"}}
ASSUMPTIONS = (
    "H100 SXM5 (NVIDIA datasheet): NVLink 4, 18 links, 900 GB/s a card both ways, 450 GB/s "
    "a direction, the link figure unless the microbench file holds a fit over NCCL with one "
    "rank a card; 989 TFLOP/s bf16 dense, 3.35 TB/s HBM, 700 W; single-card step times "
    "measured on the H100 (the ladder and the training matrix); collective latency ignored "
    "(messages are MB-scale, bandwidth-bound); overlap assumes the collectives of a K-chunk "
    "pipeline run beside the compute, which the port's schedule audit has not shown (its "
    "collectives block the issuing host).")

SEQ = 15
C_ACT = 256
SFNO_LAYERS = 4
GC_LAYERS = 16
GC_DIM = 512
GRIDS = (("5.625deg", (32, 64)), ("1.0deg", (180, 360)))
SFNOS = ("sfno2d", "sfno2d_fused", "sfno2d_fused_2d")


def sfno_layer_flops(H, W, C):
    """(spectral, pointwise) FLOPs of one SFNO block — ratio feeds both the
    compute-scaling factor and the overlappable fraction alpha."""
    nlat, mmax, lmax = H, W // 2 + 1, H
    legendre = 2 * 4 * nlat * mmax * lmax * C * 2   # fwd + inv contractions
    mixer = 4 * lmax * mmax * C * C                  # per-degree channel mix
    pointwise = 2 * 2 * H * W * C * C                # block MLP (2 layers)
    return legendre + mixer, pointwise


def model_families(H, W, comm_elem_bytes):
    """{family: (comm_bytes fn(P), K pipeline chunks, alpha overlap frac)}.

    comm counts cross-card traffic per TRAINING step (fwd+bwd double every
    exchange — the adjoint of a transpose/halo is the mirrored exchange).
    """
    B = 1  # per-card batch after DP; spatial decomposition moves the rest

    def unet(P):
        rows = 0
        for level, n in ((0, 4), (1, 4), (2, 4)):
            rows += n * (W >> level) * C_ACT * (1 << level)
        return SEQ * 2 * 2 * B * rows * 4, 1, 0.0

    def sfno(P):
        # 2 transposes per layer per direction, payload = full activation,
        # (P-1)/P crosses links; byte-audited (collective_microbench)
        act = B * H * W * C_ACT * comm_elem_bytes
        comm = SEQ * 2 * (2 * SFNO_LAYERS) * act * (P - 1) / max(P, 1)
        spec, point = sfno_layer_flops(H, W, C_ACT)
        alpha = spec / (spec + point)
        return comm, 4, alpha

    def sfno_fused(P):
        # same transpose traffic as `sfno`; the fused block-stack schedule
        # (`parallel/spectral_dist.py:dist_sfno_blocks`) keeps the
        # activation chunked over channels across layer boundaries, so
        # alpha is the block share of step compute (everything but the
        # encoder/decoder)
        act = B * H * W * C_ACT * comm_elem_bytes
        comm = SEQ * 2 * (2 * SFNO_LAYERS) * act * (P - 1) / max(P, 1)
        spec, point = sfno_layer_flops(H, W, C_ACT)
        skip = 2 * H * W * C_ACT * C_ACT
        encdec_per_layer = 8 * H * W * C_ACT * C_ACT / SFNO_LAYERS
        block = spec + point + skip
        alpha = block / (block + encdec_per_layer)
        return comm, 8, alpha  # K=8: SFNO2DModule.dist_pipeline_chunks

    def sfno_fused_2d(P):
        # 2D latitude x channel mesh (`dist_sfno_blocks_2d`): x_sp <= 8
        # cards shard latitude, the rest shard channels (Q = P/x_sp); the
        # channel reductions (~5 activation-sized inputs a layer, each
        # A/x_sp a card) ride the same K-chunk pipeline
        x_sp = min(P, 8)
        Qc = max(1, P // x_sp)
        act = B * H * W * C_ACT * comm_elem_bytes
        spatial = SEQ * 2 * (2 * SFNO_LAYERS) * (act / Qc) \
            * (x_sp - 1) / x_sp
        chanred = SEQ * 2 * SFNO_LAYERS * 5 * (act / x_sp) \
            * (Qc - 1) / max(Qc, 1)
        spec, point = sfno_layer_flops(H, W, C_ACT)
        skip = 2 * H * W * C_ACT * C_ACT
        encdec_per_layer = 8 * H * W * C_ACT * C_ACT / SFNO_LAYERS
        block = spec + point + skip
        alpha = block / (block + encdec_per_layer)
        return spatial + chanred, 8, alpha

    def graphcast(P):
        # icosphere level tied to resolution (reference README.md:89:
        # L=3 at 5.625deg); multimesh vertices = 10*4^L + 2
        level = 3 if H <= 64 else 6
        V = 10 * 4**level + 2
        boundary_mesh = 2.0 * math.sqrt(V * P)
        proc = SEQ * 2 * GC_LAYERS * boundary_mesh * GC_DIM * 4
        # g2m scatter-in + m2g gather-out cross-partition fractions
        boundary_grid = 2.0 * math.sqrt(H * W * P)
        g2m = SEQ * 4 * boundary_grid * GC_DIM * 4
        return proc + g2m, 1, 0.0

    def swin_ring(P):
        # ring attention is a P-stage pipeline by construction
        # (`parallel/ring_attention.py`): each round posts the next kv
        # chunk's exchange before its flash kernel; alpha = attention
        # share of step FLOPs (~50/50 at 32x64)
        N = H * W
        per_call = 2 * B * N / max(P, 1) * C_ACT * 4
        area = N / (32 * 64)
        alpha = area / (area + 1.0)
        return SEQ * 2 * 8 * per_call * (P - 1), max(P, 1), alpha

    def swin_ring_2d(P):
        # 2D (sequence x head) ring (`ring_attention_sharded(head_axis=)`):
        # x_seq <= 8 cards shard tokens, the rest shard heads; the head-TP
        # projections add 2 reductions per block, (Qh-1)/Qh cross-link
        x_seq = min(P, 8)
        Qh = max(1, P // x_seq)
        N = H * W
        per_call = 2 * B * (N / x_seq) * (C_ACT / Qh) * 4
        ring = SEQ * 2 * 8 * per_call * (x_seq - 1)
        act_loc = B * (N / x_seq) * C_ACT * 4
        proj = SEQ * 2 * 8 * 2 * act_loc * (Qh - 1) / max(Qh, 1)
        area = N / (32 * 64)
        alpha = area / (area + 1.0)
        return ring + proj, max(x_seq, 1), alpha

    return {
        "unet": unet, "sfno2d": sfno, "sfno2d_fused": sfno_fused,
        "sfno2d_fused_2d": sfno_fused_2d,
        "graphcast": graphcast, "swin_ring": swin_ring,
        "swin_ring_2d": swin_ring_2d,
    }


def efficiency(t_comp, comm_s, K, alpha):
    """Pipelined-overlap efficiency: K-chunk software pipeline exposes the
    head chunk's comm plus whatever steady-state comm exceeds the
    overlappable compute window."""
    if comm_s <= 0:
        return 1.0
    if K <= 1:
        return t_comp / (t_comp + comm_s)
    steady = comm_s * (K - 1) / K
    capacity = alpha * t_comp * (K - 1) / K
    exposed = comm_s / K + max(0.0, steady - capacity)
    return t_comp / (t_comp + exposed)


def compute_scale(fam, H, W):
    """t1(grid) / t1(32x64): per-part FLOP scaling, not plain area."""
    area = (H * W) / (32 * 64)
    if fam.startswith("sfno2d"):
        s0, p0 = sfno_layer_flops(32, 64, C_ACT)
        s1, p1 = sfno_layer_flops(H, W, C_ACT)
        return (s1 + p1) / (s0 + p0)
    if fam.startswith("swin_ring"):
        # global-window attention is O(N^2); assume ~50/50 attn/mlp split
        # at 32x64
        return 0.5 * area**2 + 0.5 * area
    return area


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def link_of(spec: dict, microbench: dict) -> tuple[float, str]:
    """(bytes a second, what it is) of the link the rows use: the
    microbench's fitted all-to-all bandwidth where it was measured over
    NCCL with one rank a card across several cards, else the chip's
    datasheet figure."""
    bw = microbench.get("timing", {}).get("effective_bw_gbps")
    if (bw and microbench.get("backend") == "nccl" and microbench.get("ranks_per_card") == 1
            and microbench.get("devices", 1) > 1):
        return bw * 1e9, (f"measured: collective_microbench all_to_all fit over NCCL, "
                          f"{microbench['devices']} cards ({microbench.get('device')}, "
                          f"{microbench.get('power_limit_w')} W)")
    return spec["link_bytes_per_s"], spec["link_source"]


def fused_overhead(microbench: dict):
    """The fused schedule's single-card cost against the per-conv path:
    the port's `fused_step_time_s` K8 / K1 (`schedule_audit`), or None."""
    t = microbench.get("schedule_audit", {}).get("fused_step_time_s", {})
    return t["K8"] / t["K1"] if t.get("K1") and t.get("K8") else None


def bf16_step_ratio(ladder: dict):
    """The SFNO's bf16 / fp32 step at the 32m rung on 32 x 64, or None."""
    a, b = ladder.get("sfno2d@32m@32x64@bf16", {}), ladder.get("sfno2d@32m@32x64", {})
    return a["step_s"] / b["step_s"] if a.get("step_s") and b.get("step_s") else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ladder", default="outputs/ladder.json")
    ap.add_argument("--microbench", default="outputs/collective_microbench.json")
    ap.add_argument("--training", default="outputs/benchmark_training.json")
    ap.add_argument("--out", default="outputs/scaling_model.json")
    args = ap.parse_args(argv)

    ladder = _read(args.ladder)
    microbench = _read(args.microbench)
    fused = fused_overhead(microbench)
    bf16 = bf16_step_ratio(ladder)

    measured = {}
    for fam, key in (
        ("unet", "unet"), ("sfno2d", "sfno2d"), ("sfno2d_fused", "sfno2d"),
        ("sfno2d_fused_2d", "sfno2d"),
        ("graphcast", "graphcast"), ("swin_ring", "swin"),
        ("swin_ring_2d", "swin"),
    ):
        e = ladder.get(f"{key}@8m@32x64")
        if e and "step_s" in e:
            measured[fam] = e["step_s"]

    results = {
        "_assumptions": ASSUMPTIONS,
        "_validation": {
            "byte_audit": f"{args.microbench} byte_audit (the port's per-rank all-to-all bytes "
            "of the distributed spherical conv against this model's sfno layer claim; the "
            "all_to_all timing fit linear in bytes)",
            "schedule_audit": f"{args.microbench} schedule_audit (compute issued inside each "
            "collective's window, device time overlapped on the card)",
            "schedule_correctness": "tests/test_torch_spectral_dist.py (the port's "
            "distributed spectral layers against JAX's on 4 ranks)",
            "single_card_steps": f"{args.ladder} ({ladder_devices(ladder)})",
        },
        "_inputs": {"fused_overhead_measured": fused, "bf16_step_ratio": bf16},
    }
    for chip, spec in CHIPS.items():
        link, link_source = link_of(spec, microbench)
        for grid_name, (H, W) in GRIDS:
            for comm_name, comm_bytes_elem in (("bf16", 2), ("fp32", 4)):
                fams = model_families(H, W, comm_bytes_elem)
                for fam, model in fams.items():
                    if fam not in measured:
                        continue
                    # bf16 comm only differs for the transpose families
                    if comm_name == "fp32" and fam not in SFNOS:
                        continue
                    if fam.startswith("sfno2d_fused") and fused is None:
                        continue  # no measured fused overhead: no fused row
                    if comm_name == "bf16" and fam in SFNOS and bf16 is None:
                        continue  # no measured bf16 step ratio: no bf16 row
                    t1 = measured[fam] * compute_scale(fam, H, W)
                    if comm_name == "bf16" and fam in SFNOS:
                        # bf16 compute step (the benchmark default):
                        # measured bf16/fp32 step ratio at the 32m rung
                        t1 *= bf16
                    t1_sched = t1
                    if fam.startswith("sfno2d_fused"):
                        # the fused schedule pays its measured single-card
                        # overhead; efficiency is relative to ITS OWN
                        # single-card time, so the speedup column is the
                        # time-to-solution statement
                        t1_sched = t1 * fused
                    rows = {}
                    speedup = {}
                    for P in (1, 2, 4, 8, 16, 32, 64):
                        t_comp = t1_sched / P
                        comm, K, alpha = model(P)
                        comm_s = comm / link if P > 1 else 0.0
                        eff = efficiency(t_comp, comm_s, K, alpha)
                        rows[P] = round(eff, 3)
                        if fam.startswith("sfno2d_fused"):
                            speedup[P] = round(t1 / (t_comp / eff), 2)
                    key = f"{chip}:{grid_name}:{fam}"
                    if fam in SFNOS:
                        key += f":{comm_name}comm"
                    entry = {
                        "single_chip_step_s": round(t1_sched, 4),
                        "schedule": schedule_of(fam, comm_name),
                        "efficiency_by_chips": rows,
                        "link_bytes_per_s": link,
                        "link_source": link_source,
                    }
                    if fam.startswith("sfno2d_fused"):
                        entry["per_conv_single_chip_step_s"] = round(t1, 4)
                        entry["speedup_vs_best_single_chip"] = speedup
                        entry["fused_overhead_measured"] = round(fused, 3)
                    if fam.startswith("sfno2d") or fam.startswith("swin_ring"):
                        entry["overlap_assumption"] = (
                            "assumes the collectives run beside the compute the K-chunk "
                            "pipeline credits; the port's schedule audit "
                            "(collective_microbench.json:schedule_audit) counts the compute "
                            "issued inside each window and the device time overlapped, and "
                            "its blocking collectives show none; overlap across cards is "
                            "unverified")
                    results[key] = entry

    # --- hybrid DP x SP training-workload rows (batch 32) ---
    tr = _read(args.training).get("results", {})
    GLOBAL_B = 32
    for chip, spec in CHIPS.items():
        link, link_source = link_of(spec, microbench)
        for fam, key, params in (("sfno2d", "sfno2d", 4.8e6),
                                 ("graphcast", "graphcast", 0.83e6)):
            e = tr.get(key)
            if not e or "train_step_s" not in e:
                continue
            t32 = e["train_step_s"]
            rows = {}
            for P in (1, 2, 4, 8, 16, 32, 64):
                if P == 1:
                    rows[P] = 1.0
                    continue
                x_p = min(2, P)          # spatial 2-way, rest data-parallel
                groups = P // x_p
                b_grp = GLOBAL_B / groups
                t_comp = t32 / P          # perfect compute split
                if fam == "sfno2d":
                    act1 = 32 * 64 * C_ACT * 2  # bf16 payloads
                    per_chip = (
                        SEQ * 2 * (2 * SFNO_LAYERS)
                        * (b_grp * act1 / x_p) * (x_p - 1) / x_p
                    )
                    comm, K, alpha = per_chip, 4, 0.436
                else:
                    V = 642
                    boundary = 2.0 * math.sqrt(V * x_p)
                    comm = SEQ * 2 * GC_LAYERS * boundary * GC_DIM * 4 \
                        * b_grp / GLOBAL_B
                    K, alpha = 1, 0.0
                # ring all-reduce of bf16 grads across the data groups
                grad_s = 2 * params * 2 * (groups - 1) / max(groups, 1) / link
                comm_s = comm / link + grad_s
                rows[P] = round(efficiency(t_comp, comm_s, K, alpha), 3)
            results[f"{chip}:5.625deg:{fam}:train_b32_hybrid"] = {
                "mesh": "data=P/2, x=2",
                "train_step_b32_s": round(t32, 4),
                "efficiency_by_chips": rows,
                "link_bytes_per_s": link,
                "link_source": link_source,
            }

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    for k, v in results.items():
        if k.startswith("_"):
            continue
        print(f"{k:42s} {v['efficiency_by_chips']}")
    return json.loads(json.dumps(results))


def schedule_of(fam: str, comm_name: str) -> str:
    if fam == "sfno2d":
        return f"pipelined K=4 transposes, {comm_name} payloads"
    if fam == "sfno2d_fused":
        return f"fused block-stack pipeline K=8, {comm_name} payloads (dist_schedule=fused)"
    if fam == "sfno2d_fused_2d":
        return (f"2D latitude x channel fused pipeline (x_sp<=8, rest channel; {comm_name} "
                "payloads; dist_sfno_blocks_2d)")
    if fam == "swin_ring":
        return "P-stage ring pipeline (rotations posted before each round's attention)"
    if fam == "swin_ring_2d":
        return "2D sequence x head ring (x_seq<=8, rest heads; head-TP projections)"
    return "direct"


def ladder_devices(ladder: dict) -> str:
    seen = sorted({(e.get("device"), e.get("power_limit_w")) for e in ladder.values()
                   if isinstance(e, dict) and e.get("device")}, key=str)
    return "; ".join(f"{d}, {w} W" for d, w in seen) or "no device recorded"


if __name__ == "__main__":
    main()
