"""Traffic of kind "rollout": the program's no-grad forecast loop,
`evaluation.evaluate.rollout_dataset(model, split, batch_size)`, called
on the same split again and again until `seconds` have passed; host
copies, batch assembly and the appends count, as the evaluate path has
them.

Set-up builds the model as the evaluate entry does (the registry's model,
TF32 off), loads the drawn weights and calls the loop `warmup_calls`
times.  A sample of the window's forecast batches, drawn from the seed as
they come (a reservoir of `check_batches`), is compared with the
reference's rollout of the same inputs after the window.  A traced run
profiles `trace_batches` more batches after the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, inputs, weights
from portbench.kinds import common


def run(ctx: common.Context) -> common.Outcome:
    from dlwpbench_tpu_torch.evaluation.evaluate import rollout_dataset
    from dlwpbench_tpu_torch.models import registry
    from dlwpbench_tpu_torch.utils.device import no_tf32

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, seq = int(tr["batch_size"]), int(tr["sequence_length"])
    ctx_size = int(cfg["model"]["context_size"])
    n_split = int(tr["batches_per_split"])
    no_tf32()
    phases = {}
    t = time.perf_counter()
    split = inputs.windowed(cfg["data"], seq, B * n_split, ctx.seed, dev, ctx_size)
    data = cfg["data"]
    phases["inputs"], t = time.perf_counter() - t, time.perf_counter()
    model = registry.build_model(dict(cfg["model"]), seed=0,
                                 grid_shape=(int(data["height"]), int(data["width"]))).to(dev)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    weights.load(model, weights.draw(shapes, inputs.generator(ctx.seed, "weights", dev), dev))
    phases["build"], t = time.perf_counter() - t, time.perf_counter()
    for _ in range(int(tr["warmup_calls"])):
        rollout_dataset(model, split, batch_size=B)
    phases["warmup"] = time.perf_counter() - t

    rng = np.random.default_rng(inputs.subseed(ctx.seed, "sample"))
    k = int(tr["check_batches"])
    sample: list = []  # (batch index in the window, its forecast)
    timings: list = []
    n_batches = 0
    common.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    while True:
        _, outs, _ = rollout_dataset(model, split, batch_size=B, timings=timings)
        for j in range(0, outs.shape[0], B):  # views: nothing is copied in the window
            if len(sample) < k:
                sample.append((n_batches, outs[j:j + B]))
            else:
                slot = int(rng.integers(0, n_batches + 1))
                if slot < k:
                    sample[slot] = (n_batches, outs[j:j + B])
            n_batches += 1
        del outs
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = common.peak_bytes(dev)
    samples = sum(n for n, _ in timings)
    lead = seq - ctx_size
    grid = int(data["height"]) * int(data["width"])

    t_traced = time.perf_counter()
    summary = None
    traced_calls = -(-int(tr["trace_batches"]) // n_split) if ctx.trace else 0
    if ctx.trace:
        def traced_call():
            with torch.profiler.record_function("portbench::rollout"):
                rollout_dataset(model, split, batch_size=B)

        summary = common.traced(traced_call, traced_calls, dev)

    failed = sum(int(not np.isfinite(out).all()) for _, out in sample)
    del model
    gc.collect()
    common.free_cache(dev)
    t_checked = time.perf_counter()

    host = list(split.batches(B))
    chosen = [host[i % n_split] for i, _ in sample]
    refs = reference_forecasts(ctx, chosen, "float32")
    numbers = {"forecast": max(forecast_gap(ctx, b, out, ref)
                               for b, (_, out), ref in zip(chosen, sample, refs))}
    return common.Outcome(
        kind="rollout", t_window_start=t0, window_s=window_s, units=n_batches,
        rows=samples * lead * grid, memory_peak_bytes=peak, failed=failed, numbers=numbers,
        record={"batch_s": [s for _, s in timings], "backward": False,
                "traced_units": traced_calls * n_split},
        summary=summary,
        phases={**phases, "trace": t_checked - t_traced, "check": time.perf_counter() - t_checked})


def reference_forecasts(ctx: common.Context, host_batches, precision: str) -> list:
    """The reference's rollouts [B, T', C, H, W] of `host_batches` from the
    run's weights, in `precision`, worked in blocks of `reference_rows`."""
    from portbench.reference import common as rc
    from portbench.reference import reference_class

    cfg, dev = ctx.config, ctx.device
    ref = reference_class(cfg["family"])(**cfg["model"]).to(dev)
    shapes = {n: p.shape for n, p in ref.named_parameters()}
    weights.load(ref, weights.draw(shapes, inputs.generator(ctx.seed, "weights", dev), dev))
    rows = int(cfg["reference_rows"])
    outs = []
    with torch.no_grad(), rc.precision(precision, dev):
        for batch in host_batches:
            const, pres, prog, _ = inputs.host_batch_to(batch, dev)
            outs.append(torch.cat([
                ref(*(None if x is None else x[lo:lo + rows] for x in (const, pres, prog))).cpu()
                for lo in range(0, prog.shape[0], rows)]).numpy())
    return outs


def forecast_gap(ctx: common.Context, host_batch, program_out, reference_out) -> float:
    initial = host_batch[2][:, int(ctx.config["model"]["context_size"]) - 1]
    return check.forecast_gap(program_out, reference_out, initial)
