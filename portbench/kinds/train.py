"""Traffic of kind "train": the program's `Trainer.train_step` in a closed
loop on `prefetch_to_device(dataset.batches(batch_size, shuffle=True))`,
epoch after epoch, as `Trainer.train_epoch` drives it.

Set-up builds the trainer as the train entry does (`train.build_trainer`:
the registry's model, remat, TF32 off), loads the drawn weights, and takes
the first `warmup_steps` steps through the window's own feed and call; the
first `check_steps` of them are the ones the reference follows.  The
window then steps until `seconds` have passed and ends in a synchronise.
A traced run profiles `trace_steps` more steps after the window.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import check, inputs, weights
from portbench.kinds import common

BETA1 = 0.9  # the program's AdamW betas[0], whose first moment gives the first gradient


def _feed(ds, batch_size, device, kept: list, keep: int):
    from dlwpbench_tpu_torch.training.trainer import prefetch_to_device

    def teed(batches):
        for b in batches:
            if len(kept) < keep:
                kept.append(b)
            yield b

    while True:
        yield from prefetch_to_device(teed(ds.batches(batch_size, shuffle=True)), device)


def run(ctx: common.Context) -> common.Outcome:
    from dlwpbench_tpu_torch import train as port_train

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, seq = int(tr["batch_size"]), int(tr["sequence_length"])
    n_check = int(tr["check_steps"])
    phases = {}
    t = time.perf_counter()
    ds = inputs.windowed(cfg["data"], seq, B * int(tr["batches_per_epoch"]), ctx.seed, dev,
                         int(cfg["model"]["context_size"]))
    phases["inputs"], t = time.perf_counter() - t, time.perf_counter()
    trainer = port_train.build_trainer(common.port_config(cfg, seq), dev)
    model = trainer.model
    phases["build"], t = time.perf_counter() - t, time.perf_counter()
    shapes = {n: p.shape for n, p in model.named_parameters()}
    w0 = weights.draw(shapes, inputs.generator(ctx.seed, "weights", dev), dev)
    weights.load(model, w0)
    state = trainer.init()
    lr = trainer.base_lr
    kept: list = []
    feed = _feed(ds, B, dev, kept, n_check)

    p_losses, p_grad, p_change = [], None, None
    for i in range(max(int(tr["warmup_steps"]), n_check)):
        loss = trainer.train_step(state, next(feed), lr)
        if i < n_check:
            p_losses.append(loss)
        if i == 0:
            moments = state.optimizer.state
            p_grad = check.leaf_norms({n: moments[p]["exp_avg"] / (1 - BETA1)
                                       for n, p in model.named_parameters()})
        if i == n_check - 1:
            p_change = check.leaf_norms({n: p.detach() - w0[n]
                                         for n, p in model.named_parameters()})
    del w0
    phases["warmup"] = time.perf_counter() - t

    spans = {"input_wait": [], "dispatch": []}
    losses = []
    common.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    marks = [common.mark(dev)]
    while True:
        ta = time.perf_counter()
        batch = next(feed)
        tb = time.perf_counter()
        losses.append(trainer.train_step(state, batch, lr))
        tc = time.perf_counter()
        marks.append(common.mark(dev))
        spans["input_wait"].append(tb - ta)
        spans["dispatch"].append(tc - tb)
        if tc - t0 >= ctx.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = common.peak_bytes(dev)
    steps = len(losses)
    step_s = common.intervals(marks, dev)

    t_traced = time.perf_counter()
    summary = None
    if ctx.trace:
        def traced_step():
            with torch.profiler.record_function("portbench::input_wait"):
                batch = next(feed)
            with torch.profiler.record_function("portbench::train_step"):
                trainer.train_step(state, batch, lr)

        summary = common.traced(traced_step, int(tr["trace_steps"]), dev)

    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    p_losses = [float(x) for x in p_losses]
    feed.close()
    del feed, state, trainer, model, losses
    gc.collect()
    common.free_cache(dev)
    t_checked = time.perf_counter()

    r_losses, r_grad, r_change = reference_readings(ctx, kept[:n_check], "float32")
    numbers = check.train_numbers(p_losses, r_losses, p_grad, r_grad, p_change, r_change)
    return common.Outcome(
        kind="train", t_window_start=t0, window_s=window_s, units=steps,
        rows=steps * B, memory_peak_bytes=peak, failed=failed, numbers=numbers,
        record={"spans": spans, "step_s": step_s, "backward": True,
                "traced_units": int(tr["trace_steps"]) if ctx.trace else 0},
        summary=summary,
        phases={**phases, "trace": t_checked - t_traced, "check": time.perf_counter() - t_checked})


def reference_readings(ctx: common.Context, host_batches, precision: str,
                       rows_fraction: float = 1.0):
    """(losses, first-gradient leaf norms, change leaf norms) of the
    reference trained from the run's weights on `host_batches` in
    `precision`; `rows_fraction` < 1 trains it on that leading share of
    each batch's rows (a planted fault)."""
    from portbench.reference import reference_class
    from portbench.reference import common as rc
    from portbench.reference import train as rt

    cfg, dev = ctx.config, ctx.device
    ref = reference_class(cfg["family"])(**cfg["model"]).to(dev)
    shapes = {n: p.shape for n, p in ref.named_parameters()}
    w0 = weights.draw(shapes, inputs.generator(ctx.seed, "weights", dev), dev)
    weights.load(ref, w0)
    batches = []
    for b in host_batches:
        n = max(1, int(round(b[2].shape[0] * rows_fraction)))
        batches.append(inputs.host_batch_to([None if x is None else x[:n] for x in b], dev))
    tcfg = cfg["training"]
    with rc.precision(precision, dev):
        losses, first = rt.train_steps(ref, batches, float(tcfg["learning_rate"]),
                                       float(tcfg["optimizer_weight_decay"]),
                                       bool(tcfg["clip_gradients"]), int(cfg["reference_rows"]))
    change = check.leaf_norms({n: p.detach() - w0[n] for n, p in ref.named_parameters()})
    return [float(x) for x in losses], check.leaf_norms(first), change
