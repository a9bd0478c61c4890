"""Training harness: AdamW + cosine LR, clipping to the LR, accumulation,
lat-weighted validation, best/last checkpoints.

The port's counterpart of `dlwpbench_tpu/training/trainer.py:36-456,
463-549` (reference `scripts/train.py:33-503`):

- AdamW(lr, weight_decay) with the epoch's cosine LR set on every param
  group before the epoch (`inject_hyperparams`, `:121-123`, `:253`).
  `torch.optim.AdamW` with betas (0.9, 0.999) and eps 1e-8 computes what
  `optax.adamw` does with its defaults: decoupled decay of every
  parameter, eps outside the square root;
- unweighted fp32 MSE training loss over the whole rollout (`:167-173`);
  latitude-weighted MSE validation per lead time and per channel
  (`:258-268`);
- the global gradient norm clipped to the current LR (`:41-45`, `:251-252`);
- gradient accumulation by splitting the batch into `accum` micro-batches
  weighted `n_full / B`, plus a remainder chunk weighted `rem / B`
  (`:214-249`), so accumulation equals the big-batch step;
- best/last checkpoints every `checkpoint_every` epochs, written by a
  background thread from a snapshot taken on the calling thread;
- `compute_dtype="bfloat16"`: mixed precision as the JAX trainer does it
  (`:103-109`, `_cast_compute` `:153-165`): the parameters and the
  batch's inputs are cast to bf16 inside the loss, every layer follows its
  input's dtype (LayerNorm, softmax and GELU included), the loss is taken
  in fp32, and the gradients, AdamW's moments and the checkpoints stay
  with the fp32 master parameters.  Validation runs in fp32;
- the batches reach the card through `prefetch_to_device`, the
  counterpart of `_prefetch_to_device` (`:441-455`, depth 2): staged in
  pinned memory and copied on a side stream while the previous step runs.
  An epoch reads nothing back from the card until its end: the steps are
  timed with CUDA events read once the epoch's loss is read;
- `training_type="diffusion"` (`:175-202`): the v-prediction loss of a
  diffusion model's `single_forward` on the residual target, one timestep
  k for the whole step in [0, T - 1) and Gaussian noise (`_diffusion_loss`;
  every micro-batch of a step gets the same k, and equal-shaped ones the
  same noise, as JAX passes one key to all of them, `:208-216`).  k comes
  from a host generator, so it indexes the schedule's tables on the card
  without a read back; the noise is drawn on the device from a generator
  seeded from `seed`.  An EMA of the fp32 master parameters starts as
  their copy (`:136-140`), is updated after every optimizer step as
  e * d + p * (1 - d) (`:288-294`, one `torch._foreach_lerp_`), and is
  checkpointed beside them; validation rolls out the raw parameters
  (`:258`).

PyTorch runs eagerly: a train step is the model's forward, `backward()`
and `optimizer.step()`, which updates the parameters in place.

Data parallelism (JAX `:76-99`, `:271-298`, `:430-436`; one process per
rank, `parallel/launch.py`): with a `data_group` of N ranks every rank
holds the same parameters and optimizer state.
- `data_parallel` (`n_hosts == 1`): every rank reads the same global
  batch and takes, of each micro-batch, its contiguous block of rows
  (JAX's `PartitionSpec("data")` on dim 0); a micro-batch whose rows do
  not split evenly is computed whole on every rank, as JAX replicates it;
- `multihost` (`n_hosts > 1`): each rank reads its own shard of the epoch
  (`dataset.batches(host_id=..., n_hosts=..., epoch=...)`), so the global
  batch is `n_hosts x batch_size` rows; under `training.model_parallel`
  the group is the whole mesh and the x ranks of one host read the same
  shard, each weighted 1 / group size, so the sum is the hosts' mean.
After the last micro-batch the gradients (and the step's loss) are
summed over the group in one flat all-reduce per dtype, each rank's
micro-batch weighted by its rows' share of the global batch, so clipping
and AdamW see the global-batch gradient on every rank.  A partitioned
model (`partition_group`: GraphCast, SFNO or FourCastNet with `spmd_mesh`) has its gradients
summed over its partition the same way, one flat all-reduce per dtype.
The diffusion branch draws the global batch's k and noise on every rank
from the same generators and keeps its own rows.  Validation runs the
whole split on every rank, as JAX validates it on every host; only rank
0 writes checkpoints and metrics.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import threading
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from dlwpbench_tpu_torch import weights as W
from dlwpbench_tpu_torch.ops import ddpm
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.training.losses import mse_loss
from dlwpbench_tpu_torch.utils import profiling

TRAINING_TYPES = ("regular", "diffusion")


def cosine_lr(epoch: int, base_lr: float, total_epochs: int) -> float:
    """torch CosineAnnealingLR(T_max=total_epochs), eta_min=0."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))


def clip_grads_to(grads: list[torch.Tensor], max_norm) -> torch.Tensor:
    """Scale `grads` in place so their global norm is at most `max_norm`
    (torch clip_grad_norm_ semantics, `max_norm / (gnorm + 1e-6)` capped at
    1); returns the norm before clipping."""
    gnorm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return gnorm


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the model and optimizer (parameters and
    AdamW moments live there), the loop counters and, for diffusion
    training, the EMA of the parameters by name."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    iteration: int = 0
    best_val_error: float = math.inf
    ema: Optional[dict[str, torch.Tensor]] = None


class Trainer:
    """Drives training of a port model on a `WindowedWeatherDataset`."""

    def __init__(
        self,
        model: nn.Module,
        learning_rate: float = 1e-3,
        weight_decay: float = 1e-5,
        epochs: int = 30,
        clip_gradients: bool = True,
        gradient_accumulation_steps: int = 1,
        lat_weights: np.ndarray | None = None,
        training_type: str = "regular",
        compute_dtype: str | None = None,
        seed: int = 1234,
        num_refinement_steps: int = 5,
        min_noise_std: float = 4e-4,
        ema_decay: float = 0.995,
        data_group=None,
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        if training_type not in TRAINING_TYPES:
            raise ValueError(f"training.type {training_type!r}: expected one of {TRAINING_TYPES}")
        self.diffusion = training_type == "diffusion"
        if self.diffusion and not hasattr(model, "single_forward"):
            raise ValueError(
                f"training.type 'diffusion' needs a diffusion model (DiffModernUNet, "
                f"DiffMUNetHPX); {type(model).__name__} has no single_forward")
        self.compute_dtype = None
        if compute_dtype not in (None, "float32"):
            dtype = getattr(torch, str(compute_dtype), None)
            if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
                raise ValueError(f"compute_dtype {compute_dtype!r} is not a floating dtype")
            self.compute_dtype = dtype
        if gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        self.model = model
        self.device = next(model.parameters()).device
        # data parallelism over `data_group`: split each global batch
        # (data_parallel) or read this host's shard of the epoch (multihost)
        self.data_group = data_group
        self.host_id, self.n_hosts = int(host_id), int(n_hosts)
        self.dp_rank, self.dp_size = (
            (0, 1) if data_group is None
            else (torch.distributed.get_rank(data_group),
                  torch.distributed.get_world_size(data_group)))
        self.split_batch = self.dp_size > 1 and self.n_hosts == 1
        self.ema_decay = float(ema_decay)
        if self.diffusion:
            self.sched = ddpm.make_refiner_schedule(num_refinement_steps, min_noise_std,
                                                    device=self.device)
            self._k_gen = torch.Generator().manual_seed(int(seed))
            self._noise_gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.base_lr = learning_rate
        self.weight_decay = weight_decay
        self.epochs = epochs
        self.clip_gradients = clip_gradients
        self.accum = gradient_accumulation_steps
        self.lat_weights = (
            None if lat_weights is None
            else torch.as_tensor(np.asarray(lat_weights, np.float32), device=self.device)
        )
        # (samples, seconds) per optimizer step: on the card the time
        # between CUDA events recorded on the compute stream after each
        # step (the wait for the batch's copy included), on the CPU the
        # host clock
        self.timings: list[tuple[int, float]] = []
        self.step_losses: list[float] = []  # every optimizer step's loss, in order

    # ------------------------------------------------------------------
    def init(self, params: Optional[Mapping[str, Any]] = None) -> TrainState:
        """A fresh TrainState on the model's own init, or on a flax
        parameter tree (`weights.load_flax_params`) when given."""
        if params is not None:
            W.load_flax_params(self.model, params)
        opt = torch.optim.AdamW(
            self.model.parameters(), lr=self.base_lr, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.weight_decay,
        )
        ema = ({n: p.detach().clone() for n, p in self.model.named_parameters()}
               if self.diffusion else None)
        return TrainState(model=self.model, optimizer=opt, ema=ema)

    def n_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    def _to_device(self, batch):
        """A host batch as device tensors, copied from pageable memory (a
        synchronous copy on the card); validation's path."""
        return tuple(
            None if x is None else torch.as_tensor(x).to(self.device, non_blocking=True)
            for x in batch
        )

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _compute_params(self, model: nn.Module):
        """With a compute dtype, the model runs on a copy of its float
        parameters in that dtype for the duration of the block: one cast
        per micro-batch, before the rollout and outside any checkpoint.
        The cast is in the autograd graph, so the gradients land on the
        fp32 master parameters in fp32.  The copies stay in place through
        the backward pass, which recomputes checkpointed rollout steps from
        them (`torch.func.functional_call` would restore the fp32
        parameters before that recomputation)."""
        if self.compute_dtype is None:
            yield
            return
        swapped = []
        for name, p in model.named_parameters():
            if p.is_floating_point():
                mod_name, _, leaf = name.rpartition(".")
                module = model.get_submodule(mod_name)
                swapped.append((module, leaf, p))
                module._parameters[leaf] = p.to(self.compute_dtype)
        try:
            yield
        finally:
            for module, leaf, p in swapped:
                module._parameters[leaf] = p

    def _loss(self, const, pres, prog, target) -> torch.Tensor:
        if self.compute_dtype is not None:  # the batch's float inputs, not the target
            const, pres, prog = (
                x if x is None or not x.is_floating_point() else x.to(self.compute_dtype)
                for x in (const, pres, prog)
            )
        out = self.model(const, pres, prog)
        return mse_loss(out.float(), target)  # the loss in fp32 whatever the compute dtype

    def _diffusion_loss(self, const, pres, prog, target, k: int,
                        noise: torch.Tensor) -> torch.Tensor:
        """v-prediction loss (reference `train.py:226-258`): the residual
        target noised to timestep k, denoised by `single_forward` from the
        context, MSE against the v target in fp32."""
        ctx = self.model.context_size
        if target.shape[1] != 1:
            raise ValueError(
                "diffusion training requires sequence_length == context_size + 1 "
                f"(one residual target); got {target.shape[1]} target frames")
        target_res = target - prog[:, ctx - 1 : ctx]
        y_noised = ddpm.add_noise(self.sched, target_res, noise, k)
        if self.compute_dtype is not None:
            const, pres, prog, y_noised = (
                x if x is None else x.to(self.compute_dtype) for x in (const, pres, prog, y_noised))
        out = self.model.single_forward(
            const, None if pres is None else pres[:, :ctx], prog[:, :ctx], y_noised,
            torch.full((prog.shape[0],), k, device=prog.device))
        v_target = ddpm.v_prediction_target(self.sched, target_res, noise, k)
        return mse_loss(out[:, None].float(), v_target)

    def _draw_k(self) -> int:
        """The step's diffusion timestep, uniform in [0, T - 1), on the host."""
        return int(torch.randint(0, self.sched.num_timesteps - 1, (), generator=self._k_gen))

    def _draw_noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._noise_gen, device=self.device)

    def _my_rows(self, n: int) -> tuple[slice, int]:
        """(this rank's rows of a micro-batch of n local rows, the global
        micro-batch's rows).  Under data_parallel the rank's contiguous
        block when the rows split evenly, else all of them (JAX replicates
        such a chunk); under multihost the local rows are the rank's block
        of n_hosts x n."""
        if self.split_batch and n % self.dp_size == 0:
            m = n // self.dp_size
            return slice(self.dp_rank * m, (self.dp_rank + 1) * m), n
        if self.n_hosts > 1:
            return slice(self.host_id * n, (self.host_id + 1) * n), n * self.n_hosts
        return slice(0, n), n

    def train_step(self, state: TrainState, batch, lr: float, k: Optional[int] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step over `accum` micro-batches (+ remainder);
        returns the batch loss (a 0-d tensor on the device).  Diffusion
        training draws the step's timestep and noise unless `k` and
        `noise` (of a micro-batch's target shape) are given."""
        with profiling.span("dlwpbench.train.step", device=self.device):
            const, pres, prog, target = batch
            params = [p for p in state.model.parameters() if p.requires_grad]
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.zero_grad(set_to_none=True)

            B = prog.shape[0]
            n_full = B // self.accum
            if n_full < 1:
                raise ValueError(f"batch of {B} is smaller than {self.accum} accumulation steps")
            chunks = [(i * n_full, (i + 1) * n_full) for i in range(self.accum)]
            if n_full * self.accum < B:
                chunks.append((n_full * self.accum, B))
            if self.diffusion and k is None:
                k = self._draw_k()
            noises = {} if noise is None else {tuple(noise.shape): noise}
            total = torch.zeros((), device=self.device)
            for lo, hi in chunks:
                # the chunk's share of the batch; each rank's gradient is
                # summed over the group (a chunk computed whole on every rank
                # counts 1 / dp_size on each)
                w = (hi - lo) / B / self.dp_size
                rows, n_global = self._my_rows(hi - lo)
                if self.split_batch:
                    lo, hi = lo + rows.start, lo + rows.stop
                part = [None if x is None else x[lo:hi] for x in batch]
                if self.diffusion:  # the global micro-batch's noise, this rank's rows
                    shape = (n_global, *part[3].shape[1:])
                    if shape not in noises:
                        if noise is not None:
                            raise ValueError(f"noise of shape {tuple(noise.shape)} for a "
                                             f"micro-batch target of {shape}")
                        noises[shape] = self._draw_noise(shape)
                with self._compute_params(state.model):
                    with profiling.span("dlwpbench.train.forward", device=self.device):
                        loss = (self._diffusion_loss(*part, k, noises[shape][rows])
                                if self.diffusion else self._loss(*part))
                    with profiling.span("dlwpbench.train.backward", device=self.device):
                        (w * loss).backward()
                total = total + w * loss.detach()

            for p in params:  # optax decays every parameter, gradient or not
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.dp_size > 1:  # the global batch's gradient and loss on every rank
                launch.all_reduce_([*(p.grad for p in params), total], self.data_group)
            partition = getattr(state.model, "partition_group", None)
            if partition is not None:  # each rank's nodes' share of every gradient
                launch.all_reduce_([p.grad for p in params], partition)
            if self.clip_gradients:
                with profiling.span("dlwpbench.train.clip", device=self.device):
                    clip_grads_to([p.grad for p in params], lr)
            with profiling.span("dlwpbench.train.optimizer", device=self.device):
                state.optimizer.step()
            return total

    def train_epoch(self, state: TrainState, dataset, batch_size: int,
                    shuffle: bool = True) -> float:
        lr = cosine_lr(state.epoch, self.base_lr, self.epochs)
        state.model.train()
        losses, samples = [], []
        card = self.device.type == "cuda"

        def mark():  # after each step: an event on the compute stream, or the host clock
            if not card:
                return time.perf_counter()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event

        marks = [mark()]
        shard = dataset.batches(batch_size, shuffle=shuffle, host_id=self.host_id,
                                n_hosts=self.n_hosts,
                                epoch=state.epoch if self.n_hosts > 1 else None)
        for batch in prefetch_to_device(shard, self.device):
            losses.append(self.train_step(state, batch, lr))
            if state.ema is not None:
                self._update_ema(state)
            samples.append(batch[2].shape[0])
            marks.append(mark())
            state.iteration += 1
        state.epoch += 1
        return self._close_epoch(losses, samples, marks)

    def _update_ema(self, state: TrainState) -> None:
        """ema = ema * d + p * (1 - d) over the fp32 master parameters, as
        one lerp by 1 - d on the device."""
        params = dict(state.model.named_parameters())
        torch._foreach_lerp_(list(state.ema.values()),
                             [params[n].detach() for n in state.ema], 1.0 - self.ema_decay)

    def _close_epoch(self, losses, samples, marks) -> float:
        """The epoch's one read from the card: its steps' losses (into
        `step_losses`) and their mean, then each step's seconds from the
        marks into `timings`."""
        if losses:
            stacked = torch.stack(losses)
            self.step_losses.extend(stacked.tolist())
        mean = float(stacked.mean()) if losses else float("nan")
        if self.device.type == "cuda":
            seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        else:
            seconds = [b - a for a, b in zip(marks, marks[1:])]
        self.timings.extend(zip(samples, seconds))
        return mean

    @torch.no_grad()
    def validate(self, state: TrainState, dataset, batch_size: int):
        """(mean loss, per-lead per-channel [T', C] errors), lat-weighted
        when the trainer has latitude weights."""
        state.model.eval()
        tot, n = 0.0, 0
        per_lead = []
        for batch in dataset.batches(batch_size):
            const, pres, prog, target = self._to_device(batch)
            err = (state.model(const, pres, prog) - target) ** 2
            if self.lat_weights is not None:
                err = err * self.lat_weights
            reduce = (0,) + tuple(range(3, err.ndim))
            bs = prog.shape[0]
            tot += float(err.mean()) * bs
            n += bs
            per_lead.append(err.mean(dim=reduce).cpu().numpy() * bs)
        state.model.train()
        if n == 0:  # empty validation split
            return float("nan"), np.zeros((0, 0))
        return tot / n, np.sum(per_lead, axis=0) / n

    # ------------------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        train_ds,
        val_ds,
        batch_size: int,
        val_batch_size: int | None = None,
        run_dir: str | None = None,
        model_name: str = "model",
        verbose: bool = True,
        on_epoch_end: Optional[Callable] = None,
        checkpoint_every: int = 1,
    ) -> TrainState:
        val_batch_size = val_batch_size or batch_size
        # in a job of several ranks only rank 0 writes to the run directory
        # (every rank holds the same state; JAX gates on process 0)
        writer = launch.host_info()[0] == 0
        logger = None
        if run_dir and writer:
            from dlwpbench_tpu_torch.utils.logging import RunLogger

            logger = RunLogger(run_dir)
        ckpt_writer = AsyncCheckpointWriter()
        best_dirty = False
        try:
            while state.epoch < self.epochs:
                t0 = time.time()
                train_loss = self.train_epoch(state, train_ds, batch_size)
                val_loss, per_lead = self.validate(state, val_ds, val_batch_size)
                epoch_s = time.time() - t0
                if verbose:
                    print(
                        f"epoch {state.epoch:3d}  train {train_loss:.5f}  "
                        f"val {val_loss:.5f}  ({epoch_s:.1f}s)",
                        flush=True,
                    )
                if logger:
                    rec = {
                        "train_loss": train_loss,
                        "val_loss": val_loss,
                        "epoch_s": epoch_s,
                        "lr": cosine_lr(state.epoch - 1, self.base_lr, self.epochs),
                    }
                    for t in range(min(per_lead.shape[0], 64) if per_lead.ndim else 0):
                        rec[f"val_mse/lead_{t+1}"] = float(per_lead[t].mean())
                    logger.log(rec, step=state.epoch)
                if run_dir:
                    # "best" coarsens with the interval: the state written
                    # is the best known at the interval boundary
                    if val_loss < state.best_val_error:
                        state.best_val_error = val_loss
                        best_dirty = True
                    at_interval = (
                        state.epoch % max(1, checkpoint_every) == 0
                        or state.epoch >= self.epochs
                    )
                    if at_interval and writer:
                        if best_dirty:
                            ckpt_writer.submit(run_dir, model_name, state, kind="best")
                            best_dirty = False
                        ckpt_writer.submit(run_dir, model_name, state, kind="last")
                if on_epoch_end:
                    on_epoch_end(state, train_loss, val_loss, per_lead)
        finally:
            ckpt_writer.join()  # all checkpoints durable before fit() returns
            if logger:
                logger.close()
        return state


# ----------------------------------------------------------------------
# The input pipeline (JAX `trainer.py:441-455`)
# ----------------------------------------------------------------------


def prefetch_to_device(batches, device, depth: int = 2):
    """Yield `batches` (tuples of numpy arrays or None) as tensors on
    `device`, keeping `depth` batches in flight.

    On the card each batch is staged in pinned host memory and copied on a
    side stream without blocking, so the copy of the next batch overlaps
    the current step; the compute stream waits for a batch's copy (an
    event) before its first use, and `record_stream` keeps the allocator
    from handing its memory to another stream while the step reads it.
    Each batch gets fresh pinned buffers from PyTorch's caching host
    allocator, which reuses a buffer only after the copy recorded on it
    has run.  Pinning or copying raises on failure; nothing falls back to
    a pageable copy.  On the CPU the batches pass through as tensors, in
    the same order.

    Spans (`utils/profiling.span`): `dlwpbench.input.pin` around each
    batch's pinning and the launch of its copy (on the CPU, the tensors'
    making), and `dlwpbench.input.stall` around the hand-over, timed on the compute
    stream: the device time by which the batch's copy ends after the
    compute stream reaches it, 0 when the copy ended first (on the CPU
    there is no copy to wait for)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            with profiling.span("dlwpbench.input.pin"):
                staged = tuple(None if x is None else torch.as_tensor(x) for x in batch)
            with profiling.span("dlwpbench.input.stall", device=device):
                pass  # no copy to wait for
            yield staged
        return
    copy_stream = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    in_flight = collections.deque()  # (pinned host tensors, device tensors, copied event)
    for batch in batches:
        with profiling.span("dlwpbench.input.pin"):
            host = [None if x is None else torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                    for x in batch]
            with torch.cuda.stream(copy_stream):
                dev = tuple(None if h is None else h.to(device, non_blocking=True) for h in host)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
        in_flight.append((host, dev, copied))
        if len(in_flight) >= depth:
            yield _hand_over(in_flight.popleft(), compute)
    while in_flight:
        yield _hand_over(in_flight.popleft(), compute)


def _hand_over(staged, compute):
    _, dev, copied = staged
    with profiling.span("dlwpbench.input.stall", device=compute.device):
        compute.wait_event(copied)
    for t in dev:
        if t is not None:
            t.record_stream(compute)
    return dev


# ----------------------------------------------------------------------
# Checkpointing (reference `utils/utils.py:29-57` + restore `train.py:110-123`)
# ----------------------------------------------------------------------


def _snapshot(obj):
    """A copy of a state_dict tree whose tensors are detached CPU copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def _payload(state: TrainState) -> dict:
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": state.epoch,
        "iteration": state.iteration,
        "best_val_error": state.best_val_error,
        "ema": state.ema or {},
    }


class AsyncCheckpointWriter:
    """Background checkpoint writes: the reference runs `write_checkpoint`
    on a thread so the next epoch's compute overlaps checkpoint IO.  One
    worker at a time: each submit joins the previous write first, so
    best/last ordering is preserved.

    `optimizer.step()` updates the parameters and moments in place, so a
    thread that serialised the live tensors could write a later step's
    values.  `submit` therefore snapshots every tensor as a detached CPU
    copy on the calling thread, before the writer starts (the counterpart
    of the JAX writer's copy before buffer donation, `trainer.py:470-496`)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def submit(self, run_dir: str, name: str, state: TrainState, kind: str):
        self.join()
        snap = _snapshot(_payload(state))
        self._thread = threading.Thread(
            target=self._write, args=(run_dir, name, snap, kind), daemon=True,
        )
        self._thread.start()

    def _write(self, run_dir, name, payload, kind):
        try:
            _write_payload(run_dir, name, payload, kind)
        except BaseException as e:  # re-raised on the caller's thread by join()
            self._error = e

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def checkpoint_path(run_dir: str, name: str, kind: str) -> str:
    return os.path.join(run_dir, "checkpoints", f"{name}_{kind}.ckpt")


def _write_payload(run_dir: str, name: str, payload: dict, kind: str):
    path = checkpoint_path(run_dir, name, kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(run_dir: str, name: str, state: TrainState, kind: str = "best") -> TrainState:
    """Restore a checkpoint into `state`'s model, optimizer and, when the
    state has one, EMA (in place, on the model's device); returns the
    TrainState with the stored counters."""
    path = checkpoint_path(run_dir, name, kind)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.ema is not None:
        stored = payload.get("ema") or {}
        if set(stored) != set(state.ema):
            raise KeyError(f"{path} holds no EMA of this model's parameters")
        with torch.no_grad():
            for n, t in state.ema.items():
                t.copy_(stored[n])
    return TrainState(
        model=state.model,
        optimizer=state.optimizer,
        epoch=int(payload["epoch"]),
        iteration=int(payload["iteration"]),
        best_val_error=float(payload["best_val_error"]),
        ema=state.ema,
    )
