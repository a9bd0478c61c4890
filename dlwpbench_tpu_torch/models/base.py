"""Shared model calling convention and the autoregressive rollout.

Counterpart of `dlwpbench_tpu/models/base.py:36-181`.  Every model takes

    forward(constants [B,1,Cc,H,W], prescribed [B,T,Cp,H,W],
            prognostic [B,T,Cq,H,W]) -> [B, T-context, Cq, H, W]

channel-first at the API, channels-last inside.  Each step's input is the
constants, then the prescribed context window, then the prognostic context
window, flattened time-major onto channels; each step predicts the residual
`window[:, -1] + delta`.  Teacher forcing covers the first `context_size`
frames, the rest is closed-loop.  The JAX package scans the steps with
`lax.scan`; here they are a Python loop (PyTorch runs eagerly).
With `remat`, each step runs under `torch.utils.checkpoint` (the per-step
counterpart of `wrap_remat`, `:59-78`): its activations are recomputed in
the backward pass instead of kept, all of them under `remat_policy`
"full", all but the products' outputs under "dots" and "dots_no_batch"
(selective checkpointing, `REMAT_SAVED_OPS`).  `remat_step` is that
per-step checkpoint, shared with the recurrent models that run their own
loop (ConvLSTM, DISTANA), whose carry (the previous output and every LSTM
state) passes through it.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

_aten = torch.ops.aten
# The ATen ops whose outputs each policy keeps for the backward pass; every
# other op of the step (the registered attention kernels too, as JAX
# recomputes its Pallas calls) is recomputed.  JAX 0.9's rules:
# `dots_saveable` keeps every `dot_general` and `conv_general_dilated`
# output, `dots_with_no_batch_dims_saveable` only the dots without batch
# dimensions.  A Linear (on any leading dims) dispatches to mm or addmm, a
# batched product (einsum, matmul of two batched operands) to bmm or
# baddbmm, a convolution to convolution.
REMAT_SAVED_OPS = {
    "full": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten.convolution.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}
REMAT_POLICIES = tuple(REMAT_SAVED_OPS)


def remat_step(step, remat: bool, *args, policy: str = "full"):
    """`step(*args)`, under a per-step checkpoint when `remat` holds and
    gradients are on: the step's activations are recomputed in the
    backward pass from `args` (the step's input and carry) instead of
    kept, but for the outputs of `policy`'s ops (`REMAT_SAVED_OPS`)."""
    if not (remat and torch.is_grad_enabled()):
        return step(*args)
    saved = REMAT_SAVED_OPS[policy]
    if not saved:
        return checkpoint(step, *args, use_reentrant=False)
    return checkpoint(step, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   list(saved)))


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C, H, W] -> [B, T, H, W, C]."""
    return torch.movedim(x, 2, -1)


def _flatten_window(win: torch.Tensor) -> torch.Tensor:
    """[B, ctx, H, W, C] -> [B, H, W, ctx*C] (time-major channels, the
    reference's `b t c ... -> b (t c) ...`)."""
    b, ctx = win.shape[:2]
    spatial = win.shape[2:-1]
    c = win.shape[-1]
    return torch.movedim(win, 1, -2).reshape(b, *spatial, ctx * c)


class RolloutModel(nn.Module):
    """Base class: subclasses implement `step` (and optionally `init_state`
    and `precompute`).

    `step(x, state[, aux])` maps the assembled input [B, H, W, Cin] to the
    prognostic increment [B, H, W, Cq] and the next model state (None for
    stateless nets); `init_state` gives the state a rollout starts from.

    `remat=True` rematerialises each rollout step in the backward pass;
    `remat_policy` "full" saves nothing of the step, "dots" keeps the
    outputs of its matrix products and convolutions, "dots_no_batch" only
    those of its products without batch dimensions (`REMAT_SAVED_OPS`).
    """

    # the process group a partitioned model splits its nodes over (None:
    # not partitioned); its parameters are replicated there, so each
    # rank's gradients are its nodes' share, which the trainer sums
    partition_group = None

    def __init__(self, context_size: int = 1, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; expected one of "
                             f"{sorted(REMAT_POLICIES)}")
        self.context_size = context_size
        self.remat = bool(remat)
        self.remat_policy = remat_policy

    def _step(self, x_t: torch.Tensor, state: Any, aux: Any):
        if aux is None:
            return self.step(x_t, state)
        return self.step(x_t, state, aux)

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        raise NotImplementedError

    def init_state(self, frame: torch.Tensor) -> Any:
        """Optional recurrent state, reset per sequence (None by default).
        `frame` is the first prognostic frame [B, (F), H, W, Cq]; the JAX
        hook takes its shape alone, the port's state also follows its
        dtype and device."""
        return None

    def precompute(self) -> Any:
        """Per-rollout constants derived from the parameters alone (e.g.
        Swin's expanded attention biases), computed once per rollout and
        handed to every `step`.  None when there is nothing to hoist."""
        return None

    def forward(
        self,
        constants: Optional[torch.Tensor] = None,
        prescribed: Optional[torch.Tensor] = None,
        prognostic: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if prognostic is None:
            raise ValueError("prognostic input is required")
        ctx = self.context_size
        steps = prognostic.shape[1] - ctx
        if steps < 1:
            raise ValueError(
                f"sequence length {prognostic.shape[1]} must exceed context {ctx}"
            )
        prog = _to_channels_last(prognostic)
        const = None if constants is None else _to_channels_last(constants)[:, 0]
        pres = None if prescribed is None else _to_channels_last(prescribed)

        window = prog[:, :ctx]
        state = self.init_state(window[:, 0])
        aux = self.precompute()  # once per rollout, outside any checkpoint
        outs = []
        for t in range(steps):
            parts = [] if const is None else [const]
            if pres is not None:
                parts.append(_flatten_window(pres[:, t : t + ctx]))
            parts.append(_flatten_window(window))
            x_t = torch.cat(parts, dim=-1)
            delta, state = remat_step(self._step, self.remat, x_t, state, aux,
                                      policy=self.remat_policy)
            out = window[:, -1] + delta  # residual prediction
            window = torch.cat([window[:, 1:], out[:, None]], dim=1)
            outs.append(out)
        # [B, steps, H, W, C] -> [B, steps, C, H, W]
        return torch.movedim(torch.stack(outs, dim=1), -1, 2)


class RecurrentModel(RolloutModel):
    """The rollout of the recurrent models (ConvLSTM, DISTANA; JAX
    `convlstm.py:83-131`, `distana.py:137-184`), which differs from
    `RolloutModel`'s: a loop from t = 0 over all T frames with one frame
    per step, the input the ground truth while t < `context_size` and the
    model's previous output after; a state from `init_state`, reset per
    batch; `out = in_t + delta`; the outputs from `context_size` on.  Each
    step's input is the constants, the step's prescribed frame and `in_t`
    on channels.  With `remat` each step is checkpointed with its carry
    (`in_t` and the state), as `wrap_remat` checkpoints the JAX scan's body.
    Subclasses implement `init_state(frame)` and `step(x, state)`."""

    def _body(self, in_t, state, const, pres_t):
        parts = [] if const is None else [const]
        if pres_t is not None:
            parts.append(pres_t)
        delta, state = self.step(torch.cat([*parts, in_t], dim=-1), state)
        return in_t + delta, state

    def forward(
        self,
        constants: Optional[torch.Tensor] = None,
        prescribed: Optional[torch.Tensor] = None,
        prognostic: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if prognostic is None:
            raise ValueError("prognostic input is required")
        ctx = self.context_size
        if prognostic.shape[1] <= ctx:
            raise ValueError(
                f"sequence length {prognostic.shape[1]} must exceed context {ctx}"
            )
        prog = _to_channels_last(prognostic)
        const = None if constants is None else _to_channels_last(constants)[:, 0]
        pres = None if prescribed is None else _to_channels_last(prescribed)
        state = self.init_state(prog[:, 0])
        out, outs = None, []
        for t in range(prog.shape[1]):
            in_t = prog[:, t] if t < ctx else out
            out, state = remat_step(self._body, self.remat, in_t, state, const,
                                    None if pres is None else pres[:, t],
                                    policy=self.remat_policy)
            if t >= ctx:
                outs.append(out)
        # [B, T-ctx, (F), H, W, C] -> [B, T-ctx, C, (F), H, W]
        return torch.movedim(torch.stack(outs, dim=1), -1, 2)
