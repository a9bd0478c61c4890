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
the backward pass instead of kept.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("full",)


@functools.lru_cache(maxsize=None)
def device_constant(table_fn: Callable, *args, device) -> torch.Tensor:
    """`table_fn(*args)`, a numpy table of a model's geometry (index or
    shift-group tables), as a tensor on `device`.  Built and copied once
    per (table, arguments, device) and returned as the same tensor after
    that, so a forward pass copies nothing from the host; the one copy
    goes from pinned memory without blocking, so not even the first
    forward waits for the card.  Callers must not write to it."""
    t = torch.from_numpy(table_fn(*args))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


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
    """Base class: subclasses implement `step` (and optionally `precompute`).

    `step(x, state[, aux])` maps the assembled input [B, H, W, Cin] to the
    prognostic increment [B, H, W, Cq] and the next model state (None for
    stateless nets).

    `remat=True` rematerialises each rollout step in the backward pass;
    `remat_policy` "full" saves nothing of the step.  The JAX package's
    "dots" policies keep matmul outputs and are not ported (ROADMAP
    queue A, item 3).
    """

    def __init__(self, context_size: int = 1, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {remat_policy!r} is not ported to PyTorch; only "
                f"{REMAT_POLICIES} (ROADMAP queue A, item 3)"
            )
        self.context_size = context_size
        self.remat = bool(remat)
        self.remat_policy = remat_policy

    def _step(self, x_t: torch.Tensor, state: Any, aux: Any):
        if aux is None:
            return self.step(x_t, state)
        return self.step(x_t, state, aux)

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        raise NotImplementedError

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
        state = None  # stateful models (ConvLSTM) bring their state when ported
        aux = self.precompute()  # once per rollout, outside any checkpoint
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for t in range(steps):
            parts = [] if const is None else [const]
            if pres is not None:
                parts.append(_flatten_window(pres[:, t : t + ctx]))
            parts.append(_flatten_window(window))
            x_t = torch.cat(parts, dim=-1)
            if remat:
                delta, state = checkpoint(self._step, x_t, state, aux, use_reentrant=False)
            else:
                delta, state = self._step(x_t, state, aux)
            out = window[:, -1] + delta  # residual prediction
            window = torch.cat([window[:, 1:], out[:, None]], dim=1)
            outs.append(out)
        # [B, steps, H, W, C] -> [B, steps, C, H, W]
        return torch.movedim(torch.stack(outs, dim=1), -1, 2)
