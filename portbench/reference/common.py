"""Plain PyTorch pieces the reference models share: attention, the MLP,
the autoregressive rollout, and the precision a reference runs in.

Nothing here imports the program under test: this is the yardstick the
benchmark holds the program against.  Every product is an ordinary
`matmul`, `einsum`, `linear` or convolution, in float32 with TF32 off
unless `precision("tf32", ...)` says otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass(frozen=True)
class AttentionCall:
    """One attention call as the work counters see it: the query's shape
    [..., N, d] and the elements of its additive bias and mask, as an
    implementation would read them."""

    q_shape: tuple
    bias_numel: int
    mask_numel: int


def attention(q, k, v, bias, calls: Optional[list] = None, bias_numel: int = 0,
              mask_numel: int = 0) -> torch.Tensor:
    """softmax(q k^T d^-1/2 + bias) v for q, k, v [..., N, d]; `bias`
    broadcasts against the scores [..., N, N].  Appends the call to
    `calls` when given."""
    if calls is not None:
        calls.append(AttentionCall(tuple(q.shape), int(bias_numel), int(mask_numel)))
    d = q.shape[-1]
    s = torch.matmul(q * d**-0.5, k.transpose(-1, -2)) + bias
    return torch.matmul(s.softmax(dim=-1), v)


class Mlp(nn.Module):
    """Dense -> tanh GELU -> Dense."""

    def __init__(self, dim: int, hidden: int, approximate: str = "tanh"):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)
        self.approximate = approximate

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate=self.approximate))


def nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 2D (transposed) convolution of a channels-last [B, H, W, C] tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Rollout(nn.Module):
    """The closed-loop rollout every lat-lon model of the benchmark follows:
    input frames [B, T, C, H, W] channel-first; each step sees the
    constants, the prescribed and the prognostic context window flattened
    time-major onto channels, and predicts the residual added to the last
    frame; teacher forcing for the first `context_size` frames.  Subclasses
    give `step(x [B, H, W, Cin], aux) -> [B, H, W, Cq]` and
    `precompute() -> aux`, computed once per rollout."""

    def __init__(self, context_size: int = 1):
        super().__init__()
        self.context_size = int(context_size)
        self.attention_calls: Optional[list] = None  # set by the work counters

    def precompute(self):
        return None

    def step(self, x, aux):
        raise NotImplementedError

    def forward(self, constants, prescribed, prognostic):
        ctx = self.context_size
        steps = prognostic.shape[1] - ctx
        prog = torch.movedim(prognostic, 2, -1)
        const = None if constants is None else torch.movedim(constants, 2, -1)[:, 0]
        pres = None if prescribed is None else torch.movedim(prescribed, 2, -1)

        def flat(win):  # [B, ctx, H, W, C] -> [B, H, W, ctx * C]
            b, c, h, w, ch = win.shape
            return torch.movedim(win, 1, -2).reshape(b, h, w, c * ch)

        window = prog[:, :ctx]
        aux = self.precompute()
        outs = []
        for t in range(steps):
            parts = [] if const is None else [const]
            if pres is not None:
                parts.append(flat(pres[:, t:t + ctx]))
            parts.append(flat(window))
            out = window[:, -1] + self.step(torch.cat(parts, dim=-1), aux)
            window = torch.cat([window[:, 1:], out[:, None]], dim=1)
            outs.append(out)
        return torch.movedim(torch.stack(outs, dim=1), -1, 2)


# ---------------------------------------------------------------- precision
def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 explicit mantissa bits, to nearest (ties away
    from zero), kept in float32."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Operands(TorchDispatchMode):
    """Rounds the floating operands of every matrix product and
    convolution to TF32 (the CPU's stand-in for the card's TF32 units,
    which also accumulate in float32)."""

    def __init__(self):
        super().__init__()
        a = torch.ops.aten
        self.products = {a.mm.default, a.addmm.default, a.bmm.default, a.baddbmm.default,
                         a.convolution.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.products:
            args = tuple(round_to_tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(mode: str, device: torch.device):
    """Run the reference in `mode`: "float32" (TF32 off in matmuls and
    cuDNN) or "tf32" (the control: TF32 on, on the card; on the CPU the
    products' operands rounded to TF32)."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision {mode!r}: float32 or tf32")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if tf32 and torch.device(device).type == "cpu":
            with _TF32Operands():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
