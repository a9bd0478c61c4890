"""The work a cell does, counted by the benchmark from its own reference
at the cell's shapes, never from the program: model FLOPs and the
attention calls with their FLOPs and bytes, and the card's peaks.

- Model FLOPs: `FlopCounterMode` over the reference's forward on meta
  tensors (matrix products and convolutions; two FLOPs a multiply-add).
  A training step counts three forwards (the forward and a backward of
  twice its cost); nothing is counted for recomputation.
- An attention call on q [..., N, d] (P = the product of the leading
  dims): forward 2 products, 4 P N^2 d FLOPs; backward 4 products,
  exactly twice the forward.  Bytes, float32: the forward reads q, k, v,
  the bias and the mask once and writes out and the row statistic
  (logsumexp); the backward reads q, k, v, out, dout, the statistic, the
  bias and the mask and writes dq, dk, dv and dbias.
- The least time of a call is max(FLOPs / peak FLOP/s, bytes / peak
  bytes/s), with the peaks of `peaks.json` for the card.
"""

from __future__ import annotations

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.common import AttentionCall

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_name: str) -> dict | None:
    """The card's peaks ({"flops_per_s": {dtype: ...}, "bytes_per_s": ...}),
    or None for a card the table lacks."""
    with open(PEAKS_FILE) as f:
        return json.load(f).get(device_name)


def _parts(call: AttentionCall) -> tuple[int, int, int]:
    *lead, n, d = call.q_shape
    p = 1
    for x in lead:
        p *= x
    return p, n, d


def attention_flops(call: AttentionCall, backward: bool = False) -> int:
    p, n, d = _parts(call)
    return (8 if backward else 4) * p * n * n * d


def attention_bytes(call: AttentionCall, backward: bool = False, itemsize: int = 4) -> int:
    p, n, d = _parts(call)
    tokens, stat = p * n * d, p * n
    if backward:  # q k v out dout stat bias mask -> dq dk dv dbias
        elems = 5 * tokens + stat + call.bias_numel + call.mask_numel + 3 * tokens + call.bias_numel
    else:  # q k v bias mask -> out stat
        elems = 3 * tokens + call.bias_numel + call.mask_numel + tokens + stat
    return elems * itemsize


def least_seconds(calls, flops_per_s: float, bytes_per_s: float, backward: bool) -> float:
    """The sum over `calls` of each call's forward (and, with `backward`,
    its backward) least time."""
    total = 0.0
    for c in calls:
        for bwd in ((False, True) if backward else (False,)):
            total += max(attention_flops(c, bwd) / flops_per_s, attention_bytes(c, bwd) / bytes_per_s)
    return total


def forward_work(reference: torch.nn.Module, inputs: tuple) -> tuple[int, list]:
    """(FLOPs, attention calls) of one forward of `reference` (built on the
    meta device) on the meta tensors `inputs`."""
    reference.attention_calls = []
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            reference(*inputs)
        return counter.get_total_flops(), list(reference.attention_calls)
    finally:
        reference.attention_calls = None
