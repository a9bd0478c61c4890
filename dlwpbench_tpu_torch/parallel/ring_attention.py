"""Ring (context-parallel) window attention over the ranks of a mesh dim
(counterpart of `dlwpbench_tpu/parallel/ring_attention.py:44-160`).

Every rank holds a chunk of the window's query rows, a kv chunk and the
bias ROWS of its queries ([G, H, N/P, N], the only O(N^2) operand, /P per
rank).  P rounds: attend q_local x kv chunk with the flash kernels
(`ops/flash_attention.py::flash_window_attention_lse`, the hand-written
forward and its fused backward with the lse cotangent), merge the partial
softmax in fp32 by log-sum-exp,

    lse = logaddexp(lse_1, lse_2)
    out = out_1 exp(lse_1 - lse) + out_2 exp(lse_2 - lse),

and pass the kv chunk on to the next rank.  Each round posts the next
chunk's send and receive (`batch_isend_irecv` over the ring's group)
before its kernel launch, as JAX issues its `ppermute` first (`:76-84`),
and waits for them after it.

JAX differentiates the ring for free; here three pieces carry it:
- the rotation is an `autograd.Function` whose backward passes the kv
  chunks' cotangents the other way round the ring;
- the operands enter the ring through `launch.scatter_to_ranks` (the
  backward all-gathers the chunks' cotangents) and the output leaves it
  through `launch.gather_from_ranks` (the backward keeps the local
  chunk), so outside the ring activations and cotangents are the same on
  every rank and every parameter gradient equals the single-device one;
- the bias rows come from the replicated relative-position table through
  the same scatter.
On a gloo group the kv chunks of CUDA tensors travel through pinned host
memory (`launch.Exchange`); the kernels run on the card all the same.
"""

from __future__ import annotations

import torch

from dlwpbench_tpu_torch.ops.flash_attention import flash_window_attention_lse
from dlwpbench_tpu_torch.parallel import launch

NEG_BIG = -1e30


class _Rotate(torch.autograd.Function):
    """(k, v) -> the previous rank's (k, v): the exchange is posted here and
    appended to `pending`, whose `wait()` the caller runs before the first
    use of the outputs; the backward sends the cotangents back to that
    rank."""

    @staticmethod
    def forward(ctx, k, v, group, index, size, pending):
        ctx.group, ctx.index, ctx.size = group, index, size
        k_next, v_next = torch.empty_like(k), torch.empty_like(v)
        nxt, prv = (index + 1) % size, (index - 1) % size
        pending.append(launch.Exchange([(k, nxt), (v, nxt)], [(k_next, prv), (v_next, prv)],
                                       group))
        return k_next, v_next

    @staticmethod
    def backward(ctx, gk, gv):
        # the reverse ring: what this rank received came from index - 1, so
        # its cotangent goes there; index + 1 sends the cotangent of ours
        dk, dv = torch.empty_like(gk), torch.empty_like(gv)
        nxt, prv = (ctx.index + 1) % ctx.size, (ctx.index - 1) % ctx.size
        launch.Exchange([(gk, prv), (gv, prv)], [(dk, nxt), (dv, nxt)], ctx.group).wait()
        return dk, dv, None, None, None, None


def ring_window_attention(q_local, k_local, v_local, bias_local, group=None):
    """Sequence-sharded ring attention on this rank's chunks.

    q/k/v_local: [B, H, N/P, D], this rank's token rows;
    bias_local: [G, H, N/P, N], the bias rows of its queries over ALL key
    columns (group b % G, as in the kernel).  Returns out_local
    [B, H, N/P, D] in q's dtype."""
    p = torch.distributed.get_world_size(group)
    idx = torch.distributed.get_rank(group)
    B, H, Nl, D = q_local.shape
    if bias_local.shape[-1] != Nl * p:
        raise ValueError(f"bias columns {bias_local.shape[-1]} != {Nl} x {p} ranks")
    out = torch.zeros((B, H, Nl, D), dtype=torch.float32, device=q_local.device)
    lse = torch.full((B, H, 1, Nl), NEG_BIG, dtype=torch.float32, device=q_local.device)
    kc, vc = k_local, v_local
    for r in range(p):
        pending = []
        if r < p - 1:  # the next chunk's exchange is posted before this round's kernel
            k_next, v_next = _Rotate.apply(kc, vc, group, idx, p, pending)
        # the chunk now held came from rank (idx - r) % p: its bias columns
        src = (idx - r) % p
        bcols = bias_local[..., src * Nl:(src + 1) * Nl].contiguous()
        o_c, lse_c = flash_window_attention_lse(q_local, kc, vc, bcols)
        lse_new = torch.logaddexp(lse, lse_c)
        w_old = torch.exp(lse - lse_new).transpose(-1, -2)  # [B, H, Nl, 1]
        w_new = torch.exp(lse_c - lse_new).transpose(-1, -2)
        out = out * w_old + o_c.float() * w_new
        lse = lse_new
        if r < p - 1:
            pending[0].wait()
            kc, vc = k_next, v_next
    return out.to(q_local.dtype)


def ring_attention_sharded(q, k, v, bias, mesh, axis: str = "x", head_axis: str | None = None):
    """Replicated-array entry point: q, k, v [B, H, N, D] and bias [H, N, N]
    or [G, H, N, N], the same on every rank of `mesh`; shards the tokens of
    q/k/v and the query rows of the bias over the mesh dim `axis`, runs
    the ring and returns the whole output [B, H, N, D] on every rank.
    N % P == 0.

    `head_axis` adds the 2D (sequence x head) split: the heads shard over
    a second mesh dim and each head group runs its own ring over `axis`
    (no new collective inside the ring)."""
    if bias.ndim == 3:
        bias = bias[None]
    group, _, p = launch.axis(mesh, axis)
    N = q.shape[2]
    if N % p:
        raise ValueError(f"token count {N} must divide the {axis!r} dim ({p})")
    if head_axis is not None:
        hgroup, _, ph = launch.axis(mesh, head_axis)
        if q.shape[1] % ph:
            raise ValueError(f"head count {q.shape[1]} must divide the {head_axis!r} dim ({ph})")
        q, k, v, bias = (launch.scatter_to_ranks(t, 1, hgroup) for t in (q, k, v, bias))
    q, k, v, bias = (launch.scatter_to_ranks(t, 2, group) for t in (q, k, v, bias))
    out = launch.gather_from_ranks(ring_window_attention(q, k, v, bias, group), 2, group)
    if head_axis is not None:
        out = launch.gather_from_ranks(out, 1, hgroup)
    return out


def shard_ring_operands(q, k, v, bias, mesh, axis: str = "x"):
    """This rank's ring operands of replicated q, k, v [B, H, N, D] and
    bias ([H, N, N] or [G, H, N, N]): its token chunk of each and its
    query rows of the bias, contiguous, outside autograd (for callers that
    call `ring_window_attention` directly)."""
    _, i, p = launch.axis(mesh, axis)
    if bias.ndim == 3:
        bias = bias[None]
    m = q.shape[2] // p
    return tuple(t.narrow(2, i * m, m).contiguous() for t in (q, k, v, bias))
