"""Halo exchange for grids whose latitude rows are sharded over ranks
(counterpart of `dlwpbench_tpu/parallel/halo.py:22-55`).

Each rank holds a block of rows [..., H_local, W].  A conv step needs
`halo` rows of its neighbours: the rank before sends its bottom rows, the
rank after its top rows, over point-to-point exchanges
(`launch.Exchange`); the first rank gets zero rows above and the last
zero rows below (the poles), which is CylinderPad's boundary, distributed.
The backward is the mirrored exchange: the cotangent of each received
block goes back to its sender and is added into the rows it sent.

Call these inside a sharded region (each rank on its own block):
`sharded_cylinder_pad` is the distributed `ops.padding.cylinder_pad`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dlwpbench_tpu_torch.parallel import launch


def _swap(up: torch.Tensor, down: torch.Tensor, group):
    """Send `up` to the rank before and `down` to the rank after; returns
    (from the rank before, from the rank after), zeros at the ends."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    from_prev, from_next = torch.zeros_like(down), torch.zeros_like(up)
    sends, recvs = [], []
    if i > 0:
        sends.append((up, i - 1))
        recvs.append((from_prev, i - 1))
    if i < n - 1:
        sends.append((down, i + 1))
        recvs.append((from_next, i + 1))
    launch.Exchange(sends, recvs, group).wait()
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group, ctx.rows = halo, group, x.shape[-2]
        top = x[..., :halo, :].contiguous()  # to the rank before
        bot = x[..., -halo:, :].contiguous()  # to the rank after
        return _swap(top, bot, group)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        h = ctx.halo
        # the rows from the rank before were its bottom rows: their
        # cotangent goes back up; those from the rank after go back down
        g_top, g_bot = _swap(g_prev.contiguous(), g_next.contiguous(), ctx.group)
        # g_top: from the rank before, the cotangent of the rows we sent up
        # (our top); g_bot: from the rank after, of our bottom rows
        shape = list(g_prev.shape)
        shape[-2] = ctx.rows
        dx = g_prev.new_zeros(shape)
        dx[..., :h, :] += g_top
        dx[..., -h:, :] += g_bot
        return dx, None, None


def halo_exchange_rows(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """[..., H_local, W] -> [..., H_local + 2 halo, W]: the neighbours'
    `halo` boundary rows above and below, zero rows at the first and last
    rank."""
    from_prev, from_next = _Halo.apply(x, halo, group)
    return torch.cat([from_prev, x, from_next], dim=-2)


def sharded_cylinder_pad(x: torch.Tensor, padding: int, group=None) -> torch.Tensor:
    """Distributed CylinderPad: circular in longitude (local), the halo
    exchange with zero poles in latitude (across ranks).  `padding` 0 is
    the identity, as in `ops.padding.cylinder_pad`."""
    p = int(padding)
    if p == 0:
        return x
    x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
    return halo_exchange_rows(x, p, group)
