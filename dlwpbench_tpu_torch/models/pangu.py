"""Pangu-Weather (counterpart of `dlwpbench_tpu/models/pangu.py`; reference
`models/panguweather/panguweather.py` and its utils).

3D (pressure level, lat, lon) earth-specific transformer, 2D surface
variant:
- PatchEmbed2D: zero pad to a patch multiple, conv k=s=patch -> tokens
  with a singleton pressure dim;
- layer plan 2-6-6-2: layer 1 (dim D) -> skip -> DownSample (2x2 token
  merge, Linear 4C->2C) -> layers 2 and 3 (dim 2D) -> UpSample (Linear
  C->4C', pixel shuffle, crop, LayerNorm, Linear) -> layer 4 (dim D) ->
  concat skip -> PatchRecovery2D (ConvTranspose + center crop);
- EarthSpecificBlock: LayerNorm, zero pad to window multiples, on odd
  blocks a cyclic shift with the longitude-merged -100 mask, attention,
  reverse shift, crop, residual, then a residual MLP;
- EarthAttention3D: windows batched as [B*nLon, nPl*nLat, N, C]; the
  position bias is per window type (pressure x latitude position, shared
  across longitude), expanded from its table ONCE per rollout
  (`PanguWeather.precompute`) into the key-major [tow, nh, Nk, Nq].

Attention routes, in the JAX order with "on the TPU" read as "on a CUDA
device, or in a program being exported" (`utils.device.on_card`): the 5D
route (the qkv Dense on the padded field, the kernel
reading each window in place: `use_flash_attention: "packed5d"`, or
None / "packed" on the card when N < 1024, hd % 8 == 0 and
B*nLon*nW >= 64), the token-major route on partitioned windows ("packed",
or None on the card under the same test), flash (True, or None for
N >= 1024) and einsum.  The first two go through the hand-written CUDA
kernels of `ops/window_attention.py`, flash through those of
`ops/flash_attention.py`; on the CPU each takes its plain version.

The forward roll is the self-consistent (-shift_pl, -shift_lat,
-shift_lon); `reference_roll_quirk=True` rolls longitude by shift_lat as
the reference does (`panguweather.py:292`).  Submodules and parameters
carry the flax auto-names of the JAX model, so `weights.load_flax_params`
maps a flax tree onto them name for name.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fourcastnet import Mlp, init_like_flax_
from dlwpbench_tpu_torch.ops.flash_attention import flash_window_attention
from dlwpbench_tpu_torch.ops.window_attention import (
    partition_windows_5d, reverse_windows_5d, window_attention_qkv, window_attention_qkv5d,
)
from dlwpbench_tpu_torch.utils.device import device_constant, on_card


# ---------------------------------------------------------------- static helpers (numpy)
@functools.lru_cache(maxsize=None)
def earth_position_index(window_size: tuple[int, int, int]) -> np.ndarray:
    """[N, N] index into the earth-position bias table
    (`utils/earth_position_index.py:4-45`)."""
    wpl, wlat, wlon = window_size
    zi = np.arange(wpl)
    zj = -np.arange(wpl) * wpl
    hi = np.arange(wlat)
    hj = -np.arange(wlat) * wlat
    w = np.arange(wlon)
    c1 = np.stack(np.meshgrid(zi, hi, w, indexing="ij")).reshape(3, -1)
    c2 = np.stack(np.meshgrid(zj, hj, w, indexing="ij")).reshape(3, -1)
    coords = (c1[:, :, None] - c2[:, None, :]).transpose(1, 2, 0)
    coords[:, :, 2] += wlon - 1
    coords[:, :, 1] *= 2 * wlon - 1
    coords[:, :, 0] *= (2 * wlon - 1) * wlat * wlat
    return coords.sum(-1)


def _pad3d_amounts(res, win):
    """[(pl_front, pl_back), (lat_top, lat_bottom), (lon_left, lon_right)]
    zero padding to window multiples."""
    out = []
    for r, w in zip(res, win):
        p = (w - r % w) % w
        out.append((p // 2, p - p // 2))
    return out


def window_partition_3d(x: torch.Tensor, win) -> torch.Tensor:
    """[B, Pl, Lat, Lon, C] -> [B*nLon, nPl*nLat, wpl*wlat*wlon, C]"""
    wins = partition_windows_5d(x, win)
    return wins.reshape(-1, *wins.shape[2:])


def window_reverse_3d(win_x: torch.Tensor, win, Pl: int, Lat: int, Lon: int) -> torch.Tensor:
    """[B*nLon, nW, N, C] -> [B, Pl, Lat, Lon, C]"""
    nLon = Lon // win[2]
    return reverse_windows_5d(win_x.reshape(-1, nLon, *win_x.shape[1:]), win, Pl, Lat, Lon)


@functools.lru_cache(maxsize=None)
def shift_window_groups_3d(pad_resolution, window_size, shift_size) -> np.ndarray:
    """Region group id per window token, [nLon, nW, N], longitude halves
    merged (reference `utils/shift_window_mask.py:40-73`)."""
    Pl, Lat, Lon = pad_resolution
    wpl, wlat, wlon = window_size
    spl, slat, slon = shift_size
    img = np.zeros((1, Pl, Lat, Lon + slon, 1))
    cnt = 0
    for pl in (slice(0, -wpl), slice(-wpl, -spl), slice(-spl, None)):
        for lat in (slice(0, -wlat), slice(-wlat, -slat), slice(-slat, None)):
            for lon in (slice(0, -wlon), slice(-wlon, -slon), slice(-slon, None)):
                img[:, pl, lat, lon, :] = cnt
                cnt += 1
    img = img[:, :, :, :Lon, :]
    x = img.reshape(1, Pl // wpl, wpl, Lat // wlat, wlat, Lon // wlon, wlon, 1)
    return x.transpose(0, 5, 1, 3, 2, 4, 6, 7).reshape(
        Lon // wlon, (Pl // wpl) * (Lat // wlat), wpl * wlat * wlon
    ).astype(np.float32)


def shift_window_mask(pad_resolution, window_size, shift_size) -> np.ndarray:
    """[nLon, nW, N, N] of {0, -100}: the numpy oracle of the mask the
    blocks build on the device from `shift_window_groups_3d`."""
    x = shift_window_groups_3d(pad_resolution, window_size, shift_size)
    diff = x[:, :, None, :] - x[:, :, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def expand_earth_bias(table: torch.Tensor, window_size) -> torch.Tensor:
    """[(wpl^2*wlat^2*(2wlon-1)), tow, nh] table -> [tow, nh, Nk, Nq], the
    key-major layout of the window-attention kernels."""
    wpl, wlat, wlon = window_size
    N = wpl * wlat * wlon
    idx = device_constant(earth_position_index, tuple(window_size), device=table.device)
    tow, nh = table.shape[1], table.shape[2]
    return table[idx.reshape(-1)].reshape(N, N, tow, nh).permute(2, 3, 1, 0).contiguous()


def _check_route(use_flash):
    if use_flash not in (None, True, False, "packed", "packed5d"):
        raise ValueError(
            f"use_flash_attention={use_flash!r}: take None, True, False, 'packed' or 'packed5d'"
        )


# ---------------------------------------------------------------- modules
class EarthAttention3D(nn.Module):
    """Earth-specific window attention on a PRECOMPUTED key-major bias
    [tow, nh, Nk, Nq].  Takes the padded 5D field [B, Pl, Lat, Lon, C] (the
    5D route) or partitioned windows [B*nLon, nW, N, C]."""

    def __init__(self, dim: int, window_size, num_heads: int, use_flash: Any = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nh = self.num_heads
        if x.ndim == 5:
            out = window_attention_qkv5d(self.Dense_0(x), bias, mask, nh, self.window_size)
            return self.Dense_1(out)

        B_, nW, N, C = x.shape
        hd = C // nh
        qkv = self.Dense_0(x)
        uf = self.use_flash
        if uf == "packed" or (uf is None and on_card(x) and N < 1024 and hd % 8 == 0
                              and B_ * nW >= 64):
            L = 1 if mask is None else mask.shape[0]
            out = window_attention_qkv(qkv.reshape(B_ // L, L, nW, N, 3 * C), bias, mask, nh)
            return self.Dense_1(out.reshape(B_, nW, N, C))

        qkv = qkv.reshape(B_, nW, N, 3, nh, hd).permute(3, 0, 4, 1, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B_, nh, nW, N, hd]
        if (uf is True or (uf is None and N >= 1024)) and hd % 8 == 0:
            # batch layout b = ((sample * nLon) + lon) * nW + w, so the bias
            # group is b % G with G = (nLon if masked else 1) * nW
            q, k, v = (t.transpose(1, 2).reshape(B_ * nW, nh, N, hd).contiguous()
                       for t in (q, k, v))
            gb = bias.transpose(-1, -2)  # key-major -> [nW, nh, Nq, Nk]
            if mask is not None:
                gb = (gb[None] + mask[:, :, None]).reshape(-1, nh, N, N)
            out = flash_window_attention(q, k, v, gb.contiguous())
            out = out.reshape(B_, nW, nh, N, hd).transpose(1, 2)
        else:
            attn = torch.einsum("bhwnd,bhwmd->bhwnm", q * hd**-0.5, k)
            attn = attn + bias.permute(1, 0, 3, 2)[None]
            if mask is not None:
                nLon = mask.shape[0]
                attn = attn.reshape(B_ // nLon, nLon, nh, nW, N, N) + mask[None, :, None]
                attn = attn.reshape(B_, nh, nW, N, N)
            out = torch.einsum("bhwnm,bhwmd->bhwnd", attn.softmax(dim=-1), v)
        return self.Dense_1(out.permute(0, 2, 3, 1, 4).reshape(B_, nW, N, C))


class EarthSpecificBlock(nn.Module):
    def __init__(self, dim: int, input_resolution, num_heads: int,
                 window_size=(2, 6, 12), shift: bool = False, mlp_ratio: float = 4.0,
                 reference_roll_quirk: bool = False, use_flash: Any = None,
                 exact_gelu: bool = False):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.shift = shift
        self.reference_roll_quirk = reference_roll_quirk
        self.use_flash = use_flash
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.EarthAttention3D_0 = EarthAttention3D(dim, window_size, num_heads,
                                                   use_flash=use_flash)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, approximate=not exact_gelu)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        Pl, Lat, Lon = self.input_resolution
        B, L, C = x.shape
        win = self.window_size
        pads = _pad3d_amounts(self.input_resolution, win)
        pad_res = tuple(r + lo + hi for r, (lo, hi) in zip(self.input_resolution, pads))
        shift_size = tuple(w // 2 for w in win)

        shortcut = x
        x = self.LayerNorm_0(x).reshape(B, Pl, Lat, Lon, C)
        # padded tokens carry the Dense bias as q, k, v and are attended to
        x = F.pad(x, (0, 0, *pads[2], *pads[1], *pads[0]))

        mask = None
        if self.shift:
            spl, slat, slon = shift_size
            fwd_lon = slat if self.reference_roll_quirk else slon
            x = torch.roll(x, (-spl, -slat, -fwd_lon), dims=(1, 2, 3))
            # the [nLon, nW, N, N] mask is built on the device, in the
            # activation's dtype
            groups = device_constant(shift_window_groups_3d, pad_res, win, shift_size,
                                     device=x.device)
            mask = torch.where(groups[:, :, None, :] != groups[:, :, :, None],
                               -100.0, 0.0).to(x.dtype)

        N = win[0] * win[1] * win[2]
        nW_all = (pad_res[0] // win[0]) * (pad_res[1] // win[1])
        B_win = B * (pad_res[2] // win[2])
        uf = self.use_flash
        use5d = uf == "packed5d" or (
            uf in (None, "packed") and on_card(x) and N < 1024
            and (C // self.num_heads) % 8 == 0 and B_win * nW_all >= 64
        )
        if use5d:
            x = self.EarthAttention3D_0(x, bias, mask)
        else:
            wins = self.EarthAttention3D_0(window_partition_3d(x, win), bias, mask)
            x = window_reverse_3d(wins, win, *pad_res)

        if self.shift:
            x = torch.roll(x, shift_size, dims=(1, 2, 3))
        x = x[:, pads[0][0]:pads[0][0] + Pl, pads[1][0]:pads[1][0] + Lat,
              pads[2][0]:pads[2][0] + Lon].reshape(B, L, C)
        x = shortcut + x
        return x + self.Mlp_0(self.LayerNorm_1(x))


class DownSample(nn.Module):
    """2x2 lat/lon token merge: pad -> gather -> LayerNorm -> Linear 4C->2C."""

    def __init__(self, dim: int, in_res):
        super().__init__()
        self.in_res = tuple(in_res)
        self.LayerNorm_0 = nn.LayerNorm(4 * dim, eps=1e-5)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        Pl, Lat, Lon = self.in_res
        out_lat, out_lon = (Lat + 1) // 2, (Lon + 1) // 2
        x = F.pad(x.reshape(B, Pl, Lat, Lon, C),
                  (0, 0, 0, out_lon * 2 - Lon, 0, out_lat * 2 - Lat))
        x = x.reshape(B, Pl, out_lat, 2, out_lon, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
        return self.Dense_0(self.LayerNorm_0(x.reshape(B, Pl * out_lat * out_lon, 4 * C)))


class UpSample(nn.Module):
    """Linear C->4C', pixel shuffle 2x, crop to the target, LayerNorm, Linear."""

    def __init__(self, in_dim: int, out_dim: int, in_res, out_res):
        super().__init__()
        self.out_dim = out_dim
        self.in_res, self.out_res = tuple(in_res), tuple(out_res)
        self.Dense_0 = nn.Linear(in_dim, 4 * out_dim, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(out_dim, eps=1e-5)
        self.Dense_1 = nn.Linear(out_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        Pl, in_lat, in_lon = self.in_res
        _, out_lat, out_lon = self.out_res
        D = self.out_dim
        x = self.Dense_0(x).reshape(B, Pl, in_lat, in_lon, 2, 2, D)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, Pl, in_lat * 2, in_lon * 2, D)
        t, l = (in_lat * 2 - out_lat) // 2, (in_lon * 2 - out_lon) // 2
        x = x[:, :, t:t + out_lat, l:l + out_lon].reshape(B, Pl * out_lat * out_lon, D)
        return self.Dense_1(self.LayerNorm_0(x))


def _nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a 2D (transposed) conv to a channels-last [B, H, W, C] tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PanguWeather(RolloutModel):
    """Reference `PanguWeather` (config `type: PanguWeather`).  The 16
    per-block earth-position bias tables are parameters of the model
    itself (`earth_position_bias_table_{b}`), expanded once per rollout by
    `precompute`.  `seed` seeds the random init; weights from the JAX model
    come in through `weights.load_flax_params`."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        embed_dim: int = 192,
        num_heads: Sequence[int] = (6, 12, 12, 6),
        window_size: Sequence[int] = (2, 6, 12),
        patch_size: Sequence[int] = (4, 4),
        n_lat: int = 32,
        n_lon: int = 64,
        context_size: int = 1,
        reference_roll_quirk: bool = False,
        use_flash_attention: Any = None,
        exact_gelu: bool = False,
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
        spmd_mesh: Any = None,
    ):
        super().__init__(context_size, remat, remat_policy)
        if spmd_mesh is not None:
            raise NotImplementedError(
                "ring attention over a mesh (spmd_mesh) is not ported to PyTorch yet "
                "(ROADMAP queue A, item 16)"
            )
        _check_route(use_flash_attention)
        self.embed_dim = D = int(embed_dim)
        self.num_heads = [int(h) for h in num_heads]
        self.window_size = tuple(int(w) for w in window_size)
        self.patch_size = tuple(int(p) for p in patch_size)
        self.n_lat, self.n_lon = int(n_lat), int(n_lon)
        self.prognostic_channels = int(prognostic_channels)
        ph, pw = self.patch_size
        wpl, wlat, wlon = self.window_size

        cin = int(constant_channels) + context_size * (
            int(prescribed_channels) + self.prognostic_channels
        )
        self.Conv_0 = nn.Conv2d(cin, D, (ph, pw), stride=(ph, pw))
        plan = self._block_plan()
        self.n_blocks = len(plan)
        for b, blk in enumerate(plan):
            table = torch.zeros((wpl**2) * (wlat**2) * (2 * wlon - 1), blk["tow"], blk["heads"])
            setattr(self, f"earth_position_bias_table_{b}", nn.Parameter(table))
            setattr(self, f"EarthSpecificBlock_{b}", EarthSpecificBlock(
                blk["dim"], blk["res"], blk["heads"], self.window_size, shift=blk["shift"],
                reference_roll_quirk=bool(reference_roll_quirk),
                use_flash=use_flash_attention, exact_gelu=bool(exact_gelu),
            ))
        res1, res2 = plan[0]["res"], plan[2]["res"]
        self.DownSample_0 = DownSample(D, res1)
        self.UpSample_0 = UpSample(2 * D, D, res2, res1)
        self.ConvTranspose_0 = nn.ConvTranspose2d(2 * D, self.prognostic_channels, (ph, pw),
                                                  stride=(ph, pw))
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def _block_plan(self):
        """Static per-block geometry for the 2-6-6-2 layer plan."""
        ph, pw = self.patch_size
        Lat, Lon = -(-self.n_lat // ph), -(-self.n_lon // pw)
        res1 = (1, Lat, Lon)
        res2 = (1, (Lat + 1) // 2, (Lon + 1) // 2)
        win = self.window_size
        D = self.embed_dim
        plan = []
        for res, dim, depth, heads in ((res1, D, 2, self.num_heads[0]),
                                       (res2, 2 * D, 6, self.num_heads[1]),
                                       (res2, 2 * D, 6, self.num_heads[2]),
                                       (res1, D, 2, self.num_heads[3])):
            pads = _pad3d_amounts(res, win)
            pad_res = tuple(r + lo + hi for r, (lo, hi) in zip(res, pads))
            tow = (pad_res[0] // win[0]) * (pad_res[1] // win[1])
            for i in range(depth):
                plan.append(dict(res=res, dim=dim, pad_res=pad_res, tow=tow, heads=heads,
                                 shift=i % 2 == 1))
        return plan

    def precompute(self) -> list[torch.Tensor]:
        """Every block's key-major bias [tow, nh, Nk, Nq], once per rollout."""
        return [expand_earth_bias(getattr(self, f"earth_position_bias_table_{b}"),
                                  self.window_size) for b in range(self.n_blocks)]

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        if aux is None:
            aux = self.precompute()
        B, H, W, _ = x.shape
        ph, pw = self.patch_size
        D = self.embed_dim

        # PatchEmbed2D: symmetric zero pad to a patch multiple, conv k=s=p
        pad_h, pad_w = (ph - H % ph) % ph, (pw - W % pw) % pw
        x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        x = _nchw(self.Conv_0, x)
        Lat, Lon = x.shape[1], x.shape[2]
        x = x.reshape(B, Lat * Lon, D)

        def blocks(x, lo, hi):
            for b in range(lo, hi):
                x = getattr(self, f"EarthSpecificBlock_{b}")(x, aux[b])
            return x

        x = blocks(x, 0, 2)
        skip = x
        x = blocks(self.DownSample_0(x), 2, 14)
        x = blocks(self.UpSample_0(x), 14, 16)

        out = torch.cat([x, skip], dim=-1).reshape(B, Lat, Lon, 2 * D)
        # PatchRecovery2D: ConvTranspose k=s=patch, then a center crop
        out = _nchw(self.ConvTranspose_0, out)
        t, l = (out.shape[1] - H) // 2, (out.shape[2] - W) // 2
        return out[:, t:t + H, l:l + W], state
