"""Plain reference of Pangu-Weather's 2D surface variant
(`configs/model/panguweather.yaml`; Bi et al., arXiv:2211.02556): patch
embedding, a 2-6-6-2 plan of earth-specific 3D window-attention blocks
(pressure level x latitude x longitude windows, zero padding to window
multiples, a bias per window type expanded from a learned table, on odd
blocks a cyclic shift with the -100 region mask merged across the
longitude seam), 2x2 down- and up-sampling, a skip and a transposed-conv
patch recovery.  Parameter names follow the program's flax-style names.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import Mlp, Rollout, attention, nchw


def position_index(win) -> np.ndarray:
    """[N, N] index of each (query, key) pair into a block's bias table."""
    wpl, wlat, wlon = win
    c1 = np.stack(np.meshgrid(np.arange(wpl), np.arange(wlat), np.arange(wlon), indexing="ij"))
    c2 = np.stack(np.meshgrid(-np.arange(wpl) * wpl, -np.arange(wlat) * wlat, np.arange(wlon),
                              indexing="ij"))
    c = c1.reshape(3, -1)[:, :, None] - c2.reshape(3, -1)[:, None, :]
    return ((c[0] * (2 * wlon - 1) * wlat * wlat) + (c[1] * (2 * wlon - 1))
            + (c[2] + wlon - 1))


def pads(res, win):
    """[(before, after)] zero padding of each of (Pl, Lat, Lon) to a window multiple."""
    out = []
    for r, w in zip(res, win):
        p = (w - r % w) % w
        out.append((p // 2, p - p // 2))
    return out


def partition(x, win):
    """[B, Pl, Lat, Lon, C] -> [B, nLon, nPl*nLat, N, C]."""
    B, Pl, Lat, Lon, C = x.shape
    a, b, c = win
    x = x.reshape(B, Pl // a, a, Lat // b, b, Lon // c, c, C).permute(0, 5, 1, 3, 2, 4, 6, 7)
    return x.reshape(B, Lon // c, (Pl // a) * (Lat // b), a * b * c, C)


def unpartition(x, win, Pl, Lat, Lon):
    a, b, c = win
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, Lon // c, Pl // a, Lat // b, a, b, c, C).permute(0, 2, 4, 3, 5, 1, 6, 7)
    return x.reshape(B, Pl, Lat, Lon, C)


def shift_groups(pad_res, win, shift) -> np.ndarray:
    """[nLon, nW, N] region id of every window token under the shift, the
    two longitude ends one region."""
    Pl, Lat, Lon = pad_res
    a, b, c = win
    sa, sb, sc = shift
    img = np.zeros((Pl, Lat, Lon + sc))
    cnt = 0
    for pl in (slice(0, -a), slice(-a, -sa), slice(-sa, None)):
        for lat in (slice(0, -b), slice(-b, -sb), slice(-sb, None)):
            for lon in (slice(0, -c), slice(-c, -sc), slice(-sc, None)):
                img[pl, lat, lon] = cnt
                cnt += 1
    img = img[:, :, :Lon]
    x = img.reshape(Pl // a, a, Lat // b, b, Lon // c, c).transpose(4, 0, 2, 1, 3, 5)
    return x.reshape(Lon // c, (Pl // a) * (Lat // b), a * b * c).astype(np.float32)


class EarthAttention3D(nn.Module):
    def __init__(self, dim, num_heads, owner: Rollout):
        super().__init__()
        self.num_heads = num_heads
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self._owner = [owner]

    def forward(self, x, bias, mask):
        """x [B, nLon, nW, N, C]; bias [nW, nh, N, N] query-major; mask
        [nLon, nW, N, N] or None."""
        B, L, nW, N, C = x.shape
        nh = self.num_heads
        qkv = self.Dense_0(x).reshape(B, L, nW, N, 3, nh, C // nh).permute(4, 0, 1, 5, 2, 3, 6)
        add = bias.transpose(0, 1)  # [nh, nW, N, N]
        if mask is not None:
            add = add + mask[:, None]  # [nLon, nh, nW, N, N]
        out = attention(qkv[0], qkv[1], qkv[2], add, self._owner[0].attention_calls,
                        bias_numel=bias.numel(),
                        mask_numel=0 if mask is None else mask.numel())
        return self.Dense_1(out.permute(0, 1, 3, 4, 2, 5).reshape(B, L, nW, N, C))


class EarthSpecificBlock(nn.Module):
    def __init__(self, dim, res, num_heads, win, shift, mlp_ratio, owner):
        super().__init__()
        self.res, self.win, self.shift = tuple(res), tuple(win), bool(shift)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.EarthAttention3D_0 = EarthAttention3D(dim, num_heads, owner)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, bias):
        Pl, Lat, Lon = self.res
        B, L, C = x.shape
        pd = pads(self.res, self.win)
        pad_res = tuple(r + lo + hi for r, (lo, hi) in zip(self.res, pd))
        shift = tuple(w // 2 for w in self.win)
        shortcut = x
        x = self.LayerNorm_0(x).reshape(B, Pl, Lat, Lon, C)
        x = F.pad(x, (0, 0, *pd[2], *pd[1], *pd[0]))
        mask = None
        if self.shift:
            x = torch.roll(x, tuple(-s for s in shift), dims=(1, 2, 3))
            g = torch.from_numpy(shift_groups(pad_res, self.win, shift)).to(x.device)
            mask = torch.where(g[:, :, None, :] != g[:, :, :, None], -100.0, 0.0).to(x.dtype)
        x = unpartition(self.EarthAttention3D_0(partition(x, self.win), bias, mask),
                        self.win, *pad_res)
        if self.shift:
            x = torch.roll(x, shift, dims=(1, 2, 3))
        x = x[:, pd[0][0]:pd[0][0] + Pl, pd[1][0]:pd[1][0] + Lat,
              pd[2][0]:pd[2][0] + Lon].reshape(B, L, C)
        x = shortcut + x
        return x + self.Mlp_0(self.LayerNorm_1(x))


class DownSample(nn.Module):
    def __init__(self, dim, res):
        super().__init__()
        self.res = tuple(res)
        self.LayerNorm_0 = nn.LayerNorm(4 * dim, eps=1e-5)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, _, C = x.shape
        Pl, Lat, Lon = self.res
        h, w = (Lat + 1) // 2, (Lon + 1) // 2
        x = F.pad(x.reshape(B, Pl, Lat, Lon, C), (0, 0, 0, 2 * w - Lon, 0, 2 * h - Lat))
        x = x.reshape(B, Pl, h, 2, w, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
        return self.Dense_0(self.LayerNorm_0(x.reshape(B, Pl * h * w, 4 * C)))


class UpSample(nn.Module):
    def __init__(self, in_dim, out_dim, in_res, out_res):
        super().__init__()
        self.out_dim, self.in_res, self.out_res = out_dim, tuple(in_res), tuple(out_res)
        self.Dense_0 = nn.Linear(in_dim, 4 * out_dim, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(out_dim, eps=1e-5)
        self.Dense_1 = nn.Linear(out_dim, out_dim, bias=False)

    def forward(self, x):
        B = x.shape[0]
        Pl, h, w = self.in_res
        _, H, W = self.out_res
        D = self.out_dim
        x = self.Dense_0(x).reshape(B, Pl, h, w, 2, 2, D).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(B, Pl, 2 * h, 2 * w, D)
        t, l = (2 * h - H) // 2, (2 * w - W) // 2
        x = x[:, :, t:t + H, l:l + W].reshape(B, Pl * H * W, D)
        return self.Dense_1(self.LayerNorm_0(x))


class PanguReference(Rollout):
    def __init__(self, constant_channels=4, prescribed_channels=0, prognostic_channels=1,
                 embed_dim=192, num_heads: Sequence[int] = (6, 12, 12, 6),
                 window_size: Sequence[int] = (2, 6, 12), patch_size: Sequence[int] = (4, 4),
                 n_lat=32, n_lon=64, context_size=1, mlp_ratio=4.0, **_):
        super().__init__(context_size)
        D = self.D = int(embed_dim)
        self.win = tuple(int(w) for w in window_size)
        self.patch = ph, pw = tuple(int(p) for p in patch_size)
        cin = int(constant_channels) + context_size * (int(prescribed_channels)
                                                       + int(prognostic_channels))
        self.Conv_0 = nn.Conv2d(cin, D, (ph, pw), stride=(ph, pw))
        Lat, Lon = -(-int(n_lat) // ph), -(-int(n_lon) // pw)
        res1, res2 = (1, Lat, Lon), (1, (Lat + 1) // 2, (Lon + 1) // 2)
        a, b, c = self.win
        b_ = 0
        for res, dim, depth, heads in ((res1, D, 2, num_heads[0]), (res2, 2 * D, 6, num_heads[1]),
                                       (res2, 2 * D, 6, num_heads[2]), (res1, D, 2, num_heads[3])):
            pad_res = [r + lo + hi for r, (lo, hi) in zip(res, pads(res, self.win))]
            tow = (pad_res[0] // a) * (pad_res[1] // b)
            for i in range(depth):
                setattr(self, f"earth_position_bias_table_{b_}",
                        nn.Parameter(torch.zeros(a * a * b * b * (2 * c - 1), tow, int(heads))))
                setattr(self, f"EarthSpecificBlock_{b_}", EarthSpecificBlock(
                    dim, res, int(heads), self.win, i % 2 == 1, mlp_ratio, self))
                b_ += 1
        self.n_blocks = b_
        self.DownSample_0 = DownSample(D, res1)
        self.UpSample_0 = UpSample(2 * D, D, res2, res1)
        self.ConvTranspose_0 = nn.ConvTranspose2d(2 * D, int(prognostic_channels), (ph, pw),
                                                  stride=(ph, pw))

    def precompute(self):
        """Each block's query-major bias [nW, nh, N, N]."""
        idx = torch.from_numpy(position_index(self.win).reshape(-1))
        out = []
        for b in range(self.n_blocks):
            t = getattr(self, f"earth_position_bias_table_{b}")
            N = int(np.prod(self.win))
            out.append(t[idx.to(t.device)].reshape(N, N, t.shape[1], t.shape[2])
                       .permute(2, 3, 0, 1))
        return out

    def step(self, x, aux):
        B, H, W, _ = x.shape
        ph, pw = self.patch
        D = self.D
        pad_h, pad_w = (ph - H % ph) % ph, (pw - W % pw) % pw
        x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        x = nchw(self.Conv_0, x)
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
        out = nchw(self.ConvTranspose_0, torch.cat([x, skip], dim=-1).reshape(B, Lat, Lon, 2 * D))
        t, l = (out.shape[1] - H) // 2, (out.shape[2] - W) // 2
        return out[:, t:t + H, l:l + W]


Reference = PanguReference
