"""Plain reference of the Swin Transformer on the equirectangular grid
(`configs/model/swintransformer.yaml`; dlwp-benchmark's Swin, arXiv:2103.14030
blocks): patch-embedding conv, stages of pre-norm window attention with a
relative-position bias and, on odd blocks, a cyclic shift with the -100
region mask, tanh-GELU MLPs, 2x2 patch merging, a transposed-conv decoder
with skips and a 1x1 head.  Global windows (the whole stage) unless
`window_size` is given.  Parameter names follow the program's flax-style
names, so one drawn weight set loads into both.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import Mlp, Rollout, attention, nchw


def shift_groups(Hp: int, Wp: int, wh: int, ww: int, sh: int, sw: int) -> np.ndarray:
    """[nW, N] region id of every window token under a (sh, sw) shift;
    tokens of different regions mask each other."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    rows = (slice(0, -wh), slice(-wh, -sh if sh else None), slice(-sh, None) if sh else slice(0, 0))
    cols = (slice(0, -ww), slice(-ww, -sw if sw else None), slice(-sw, None) if sw else slice(0, 0))
    for hs in rows:
        for ws in cols:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // wh, wh, Wp // ww, ww).transpose(0, 2, 1, 3)
    return win.reshape(-1, wh * ww).astype(np.float32)


def relative_bias(table: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """[(2wh-1)(2ww-1), nh] table -> [nh, N, N], bias[h, i, j] =
    table[(yi - yj + wh - 1) * (2ww - 1) + xi - xj + ww - 1, h]."""
    y, x = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    idx = (y[:, None] - y[None, :] + wh - 1) * (2 * ww - 1) + (x[:, None] - x[None, :] + ww - 1)
    return table[idx.to(table.device)].permute(2, 0, 1)


def partition(x, wh, ww):
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def unpartition(win, wh, ww, H, W):
    C = win.shape[-1]
    B = win.shape[0] // (H * W // wh // ww)
    x = win.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, owner: Rollout):
        super().__init__()
        self.num_heads = num_heads
        self.Dense_0 = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.Dense_1 = nn.Linear(dim, dim)
        self._owner = [owner]  # a list, so the rollout is no submodule

    def forward(self, x, bias):
        """x [B*nW, N, C]; bias [nW, nh, N, N], window w = b % nW."""
        B_, N, C = x.shape
        nh, G = self.num_heads, bias.shape[0]
        qkv = self.Dense_0(x).reshape(B_ // G, G, N, 3, nh, C // nh).permute(3, 0, 1, 4, 2, 5)
        out = attention(qkv[0], qkv[1], qkv[2], bias, self._owner[0].attention_calls,
                        bias_numel=bias.numel())
        return self.Dense_1(out.permute(0, 1, 3, 2, 4).reshape(B_, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window, shift, mlp_ratio, qkv_bias, owner):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.WindowAttention_0 = WindowAttention(dim, num_heads, qkv_bias, owner)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, H, W, bias):
        B, _, C = x.shape
        wh, ww = self.window
        sh, sw = self.shift
        shortcut = x
        x = self.LayerNorm_0(x).reshape(B, H, W, C)
        pad_b, pad_r = (wh - H % wh) % wh, (ww - W % ww) % ww
        if pad_r:  # circular in longitude
            x = torch.cat([x, x[:, :, :pad_r]], dim=2)
        if pad_b:
            x = F.pad(x, (0, 0, 0, 0, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        x = unpartition(self.WindowAttention_0(partition(x, wh, ww), bias), wh, ww, Hp, Wp)
        if sh or sw:
            x = torch.roll(x, (sh, sw), dims=(1, 2))
        x = shortcut + x[:, :H, :W].reshape(B, H * W, C)
        return x + self.Mlp_0(self.LayerNorm_1(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(4 * dim, eps=1e-5)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(B, -1, 4 * C)
        return self.Dense_0(self.LayerNorm_0(x))


class SwinReference(Rollout):
    def __init__(self, img_height=32, img_width=64, patch_size=1, constant_channels=4,
                 prescribed_channels=0, prognostic_channels=1, embed_dim=96,
                 depths: Sequence[int] = (4, 4), num_heads: Sequence[int] = (4, 4),
                 mlp_ratio=4.0, qkv_bias=True, ape=False, patch_norm=True, context_size=1,
                 window_size: Optional[Sequence[int]] = None, **_):
        super().__init__(context_size)
        p, E = int(patch_size), int(embed_dim)
        self.p, self.E = p, E
        self.depths = [int(d) for d in depths]
        self.patch_norm, self.ape = bool(patch_norm), bool(ape)
        cin = int(constant_channels) + context_size * (int(prescribed_channels)
                                                       + int(prognostic_channels))
        self.Conv_0 = nn.Conv2d(cin, E, p, stride=p)
        if self.patch_norm:
            self.LayerNorm_0 = nn.LayerNorm(E, eps=1e-5)
        H, W = -(-int(img_height) // p), -(-int(img_width) // p)
        if self.ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, H, W, E))
        self.plan = []
        res_h, res_w = H, W
        blk = 0
        n = len(self.depths)
        for i in range(n):
            wh, ww = (res_h, res_w) if window_size is None else (
                min(int(window_size[0]), res_h), min(int(window_size[1]), res_w))
            st = dict(H=H, W=W, Hp=H + (wh - H % wh) % wh, Wp=W + (ww - W % ww) % ww,
                      wh=wh, ww=ww, shift=(wh // 2, ww // 2))
            self.plan.append(st)
            dim, heads = E * 2**i, int(num_heads[i])
            for d in range(self.depths[i]):
                shift = (0, 0) if d % 2 == 0 else st["shift"]
                setattr(self, f"SwinBlock_{blk}", SwinBlock(dim, heads, (wh, ww), shift,
                                                            mlp_ratio, qkv_bias, self))
                setattr(self, f"relative_position_bias_table_{i}_{d}",
                        nn.Parameter(torch.zeros((2 * wh - 1) * (2 * ww - 1), heads)))
                blk += 1
            setattr(self, f"LayerNorm_{i + int(self.patch_norm)}", nn.LayerNorm(dim, eps=1e-5))
            if i < n - 1:
                setattr(self, f"PatchMerging_{i}", PatchMerging(dim))
                H, W = (H + 1) // 2, (W + 1) // 2
                res_h, res_w = res_h // 2, res_w // 2
        for idx, i in enumerate(reversed(range(n))):
            ch = E * 2**i
            k = p if i == 0 else 2
            setattr(self, f"ConvTranspose_{idx}", nn.ConvTranspose2d(
                ch if idx == 0 else 2 * ch, ch if i == 0 else ch // 2, k, stride=k))
        self.Conv_1 = nn.Conv2d(E, int(prognostic_channels), 1)

    def precompute(self):
        aux = []
        for i, st in enumerate(self.plan):
            wh, ww = st["wh"], st["ww"]
            for d in range(self.depths[i]):
                rel = relative_bias(getattr(self, f"relative_position_bias_table_{i}_{d}"), wh, ww)
                sh, sw = (0, 0) if d % 2 == 0 else st["shift"]
                if sh or sw:
                    g = torch.from_numpy(shift_groups(st["Hp"], st["Wp"], wh, ww, sh, sw))
                    g = g.to(rel.device)
                    mask = torch.where(g[:, None, :] != g[:, :, None], -100.0, 0.0)
                    aux.append(rel[None] + mask[:, None].to(rel.dtype))
                else:
                    aux.append(rel[None])
        return aux

    def step(self, x, aux):
        B, H0, W0, _ = x.shape
        p, E = self.p, self.E
        if W0 % p:
            x = torch.cat([x, x[:, :, :p - W0 % p]], dim=2)
        if H0 % p:
            x = F.pad(x, (0, 0, 0, 0, 0, p - H0 % p))
        x = nchw(self.Conv_0, x)
        x = x.reshape(B, -1, E)
        if self.patch_norm:
            x = self.LayerNorm_0(x)
        if self.ape:
            x = x + self.absolute_pos_embed.reshape(1, -1, E)
        feats, blk = [], 0
        n = len(self.depths)
        for i, st in enumerate(self.plan):
            H, W = st["H"], st["W"]
            for _ in range(self.depths[i]):
                x = getattr(self, f"SwinBlock_{blk}")(x, H, W, aux[blk])
                blk += 1
            feats.append(getattr(self, f"LayerNorm_{i + int(self.patch_norm)}")(x)
                         .reshape(B, H, W, E * 2**i))
            if i < n - 1:
                x = getattr(self, f"PatchMerging_{i}")(x, H, W)
        y = None
        for idx, f in enumerate(reversed(feats)):
            x_in = f if idx == 0 else torch.cat([f, y], dim=-1)
            y = F.gelu(nchw(getattr(self, f"ConvTranspose_{idx}"), x_in), approximate="tanh")
        return nchw(self.Conv_1, y)[:, :H0, :W0]


Reference = SwinReference
