"""Swin Transformer on the equirectangular grid and on HEALPix (counterpart
of `dlwpbench_tpu/models/swin.py:41-499`).

- WindowAttention: fused qkv Dense, heads of dim C/nh, a bias per block
  PRECOMPUTED once per rollout (relative-position bias expanded from its
  table, plus the -100 shift mask on shifted blocks), output Dense.  Three
  routes, chosen as the JAX package chooses them with "on the TPU" read
  as "on a CUDA device, or in a program being exported"
  (`utils.device.on_card`): the token-major route (`use_flash_attention:
  "packed"`, or auto on the card for many small windows) through the
  hand-written CUDA kernels of `ops/window_attention.py`; the flash route
  (`true`, or auto for N >= 1024) through those of
  `ops/flash_attention.py` (both differentiable: forward and fused
  backward); otherwise plain einsum attention.
- SwinBlock: pre-norm attention with cyclic shift (-sh, -sw) before and
  (sh, sw) after, then a tanh-GELU MLP, both residual.  A stage whose
  resolution is no window multiple is padded circularly on the right
  (longitude) on the equirectangular mesh and with zeros on HEALPix, and
  with zeros at the bottom.
- PatchMerging between stages (2x2 gather -> LayerNorm -> Linear 4C->2C).
- Windows: global by default (the whole stage resolution, halving at
  each PatchMerging), or fixed local `window_size` clamped to each stage's
  resolution.
- PatchEmbed conv k=s=patch (circular-lon pad), ConvTranspose decoder over
  the per-stage normed features with skip concatenation, 1x1 conv head.
- `SwinTransformerHPX` (`mesh="healpix"`): each step lays the 12 faces
  [B, 12, n, n, C] out as a rectangle of 3 rows x 4 columns of faces
  [B, 3n, 4n, C], runs the same network on it and cuts the faces back out;
  the stage plan (windows, routes) is that of the rectangle.

Submodules and parameters carry the flax auto-names of the JAX model
(`SwinBlock_3.WindowAttention_0.Dense_0`, `ConvTranspose_0`, ...), so
`weights.load_flax_params` maps a flax tree onto them name for name.
Tokens are [B, H*W, C], H-major, channels-last inside the model.

`spmd_mesh` (a `DeviceMesh`, `parallel/launch.py::global_mesh`): every
window attention off the token-major route whose head dim is a multiple
of 8 and whose token count splits over the mesh dim `dist_axis` runs as
ring attention over that dim (`parallel/ring_attention.py`, JAX
`:171-186`), on the flash kernels; the rest of the model runs the same on
every rank.  Meshes other than these two raise.
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
from dlwpbench_tpu_torch.ops.window_attention import window_attention_qkv
from dlwpbench_tpu_torch.parallel import launch
from dlwpbench_tpu_torch.parallel.ring_attention import ring_attention_sharded
from dlwpbench_tpu_torch.utils.device import device_constant, on_card


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, wh*ww, C]"""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(win: torch.Tensor, wh: int, ww: int, H: int, W: int) -> torch.Tensor:
    """[B*nW, wh*ww, C] -> [B, H, W, C]"""
    C = win.shape[-1]
    B = win.shape[0] // (H * W // wh // ww)
    x = win.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def shift_window_groups(Hp: int, Wp: int, wh: int, ww: int, sh: int, sw: int) -> np.ndarray:
    """9-region group id per window token, [nW, N] (reference
    `swin_transformer.py:380-401`); tokens of different groups mask each
    other with -100."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh if sh else None), slice(-sh, None) if sh else slice(0, 0)):
        for ws in (slice(0, -ww), slice(-ww, -sw if sw else None), slice(-sw, None) if sw else slice(0, 0)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // wh, wh, Wp // ww, ww).transpose(0, 2, 1, 3)
    return win.reshape(-1, wh * ww).astype(np.float32)


def expand_relative_bias(table: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """[(2wh-1)*(2ww-1), nh] bias table -> [nh, N, N] by two structured
    gathers: x offsets first, then y offsets."""
    nh = table.shape[-1]
    N = wh * ww
    T = table.reshape(2 * wh - 1, 2 * ww - 1, nh)
    ar = functools.partial(torch.arange, device=table.device)
    dx = ar(ww)[:, None] - ar(ww)[None, :] + ww - 1
    T2 = T[:, dx.reshape(-1)].reshape(2 * wh - 1, ww, ww, nh)
    dy = ar(wh)[:, None] - ar(wh)[None, :] + wh - 1
    B4 = T2[dy.reshape(-1)].reshape(wh, wh, ww, ww, nh)
    return B4.permute(4, 0, 2, 1, 3).reshape(nh, N, N)


class WindowAttention(nn.Module):
    """Window attention on a precomputed bias: [nh, N, N] (shared) or
    [G, nh, N, N] selected as window = b % G.

    `use_flash`: None = auto (token-major kernel on the card or under
    export, `on_card`, when N < 1024, hd % 8 == 0 and B_ >= 64; flash for
    N >= 1024; einsum otherwise), True / False force flash / einsum, "packed" forces the
    token-major route.  With `spmd_mesh`, ring attention over its dim
    `dist_axis` where hd % 8 == 0 and N splits over it (off the
    token-major route)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_flash: Any = None, spmd_mesh: Any = None, dist_axis: str = "x"):
        super().__init__()
        if use_flash not in (None, True, False, "packed"):
            raise ValueError(f"use_flash={use_flash!r}: take None, True, False or 'packed'")
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.spmd_mesh, self.dist_axis = spmd_mesh, dist_axis
        self.Dense_0 = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                n_windows: Optional[int] = None) -> torch.Tensor:
        """x [B_, N, C] with B_ = sample * nW + window; `n_windows` is nW,
        which the token-major route needs when the bias is shared."""
        B_, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv_raw = self.Dense_0(x)
        packed = self.use_flash == "packed" or (
            self.use_flash is None and on_card(x) and N < 1024 and hd % 8 == 0 and B_ >= 64
        )
        if packed:
            # the kernel reads the Dense output as is; the bias arrives
            # query-major and the kernel wants it key-major
            gb = bias if bias.ndim == 4 else bias[None]
            nW = gb.shape[0] if gb.shape[0] > 1 else (n_windows or 1)
            out = window_attention_qkv(
                qkv_raw.reshape(B_ // nW, 1, nW, N, 3 * C),
                gb.transpose(-1, -2).contiguous(), None, nh,
            )
            return self.Dense_1(out.reshape(B_, N, C))
        qkv = qkv_raw.reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B_, nh, N, hd]
        if (self.spmd_mesh is not None and hd % 8 == 0
                and N % launch.axis(self.spmd_mesh, self.dist_axis)[2] == 0):
            out = ring_attention_sharded(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                                         self.spmd_mesh, axis=self.dist_axis)
            return self.Dense_1(out.transpose(1, 2).reshape(B_, N, C))
        flash = self.use_flash is True or (self.use_flash is None and N >= 1024)
        if flash and hd % 8 == 0:
            out = flash_window_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), bias
            )
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm", q * hd**-0.5, k)
            if bias.ndim == 3:
                attn = attn + bias[None]
            else:
                G = bias.shape[0]
                attn = (attn.reshape(B_ // G, G, nh, N, N) + bias[None]).reshape(B_, nh, N, N)
            out = torch.einsum("bhnm,bhmd->bhnd", attn.softmax(dim=-1), v)
        return self.Dense_1(out.transpose(1, 2).reshape(B_, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: tuple[int, int],
                 shift: tuple[int, int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, use_flash: Any = None,
                 exact_gelu: bool = False, mesh: str = "equirectangular",
                 spmd_mesh: Any = None, dist_axis: str = "x"):
        super().__init__()
        self.mesh = mesh
        self.window = tuple(window)
        self.shift = tuple(shift)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.WindowAttention_0 = WindowAttention(dim, num_heads, qkv_bias, use_flash,
                                                 spmd_mesh, dist_axis)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, approximate=not exact_gelu)

    def forward(self, x: torch.Tensor, H: int, W: int, bias: torch.Tensor) -> torch.Tensor:
        # x: [B, H*W, C]; bias: precomputed [nh, N, N] or [nW, nh, N, N]
        B, L, C = x.shape
        wh, ww = self.window
        sh, sw = self.shift
        shortcut = x
        x = self.LayerNorm_0(x).reshape(B, H, W, C)

        # pad to window multiples: circular lon (zero off the lat-lon
        # grid), zero lat
        pad_b = (wh - H % wh) % wh
        pad_r = (ww - W % ww) % ww
        if pad_r and self.mesh == "equirectangular":
            x = torch.cat([x, x[:, :, :pad_r]], dim=2)
        elif pad_r:
            x = F.pad(x, (0, 0, 0, pad_r))
        if pad_b:
            x = F.pad(x, (0, 0, 0, 0, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r

        if sh or sw:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        win = self.WindowAttention_0(window_partition(x, wh, ww), bias,
                                     n_windows=(Hp // wh) * (Wp // ww))
        x = window_reverse(win, wh, ww, Hp, Wp)
        if sh or sw:
            x = torch.roll(x, (sh, sw), dims=(1, 2))
        x = x[:, :H, :W].reshape(B, H * W, C)

        x = shortcut + x
        return x + self.Mlp_0(self.LayerNorm_1(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(4 * dim, eps=1e-5)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
            dim=-1,
        ).reshape(B, -1, 4 * C)
        return self.Dense_0(self.LayerNorm_0(x))


def _nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a 2D (transposed) conv to a channels-last [B, H, W, C] tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SwinTransformer(RolloutModel):
    """Reference `SwinTransformer` (config `type: SwinTransformer`) on the
    equirectangular grid or on HEALPix (`mesh`), with global windows
    (`window_size` None, the reference's) or fixed local ones.  `use_flash_attention` routes every
    stage, or each stage with a per-stage tuple.  `seed` seeds the random
    init (a `torch.Generator`); weights from the JAX model come in through
    `weights.load_flax_params`."""

    def __init__(
        self,
        img_height: int = 32,
        img_width: int = 64,
        patch_size: int = 1,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        embed_dim: int = 96,
        depths: Sequence[int] = (4, 4),
        num_heads: Sequence[int] = (4, 4),
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        ape: bool = False,
        patch_norm: bool = True,
        context_size: int = 1,
        mesh: str = "equirectangular",
        use_flash_attention: Any = None,
        exact_gelu: bool = False,
        window_size: Optional[Sequence[int]] = None,
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
        spmd_mesh: Any = None,
        dist_axis: str = "x",
    ):
        super().__init__(context_size, remat, remat_policy)
        if mesh not in ("equirectangular", "healpix"):
            raise NotImplementedError(
                f"Swin mesh {mesh!r} is not ported to PyTorch: only 'equirectangular' and "
                "'healpix'"
            )
        self.mesh = mesh
        self.window_size = None if window_size is None else tuple(int(w) for w in window_size)
        self.img_height, self.img_width = int(img_height), int(img_width)
        self.patch_size = p = int(patch_size)
        self.prognostic_channels = int(prognostic_channels)
        self.embed_dim = E = int(embed_dim)
        self.depths = [int(d) for d in depths]
        self.num_heads = [int(h) for h in num_heads]
        self.patch_norm = bool(patch_norm)
        self.ape = bool(ape)
        self.exact_gelu = bool(exact_gelu)
        self.plan = self._stage_plan()
        n = len(self.depths)

        cin = int(constant_channels) + context_size * (
            int(prescribed_channels) + self.prognostic_channels
        )
        self.Conv_0 = nn.Conv2d(cin, E, p, stride=p)
        self.stage_norms = []  # flax names of the per-stage output norms
        if self.patch_norm:
            self.LayerNorm_0 = nn.LayerNorm(E, eps=1e-5)
        if self.ape:
            st = self.plan[0]
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, st["H"], st["W"], E))

        blk = 0
        for i, st in enumerate(self.plan):
            dim = E * 2**i
            uf = use_flash_attention
            if isinstance(uf, (tuple, list)):
                uf = uf[i]
            for d in range(self.depths[i]):
                shift = (0, 0) if d % 2 == 0 else st["shift"]
                setattr(self, f"SwinBlock_{blk}", SwinBlock(
                    dim, self.num_heads[i], (st["wh"], st["ww"]), shift,
                    mlp_ratio, qkv_bias, uf, exact_gelu, mesh, spmd_mesh, dist_axis,
                ))
                blk += 1
                table = torch.zeros((2 * st["wh"] - 1) * (2 * st["ww"] - 1), self.num_heads[i])
                setattr(self, f"relative_position_bias_table_{i}_{d}", nn.Parameter(table))
            norm = f"LayerNorm_{i + int(self.patch_norm)}"
            setattr(self, norm, nn.LayerNorm(dim, eps=1e-5))
            self.stage_norms.append(norm)
            if i < n - 1:
                setattr(self, f"PatchMerging_{i}", PatchMerging(dim))

        # decoder, deepest stage first: ConvTranspose_0 is stage n-1
        for idx, i_layer in enumerate(reversed(range(n))):
            ch = E * 2**i_layer
            k = p if i_layer == 0 else 2
            out_ch = ch if i_layer == 0 else ch // 2
            in_ch = ch if idx == 0 else 2 * ch
            setattr(self, f"ConvTranspose_{idx}", nn.ConvTranspose2d(in_ch, out_ch, k, stride=k))
        self.Conv_1 = nn.Conv2d(E, self.prognostic_channels, 1)
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def _grid_hw(self) -> tuple[int, int]:
        """The grid the network runs on: the lat-lon grid, or on HEALPix the
        rectangle of 3 x 4 faces."""
        if self.mesh == "healpix":
            return 3 * self.img_height, 4 * self.img_width
        return self.img_height, self.img_width

    def _stage_plan(self):
        """Static per-stage geometry: global windows at each resolution, or
        the fixed local windows clamped to it."""
        p = self.patch_size
        H0, W0 = self._grid_hw()
        H = -(-H0 // p)
        W = -(-W0 // p)
        res_h, res_w = H, W
        plan = []
        for i in range(len(self.depths)):
            if self.window_size is not None:
                wh, ww = min(self.window_size[0], res_h), min(self.window_size[1], res_w)
            else:
                wh, ww = res_h, res_w
            pad_b = (wh - H % wh) % wh
            pad_r = (ww - W % ww) % ww
            plan.append(dict(H=H, W=W, Hp=H + pad_b, Wp=W + pad_r, wh=wh, ww=ww,
                             shift=(wh // 2, ww // 2)))
            if i < len(self.depths) - 1:
                H, W = (H + 1) // 2, (W + 1) // 2
                res_h, res_w = res_h // 2, res_w // 2
        return plan

    def precompute(self) -> dict[str, torch.Tensor]:
        """Expand every block's bias (+ fold the shift mask) once per rollout."""
        aux = {}
        for i, st in enumerate(self.plan):
            wh, ww = st["wh"], st["ww"]
            for d in range(self.depths[i]):
                table = getattr(self, f"relative_position_bias_table_{i}_{d}")
                rel = expand_relative_bias(table, wh, ww)
                sh, sw = (0, 0) if d % 2 == 0 else st["shift"]
                if sh or sw:
                    groups = device_constant(shift_window_groups, st["Hp"], st["Wp"], wh, ww,
                                             sh, sw, device=rel.device)
                    mask = torch.where(
                        groups[:, None, :] != groups[:, :, None], -100.0, 0.0
                    ).to(rel.dtype)
                    aux[f"{i}_{d}"] = (rel[None] + mask[:, None]).contiguous()  # [nW,nh,N,N]
                else:
                    aux[f"{i}_{d}"] = rel.contiguous()
        return aux

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        if aux is None:
            aux = self.precompute()
        if self.mesh == "healpix":  # [B, 12, n, n, C] -> the 3 x 4 rectangle of faces
            B, _, Hf, Wf, C = x.shape
            x = x.reshape(B, 3, 4, Hf, Wf, C).permute(0, 1, 3, 2, 4, 5).reshape(
                B, 3 * Hf, 4 * Wf, C)
        B, H0, W0, _ = x.shape
        p = self.patch_size
        E = self.embed_dim

        # PatchEmbed (circular-lon pad to a patch multiple, conv k=s=p)
        if W0 % p:
            x = torch.cat([x, x[:, :, : p - W0 % p]], dim=2)
        if H0 % p:
            x = F.pad(x, (0, 0, 0, 0, 0, p - H0 % p))
        x = _nchw(self.Conv_0, x)
        Wh, Ww = x.shape[1], x.shape[2]
        x = x.reshape(B, Wh * Ww, E)
        if self.patch_norm:
            x = self.LayerNorm_0(x)
        if self.ape:
            x = x + self.absolute_pos_embed.reshape(1, Wh * Ww, E)

        # encoder stages, halving the resolution
        n = len(self.depths)
        feats = []
        blk = 0
        for i, st in enumerate(self.plan):
            H, W = st["H"], st["W"]
            for d in range(self.depths[i]):
                x = getattr(self, f"SwinBlock_{blk}")(x, H, W, aux[f"{i}_{d}"])
                blk += 1
            x_out = getattr(self, self.stage_norms[i])(x)
            feats.append(x_out.reshape(B, H, W, E * 2**i))
            if i < n - 1:
                x = getattr(self, f"PatchMerging_{i}")(x, H, W)

        # ConvTranspose decoder with skip concatenation
        approx = "none" if self.exact_gelu else "tanh"
        y = None
        for idx, f in enumerate(reversed(feats)):
            x_in = f if idx == 0 else torch.cat([f, y], dim=-1)
            y = F.gelu(_nchw(getattr(self, f"ConvTranspose_{idx}"), x_in), approximate=approx)
        out = _nchw(self.Conv_1, y)[:, :H0, :W0]
        if self.mesh == "healpix":  # the rectangle -> [B, 12, n, n, C]
            Cq = self.prognostic_channels
            out = out.reshape(B, 3, Hf, 4, Wf, Cq).permute(0, 1, 3, 2, 4, 5).reshape(
                B, 12, Hf, Wf, Cq)
        return out, state


class SwinTransformerHPX(SwinTransformer):
    """HEALPix Swin (config `type: SwinTransformerHPX`, reference
    `SwinTransformerHPX`): `img_height` and `img_width` are the faces'
    nside."""

    __init__ = functools.partialmethod(SwinTransformer.__init__, mesh="healpix")
