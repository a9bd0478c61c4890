"""Classic U-Net on the equirectangular grid (counterpart of
`dlwpbench_tpu/models/unet.py:35-92`).

- Encoder: per level a 2x average pool (except the top), then
  `n_convolutions` 3x3 geo-padded convs, each followed by the activation;
  the bottom level runs `n_convolutions // 2`.  On an odd grid one edge
  row or column is replicated before the pool so that it halves exactly.
- Decoder: per level the encoder's skip concatenated in front (except at
  the bottom), after a crop back to the skip's shape; `n_convolutions`
  convs (`n_convolutions // 2` at the bottom); a 2x2 / stride-2 transposed
  conv between levels; a 1x1 conv head.
- The rollout and residual semantics of `RolloutModel`; the net is
  stateless.

Submodules carry the flax auto-names of the JAX model: `GeoConv_k` in
creation order across the encoder, the decoder and the head, and
`GeoConvTranspose_k` in decoder order.  The HEALPix variant (`UNetHPX`) is
not ported yet (ROADMAP queue A, item 8).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fourcastnet import init_like_flax_
from dlwpbench_tpu_torch.ops.conv import GeoConv, GeoConvTranspose, avg_pool_2x, get_activation


class UNet(RolloutModel):
    """U-Net weather emulator (config `type: UNet`).  `seed` seeds the
    random init (flax's lecun-normal convs, zero biases); weights from the
    JAX model come in through `weights.load_flax_params`."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        hidden_channels: Sequence[int] = (8, 16, 32),
        n_convolutions: int = 2,
        activation: str = "gelu",
        context_size: int = 1,
        mesh: str = "equirectangular",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        self.mesh = mesh
        self.act = get_activation(activation)
        hc = self.hidden_channels = tuple(int(c) for c in hidden_channels)
        n_conv = int(n_convolutions)
        n_levels = len(hc)
        cin = int(constant_channels) + context_size * (
            int(prescribed_channels) + int(prognostic_channels)
        )
        convs = 0

        def add_convs(n: int, c_in: int, c_out: int) -> list[str]:
            nonlocal convs
            names = []
            for _ in range(n):
                names.append(f"GeoConv_{convs}")
                setattr(self, names[-1], GeoConv(c_in, c_out, 3, mesh=mesh))
                convs += 1
                c_in = c_out
            return names

        # the conv names of each encoder and decoder level, in flax's order
        self.enc, self.dec = [], []
        enc_ch, ch = [], cin
        for lvl, c in enumerate(hc):
            n = n_conv // 2 if lvl == n_levels - 1 else n_conv
            self.enc.append(add_convs(n, ch, c))
            ch = c if n else ch
            enc_ch.append(ch)
        rev = hc[::-1]
        for i, c in enumerate(rev):
            if i > 0:
                ch += enc_ch[n_levels - 1 - i]  # the skip, concatenated in front
            n = n_conv // 2 if i == 0 else n_conv
            self.dec.append(add_convs(n, ch, c))
            ch = c if n else ch
            if i < n_levels - 1:
                setattr(self, f"GeoConvTranspose_{i}",
                        GeoConvTranspose(ch, rev[i + 1], 2, 2, mesh=mesh))
                ch = rev[i + 1]
        self.head = f"GeoConv_{convs}"
        setattr(self, self.head, GeoConv(ch, int(prognostic_channels), 1, mesh=mesh))
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        n_levels = len(self.hidden_channels)
        skips = []
        for lvl, names in enumerate(self.enc):
            if lvl > 0:
                if x.shape[1] % 2 or x.shape[2] % 2:
                    # odd grid: replicate the last row / column so that
                    # the pool halves exactly; the decoder crops back
                    x = F.pad(x.permute(0, 3, 1, 2), (0, x.shape[2] % 2, 0, x.shape[1] % 2),
                              mode="replicate").permute(0, 2, 3, 1)
                x = avg_pool_2x(x, self.mesh)
            for name in names:
                x = self.act(getattr(self, name)(x))
            skips.append(x)

        for i, names in enumerate(self.dec):
            if i > 0:
                skip = skips[n_levels - 1 - i]
                x = x[:, : skip.shape[1], : skip.shape[2]]
                x = torch.cat([skip, x], dim=-1)
            for name in names:
                x = self.act(getattr(self, name)(x))
            if i < n_levels - 1:
                x = getattr(self, f"GeoConvTranspose_{i}")(x)
        return getattr(self, self.head)(x), state
