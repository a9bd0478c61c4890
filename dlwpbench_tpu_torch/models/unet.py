"""Classic U-Net and its HEALPix variant (counterpart of
`dlwpbench_tpu/models/unet.py:35-98`).

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
`GeoConvTranspose_k` in decoder order.

With `spmd_mesh` (a `DeviceMesh`, `parallel/launch.py::global_mesh`; the
equirectangular mesh) every step runs on this rank's block of latitude
rows over the mesh dim `dist_axis`, between `launch.scatter_to_ranks` and
`launch.gather_from_ranks`: each 3x3 conv takes the rows above and below
from the neighbouring ranks (`GeoConv.row_group`), pools and transposed
convs act on the local rows, which must stay even at every level.  Each
rank's weight gradients are its rows' share; `partition_group` names the
group they are summed over, as for the spectral models (the trainer does).

`UNetHPX` is the same network with `mesh="healpix"`: fields are
[B, 12, n, n, C] inside, every conv pads each face from its neighbours
(`ops/padding.py::healpix_pad_channels_last`) and runs on the faces folded
into the batch; pools and transposed convs act face by face.
"""

from __future__ import annotations

import functools
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dlwpbench_tpu_torch.models.base import RolloutModel
from dlwpbench_tpu_torch.models.fourcastnet import init_like_flax_
from dlwpbench_tpu_torch.ops.conv import GeoConv, GeoConvTranspose, avg_pool_2x, get_activation
from dlwpbench_tpu_torch.parallel import launch


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
        spmd_mesh: Any = None,
        dist_axis: str = "x",
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
        if spmd_mesh is not None:
            if mesh != "equirectangular":
                raise ValueError(f"spmd_mesh splits latitude rows: the equirectangular mesh "
                                 f"only, not {mesh!r}")
            self.partition_group = launch.axis(spmd_mesh, dist_axis)[0]
            for m in self.modules():
                if isinstance(m, GeoConv):
                    m.row_group = self.partition_group

    def step(self, x: torch.Tensor, state: Any, aux: Any = None):
        n_levels = len(self.hidden_channels)
        group = self.partition_group
        if group is not None:  # this rank's latitude rows from here to the gather
            unit = dist.get_world_size(group) * 2 ** (n_levels - 1)
            if x.shape[1] % unit:
                raise ValueError(f"{x.shape[1]} latitude rows do not split into blocks that stay "
                                 f"even at every level over {dist.get_world_size(group)} ranks "
                                 f"(a multiple of {unit})")
            x = launch.scatter_to_ranks(x, 1, group)
        skips = []
        for lvl, names in enumerate(self.enc):
            if lvl > 0:
                if self.mesh != "healpix" and (x.shape[1] % 2 or x.shape[2] % 2):
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
                if self.mesh != "healpix":
                    x = x[:, : skip.shape[1], : skip.shape[2]]
                x = torch.cat([skip, x], dim=-1)
            for name in names:
                x = self.act(getattr(self, name)(x))
            if i < n_levels - 1:
                x = getattr(self, f"GeoConvTranspose_{i}")(x)
        out = getattr(self, self.head)(x)
        return (out if group is None else launch.gather_from_ranks(out, 1, group)), state


class UNetHPX(UNet):
    """HEALPix U-Net (config `type: UNetHPX`, reference `UNetHPX`)."""

    __init__ = functools.partialmethod(UNet.__init__, mesh="healpix")
