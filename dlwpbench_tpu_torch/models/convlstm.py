"""ConvLSTM and ConvLSTMHPX (counterpart of
`dlwpbench_tpu/models/convlstm.py:34-137`).

- Encoder: three 3x3 `GeoConv`, the activation (tanh by default) after the
  first two.
- A stack of ConvLSTM cells: one 3x3 `GeoConv` on cat(x, h) gives the
  pre-activations netin, i, f, o (4 x hidden channels);
  c = sigmoid(f) c + sigmoid(i) tanh(netin), h = sigmoid(o) tanh(c).
- Decoder: one 3x3 `GeoConv` to the prognostic channels.
- The rollout is `RecurrentModel`'s: a loop from t = 0 over every frame,
  teacher forcing while t < `context_size`, the (h, c) of every cell reset
  per batch, `out = in_t + delta`, the outputs from `context_size` on.

Submodules carry the flax names of the JAX model: `enc1`, `enc2`, `enc3`,
`cells_0`, `cells_1`, ... (flax names a `setup` list's items `cells_<i>`),
each cell's `GeoConv_0`, and `dec`.

`ConvLSTMHPX` is the same network with `mesh="healpix"` (fields [B, 12,
n, n, C] inside).  `configs/model/convlstm.yaml` sets `mesh:
equirectangular`, which overrides the class default on either side, so a
HEALPix run of that config needs `model.mesh=healpix` (ROADMAP queue C).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from dlwpbench_tpu_torch.models.base import RecurrentModel
from dlwpbench_tpu_torch.models.fourcastnet import init_like_flax_
from dlwpbench_tpu_torch.ops.conv import GeoConv, get_activation


class ConvLSTMCell(nn.Module):
    def __init__(self, in_features: int, hidden_size: int, mesh: str = "equirectangular"):
        super().__init__()
        self.hidden_size = hidden_size
        self.GeoConv_0 = GeoConv(in_features + hidden_size, 4 * hidden_size, 3, mesh=mesh)

    def forward(self, x, h_prev, c_prev):
        netin, igate, fgate, ogate = torch.split(
            self.GeoConv_0(torch.cat([x, h_prev], dim=-1)), self.hidden_size, dim=-1)
        c = torch.sigmoid(fgate) * c_prev + torch.sigmoid(igate) * torch.tanh(netin)
        h = torch.sigmoid(ogate) * torch.tanh(c)
        return h, c


class ConvLSTM(RecurrentModel):
    """ConvLSTM (config `type: ConvLSTM`).  `seed` seeds the random init
    (flax's lecun-normal convs, zero biases); weights from the JAX model
    come in through `weights.load_flax_params`."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        hidden_sizes: Sequence[int] = (16, 16),
        context_size: int = 1,
        mesh: str = "equirectangular",
        activation: str = "tanh",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        self.mesh = mesh
        self.act = get_activation(activation)
        hs = self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        cin = int(constant_channels) + int(prescribed_channels) + int(prognostic_channels)
        self.enc1 = GeoConv(cin, hs[0], 3, mesh=mesh)
        self.enc2 = GeoConv(hs[0], hs[0], 3, mesh=mesh)
        self.enc3 = GeoConv(hs[0], hs[0], 3, mesh=mesh)
        self.cells = []
        for i, h in enumerate(hs):
            self.cells.append(f"cells_{i}")
            setattr(self, self.cells[-1], ConvLSTMCell(hs[max(i - 1, 0)], h, mesh=mesh))
        self.dec = GeoConv(hs[-1], int(prognostic_channels), 3, mesh=mesh)
        init_like_flax_(self, torch.Generator().manual_seed(int(seed)))

    def init_state(self, frame: torch.Tensor):
        """Zero (h, c) of every cell, [B, (F), H, W, hidden] each."""
        return [tuple(frame.new_zeros((*frame.shape[:-1], h)) for _ in range(2))
                for h in self.hidden_sizes]

    def step(self, x: torch.Tensor, states):
        x = self.enc3(self.act(self.enc2(self.act(self.enc1(x)))))
        new_states = []
        for name, (h, c) in zip(self.cells, states):
            x, c = getattr(self, name)(x, h, c)
            new_states.append((x, c))
        return self.dec(x), new_states


class ConvLSTMHPX(ConvLSTM):
    """HEALPix ConvLSTM (config `type: ConvLSTMHPX`)."""

    __init__ = functools.partialmethod(ConvLSTM.__init__, mesh="healpix")
