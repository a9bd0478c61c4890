"""DISTANA and DISTANAHPX (counterpart of
`dlwpbench_tpu/models/distana.py:41-188`): a lattice of weight-shared
prediction kernels (PKs), one per grid cell, each fed its cell's input and
the lateral outputs its 8 neighbours emitted on the previous step.

- The lateral exchange: `_neighbors_equirect` rolls in longitude and reads
  zero rows beyond the poles; `_neighbors_healpix` reads the neighbour
  padding of the 12 faces (`ops/padding.py::healpix_pad_channels_last`).
  The 8 neighbours come in the JAX order (dy, dx) over (-1, 0, 1)^2
  without (0, 0), concatenated on channels.
- A PK is per-cell Dense layers (`Linear` on the channels-last field): a
  tanh pre-layer, `layers` LSTM layers (one Dense on cat(z, h) gives
  netin, i, f, o), and an output layer giving the prognostic increment and
  the next lateral output (tanh).
- The rollout is `RecurrentModel`'s; the carry is the lateral field and
  every layer's (h, c), all zero at t = 0.

Submodules carry the flax names: `pk.Dense_0` to `pk.Dense_{layers+1}`.
flax's default Dense init is lecun-normal (zero biases), which the seeded
init copies.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from dlwpbench_tpu_torch.models.base import RecurrentModel
from dlwpbench_tpu_torch.models.fourcastnet import _lecun_normal_
from dlwpbench_tpu_torch.ops.padding import healpix_pad_channels_last

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]


def _neighbors_equirect(lat_field: torch.Tensor) -> torch.Tensor:
    """[B, H, W, L] lateral field -> [B, H, W, 8L] neighbour values
    (periodic in longitude, zero beyond the poles)."""
    H = lat_field.shape[1]
    padded = torch.nn.functional.pad(lat_field, (0, 0, 0, 0, 1, 1))
    return torch.cat([torch.roll(padded[:, 1 + dy : 1 + dy + H], shifts=-dx, dims=2)
                      for dy, dx in _OFFSETS], dim=-1)


def _neighbors_healpix(lat_field: torch.Tensor) -> torch.Tensor:
    """[B, 12, n, n, L] -> [B, 12, n, n, 8L] through the neighbour pad."""
    n = lat_field.shape[2]
    padded = healpix_pad_channels_last(lat_field, 1)  # [B, 12, n+2, n+2, L]
    return torch.cat([padded[:, :, 1 + dy : 1 + dy + n, 1 + dx : 1 + dx + n]
                      for dy, dx in _OFFSETS], dim=-1)


class PredictionKernel(nn.Module):
    """One weight-shared PK applied to every grid cell."""

    def __init__(self, in_features: int, hidden_size: int = 16, layers: int = 4,
                 lateral_channels: int = 1, out_channels: int = 1, bias: bool = True):
        super().__init__()
        self.hidden_size, self.layers, self.out_channels = hidden_size, layers, out_channels
        self.Dense_0 = nn.Linear(in_features + 8 * lateral_channels, hidden_size, bias=bias)
        for li in range(layers):
            setattr(self, f"Dense_{li + 1}", nn.Linear(2 * hidden_size, 4 * hidden_size,
                                                       bias=bias))
        setattr(self, f"Dense_{layers + 1}",
                nn.Linear(hidden_size, out_channels + lateral_channels, bias=bias))

    def forward(self, x, lat_in, states):
        """x: [..., Cin]; lat_in: [..., 8L]; states: list of (h, c)."""
        z = torch.tanh(self.Dense_0(torch.cat([x, lat_in], dim=-1)))
        new_states = []
        for li, (h_prev, c_prev) in enumerate(states):
            gates = getattr(self, f"Dense_{li + 1}")(torch.cat([z, h_prev], dim=-1))
            netin, i_g, f_g, o_g = torch.split(gates, self.hidden_size, dim=-1)
            c = torch.sigmoid(f_g) * c_prev + torch.sigmoid(i_g) * torch.tanh(netin)
            z = torch.sigmoid(o_g) * torch.tanh(c)
            new_states.append((z, c))
        out = getattr(self, f"Dense_{self.layers + 1}")(z)
        return out[..., : self.out_channels], torch.tanh(out[..., self.out_channels :]), new_states


class DISTANA(RecurrentModel):
    """DISTANA (config `type: DISTANA`).  `seed` seeds the random init;
    weights from the JAX model come in through `weights.load_flax_params`."""

    def __init__(
        self,
        constant_channels: int = 4,
        prescribed_channels: int = 0,
        prognostic_channels: int = 1,
        hidden_size: int = 16,
        layers: int = 4,
        lateral_channels: int = 1,
        bias: bool = True,
        context_size: int = 1,
        mesh: str = "equirectangular",
        remat: bool = False,
        remat_policy: str = "full",
        seed: int = 0,
    ):
        super().__init__(context_size, remat, remat_policy)
        self.mesh = mesh  # "healpix" exchanges through the faces' pad, any other the lat-lon way
        self.hidden_size, self.layers = int(hidden_size), int(layers)
        self.lateral_channels = int(lateral_channels)
        cin = int(constant_channels) + int(prescribed_channels) + int(prognostic_channels)
        self.pk = PredictionKernel(cin, self.hidden_size, self.layers, self.lateral_channels,
                                   int(prognostic_channels), bool(bias))
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.pk.children():
                _lecun_normal_(m.weight, m.in_features, gen)
                if m.bias is not None:
                    m.bias.zero_()

    def init_state(self, frame: torch.Tensor):
        """The zero lateral field [B, (F), H, W, L] and zero (h, c) of every
        layer, [B, (F), H, W, hidden] each."""
        spatial = frame.shape[:-1]
        states = [tuple(frame.new_zeros((*spatial, self.hidden_size)) for _ in range(2))
                  for _ in range(self.layers)]
        return frame.new_zeros((*spatial, self.lateral_channels)), states

    def step(self, x: torch.Tensor, state):
        lateral, states = state
        gather = _neighbors_healpix if self.mesh == "healpix" else _neighbors_equirect
        delta, lateral, states = self.pk(x, gather(lateral), states)
        return delta, (lateral, states)


class DISTANAHPX(DISTANA):
    """HEALPix DISTANA (config `type: DISTANAHPX`): the lateral exchange
    through the faces' neighbour padding."""

    __init__ = functools.partialmethod(DISTANA.__init__, mesh="healpix")
