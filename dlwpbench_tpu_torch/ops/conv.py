"""Geometry-aware convolution building blocks, channels-last (counterpart of
`dlwpbench_tpu/ops/conv.py:42-220`).

- `GeoConv`: a conv whose padding follows the mesh's boundary condition:
  "equirectangular" circular in longitude and zero in latitude (the
  `cylinder_pad` of `ops/padding.py`), "plain" zero on both axes, "torus"
  circular on both (the Navier-Stokes domain), "healpix" the neighbour
  padding of the 12 faces (`healpix_pad_channels_last`), then the faces
  folded into the batch for one conv; 1x1 convs skip padding.
- `GeoConvTranspose`: the U-Net decoder's 2x upsampling transposed conv.
- `PlainConv`, `PlainConvTranspose`: torch's own zero-padded conv and
  transposed conv (`Conv2d(k, s, padding=(k-1)//2)`, `ConvTranspose2d(k,
  s, padding)`) on channels-last fields, on the folded faces on HEALPix
  with no neighbour padding: the ModernUNet's strided downsampling
  (`modern_unet.py:239-247`, a reference quirk kept on HEALPix) and its
  k4 / s2 / p1 upsampling, which equals flax's "SAME" transpose and the
  VALID one cropped by 1 at each edge (`:249-258`).  They are the
  `nn.Conv2d` and `nn.ConvTranspose2d` themselves, so they carry flax's
  bare `Conv_k` and `ConvTranspose_k` names.
- `avg_pool_2x`: the U-Net encoder's 2x2 / stride-2 average pool.
- `fold_faces` / `unfold_faces`: [B, 12, H, W, C] <-> [B*12, H, W, C].
- `ACTIVATIONS` and `get_activation`: the activation table and the parser
  of config specs, bare names and dotted torch specs alike.

Every op takes and returns [B, H, W, C], or [B, 12, H, W, C] on the
"healpix" mesh (faces folded into the batch around each conv or pool).
Around each conv or pool the tensor is permuted to NCHW as a view: its
storage stays NHWC, which is `torch.channels_last` for the NCHW view, so
cuDNN runs its NHWC kernels and no copy is made.  The circular longitude
pad is one concatenation on the W axis; the zero latitude pad is the
conv's own padding.

Submodules carry the flax auto-names of the JAX modules (`GeoConv_k.Conv_0`,
`GeoConvTranspose_k.ConvTranspose_0`), so `weights.load_flax_params` maps
a flax tree onto them name for name.
"""

from __future__ import annotations

import re
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dlwpbench_tpu_torch.ops.padding import healpix_pad_channels_last

MESHES = ("equirectangular", "plain", "torus", "healpix")


def _nchw(layer: Callable, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW layer to a channels-last [B, H, W, C] tensor."""
    return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _circular(x: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, n - p, p), x, x.narrow(dim, 0, p)], dim=dim)


def _check_mesh(mesh: str) -> None:
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}")


def fold_faces(x: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, C] -> [B*F, H, W, C] (reference HEALPixFoldFaces)."""
    B, F_, H, W, C = x.shape
    return x.reshape(B * F_, H, W, C)


def unfold_faces(x: torch.Tensor, faces: int = 12) -> torch.Tensor:
    """[B*F, H, W, C] -> [B, F, H, W, C] (reference HEALPixUnfoldFaces)."""
    BF, H, W, C = x.shape
    return x.reshape(BF // faces, faces, H, W, C)


def _on_mesh(layer: Callable, x: torch.Tensor, mesh: str) -> torch.Tensor:
    """An NCHW layer on a channels-last field, on the folded faces on
    HEALPix."""
    if mesh == "healpix":
        return unfold_faces(_nchw(layer, fold_faces(x)))
    return _nchw(layer, x)


class GeoConv(nn.Module):
    """Boundary-aware 2D convolution [B, H, W, Cin] -> [B, H', W', features].

    Kernels > 1 are padded by (k // 2) * dilation with the mesh's boundary
    condition and convolved without further padding, as the JAX module's
    pad-then-VALID; 1x1 convs skip padding.

    `row_group` (set by a model with `spmd_mesh`; equirectangular only):
    the field's latitude rows are split over the ranks of that group, and
    the rows above and below come from the neighbouring ranks
    (`parallel/halo.py::halo_exchange_rows`, zero rows at the poles) in
    place of the conv's own zero padding."""

    row_group = None

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 mesh: str = "equirectangular", strides: int = 1, use_bias: bool = True,
                 dilation: int = 1):
        super().__init__()
        _check_mesh(mesh)
        self.mesh = mesh
        k = int(kernel_size)
        self.pad = pad = (k // 2) * int(dilation)
        native = {"equirectangular": (pad, 0), "plain": (pad, pad), "torus": (0, 0),
                  "healpix": (0, 0)}[mesh]
        self.Conv_0 = nn.Conv2d(in_features, features, k, stride=strides, padding=native,
                                dilation=dilation, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        if p and self.row_group is not None:
            from dlwpbench_tpu_torch.parallel.halo import halo_exchange_rows

            x = _circular(x, p, 2)  # longitude, then the neighbours' rows
            x = halo_exchange_rows(x.movedim(-1, 1), p, self.row_group).movedim(1, -1)
            c = self.Conv_0
            return _nchw(lambda t: F.conv2d(t, c.weight, c.bias, c.stride, 0, c.dilation), x)
        if p and self.mesh == "healpix":
            # pad the faces from their neighbours; one conv over the folded faces
            x = healpix_pad_channels_last(x, p)
        if p and self.mesh in ("equirectangular", "torus"):
            x = _circular(x, p, 2)  # longitude
        if p and self.mesh == "torus":
            x = _circular(x, p, 1)
        return _on_mesh(self.Conv_0, x, self.mesh)


class GeoConvTranspose(nn.Module):
    """Transposed conv [B, H, W, Cin] -> [B, sH, sW, features] (the U-Net
    decoder's upsampling).  flax's VALID transposed conv and torch's agree
    in size and placement when the kernel is no smaller than the stride."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 2,
                 stride: int = 2, mesh: str = "equirectangular"):
        super().__init__()
        _check_mesh(mesh)
        self.mesh = mesh
        if kernel_size < stride:
            raise ValueError(f"kernel_size {kernel_size} < stride {stride} is not supported")
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_features, features, kernel_size,
                                                  stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _on_mesh(self.ConvTranspose_0, x, self.mesh)


class PlainConv(nn.Conv2d):
    """torch-style zero-padded conv (padding (k - 1) // 2) of [B, H, W, C]
    or, on the "healpix" mesh, of each face of [B, 12, n, n, C]."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, mesh: str = "equirectangular"):
        _check_mesh(mesh)
        super().__init__(in_features, features, kernel_size, stride=stride,
                         padding=(int(kernel_size) - 1) // 2)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _on_mesh(super().forward, x, self.mesh)


class PlainConvTranspose(nn.ConvTranspose2d):
    """torch's ConvTranspose2d(k, s, padding) of [B, H, W, C] or of each
    face of [B, 12, n, n, C]; (k, s, p) = (4, 2, 1) doubles H and W."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, mesh: str = "equirectangular"):
        _check_mesh(mesh)
        super().__init__(in_features, features, kernel_size, stride=stride, padding=padding)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _on_mesh(super().forward, x, self.mesh)


def avg_pool_2x(x: torch.Tensor, mesh: str = "equirectangular") -> torch.Tensor:
    """2x2 / stride-2 average pool of [B, H, W, C] (odd edges dropped), or
    of each face of [B, 12, H, W, C] on the "healpix" mesh."""
    _check_mesh(mesh)
    return _on_mesh(lambda t: F.avg_pool2d(t, 2, 2), x, mesh)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    # bare "gelu" is the tanh approximation (the JAX package's fast
    # default); "gelu_exact" and "gelu_erf" are the erf form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
    "stan": lambda x: torch.tanh(x) * (x + 1.0),
    "squareplus": lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0)),
    # the Modulus factory's slope, not torch's 0.01 default
    "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
    "elu": F.elu,
    "gelu_erf": F.gelu,
    "selu": F.selu,
    "relu6": F.relu6,
    "celu": F.celu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "hardswish": F.hardswish,
    "hardsigmoid": F.hardsigmoid,
    "mish": F.mish,
}

# torch classes whose first argument parameterises the function, with
# torch's default: class -> (fn(x, value), default)
_TORCH_PARAM_CLASSES: dict[str, tuple[Callable, float]] = {
    "leakyrelu": (lambda x, v: F.leaky_relu(x, v), 0.01),
    "elu": (lambda x, v: F.elu(x, alpha=v), 1.0),
    "celu": (lambda x, v: F.celu(x, alpha=v), 1.0),
}


def get_activation(name) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation a config names: an exact table name first, else a
    call or dotted torch spec ("torch.nn.GELU()" is the erf GELU,
    "torch.nn.LeakyReLU()" has slope 0.01, a numeric first argument is
    honoured), matched exactly on the normalised class name.  An unknown
    name or argument raises; nothing falls back to a substring match."""
    if callable(name):
        return name
    key = str(name).lower().strip()
    if key in ACTIVATIONS:
        return ACTIVATIONS[key]
    call = re.fullmatch(r"([a-z_][\w.]*)\s*\((.*)\)", key)
    head = call.group(1) if call else key
    torchy = "." in head
    cls = head.rsplit(".", 1)[-1].replace("_", "").strip()
    val = None
    gelu_approx = False
    if call:
        for part in call.group(2).split(","):
            part = part.strip()
            if not part or part.startswith("inplace"):
                continue
            ap = re.fullmatch(r"approximate\s*=\s*['\"]?(none|tanh)['\"]?", part)
            if ap and cls == "gelu":
                gelu_approx = ap.group(1) == "tanh"
                continue
            m = re.fullmatch(r"(?:\w+\s*=\s*)?([-+0-9.eE]+)", part)
            if m:
                val = float(m.group(1))
                break
            raise ValueError(f"unsupported activation argument {part!r} in {name!r}")
    if torchy or call:
        if cls in _TORCH_PARAM_CLASSES:
            fn, default = _TORCH_PARAM_CLASSES[cls]
            v = default if val is None else val
            return lambda x: fn(x, v)
        if val is not None:
            raise ValueError(
                f"activation {name!r} has a numeric argument but {cls!r} is not a known "
                "parameterized activation")
    if torchy and cls == "gelu":
        return ACTIVATIONS["gelu" if gelu_approx else "gelu_exact"]
    by_norm = {k.replace("_", ""): v for k, v in ACTIVATIONS.items()}
    if cls in by_norm:
        return by_norm[cls]
    raise ValueError(f"unknown activation {name!r}")
