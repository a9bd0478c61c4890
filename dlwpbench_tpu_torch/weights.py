"""Load a flax parameter tree from the JAX package into a port model.

The port's modules carry the flax auto-names of their JAX counterparts
(`SwinBlock_0.WindowAttention_0.Dense_0`, ...), so a flax leaf path
`A/B/C/kernel` names the torch submodule `A.B.C`; the leaf is converted by
that submodule's type (the inverse of the mapping at
`tests/test_reference_parity.py:335-344,632-694`):

- Dense `kernel` [in, out]              -> Linear `weight` [out, in]
- Conv `kernel` HWIO                    -> Conv2d `weight` OIHW
- ConvTranspose `kernel` [kh,kw,in,out] -> ConvTranspose2d `weight`
  [in, out, kh, kw], spatially flipped (flax applies the kernel mirrored
  relative to torch)
- LayerNorm and GroupNorm `scale`       -> `weight`
- DenseGeneral `kernel` (the query, key, value and out projections of
  flax's `MultiHeadDotProductAttention`: [C, heads, hd], or [heads, hd, C]
  for out) -> `DenseGeneral` (a Linear) `weight` [heads*hd, C] or
  [C, heads*hd]; its `bias` [heads, hd] flattened
- `bias` as is, and parameters declared on a module itself (Swin's
  `relative_position_bias_table_{i}_{d}`) as is.

Every torch parameter must receive exactly one leaf and every leaf must
land; anything else raises.  `to_flax_tree` is the inverse: it maps the
port's parameters, or any same-named tensors such as their gradients,
back to the flax layout.  Trees travel as `.npz` files whose keys are
the `/`-joined flax paths (`save_npz` / `load_npz`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/c": array}."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_tree(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """{"a/b/c": array} -> nested dict of arrays."""
    tree: dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def save_npz(path: str, tree: Mapping[str, Any]) -> None:
    np.savez(path, **flatten_tree(tree))


def load_npz(path: str) -> dict[str, Any]:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


class DenseGeneral(nn.Linear):
    """A Linear that loads and saves the multi-axis kernel and bias of a
    flax `DenseGeneral`: `kernel_shape` folds to [in_features,
    out_features], `bias_shape` to [out_features]."""

    def __init__(self, kernel_shape: tuple[int, ...], bias_shape: tuple[int, ...],
                 in_axes: int = 1):
        kernel_shape, bias_shape = tuple(kernel_shape), tuple(bias_shape)
        super().__init__(int(np.prod(kernel_shape[:in_axes])),
                         int(np.prod(kernel_shape[in_axes:])))
        self.kernel_shape, self.bias_shape = kernel_shape, bias_shape


_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.LayerNorm, nn.GroupNorm)


def _convert(module: nn.Module, leaf: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """(torch parameter name on `module`, array in torch layout)."""
    if not isinstance(module, _LAYERS):
        if leaf in dict(module.named_parameters(recurse=False)):
            return leaf, arr
    elif leaf == "bias":
        return "bias", arr.reshape(-1) if isinstance(module, DenseGeneral) else arr
    elif leaf == "scale" and isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return "weight", arr
    elif leaf == "kernel" and isinstance(module, DenseGeneral):
        return "weight", arr.reshape(module.in_features, module.out_features).T
    elif leaf == "kernel" and isinstance(module, nn.Linear):
        return "weight", arr.T
    elif leaf == "kernel" and isinstance(module, nn.ConvTranspose2d):
        return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
    elif leaf == "kernel" and isinstance(module, nn.Conv2d):
        return "weight", arr.transpose(3, 2, 0, 1)
    raise KeyError(f"no torch parameter for flax leaf {leaf!r} on {type(module).__name__}")


def load_flax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a flax params tree (optionally wrapped as {"params": ...}) into
    `model` in place, on the model's device and dtype; returns the model."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    params = dict(model.named_parameters())
    loaded: set[str] = set()
    for path, arr in flatten_tree(tree).items():
        *mod_path, leaf = path.split("/")
        try:
            module = model.get_submodule(".".join(mod_path))
        except AttributeError:
            raise KeyError(f"flax path {path!r} has no torch module") from None
        name, value = _convert(module, leaf, np.asarray(arr, np.float32))
        full = ".".join([*mod_path, name])
        target = params[full]
        if tuple(target.shape) != value.shape:
            raise ValueError(
                f"{path}: flax {np.shape(arr)} -> {value.shape}, torch {tuple(target.shape)}"
            )
        with torch.no_grad():
            target.copy_(torch.from_numpy(value.copy()))
        loaded.add(full)
    missing = sorted(set(params) - loaded)
    if missing:
        raise KeyError(f"torch parameters without a flax leaf: {missing}")
    return model


def _to_flax_leaf(module: nn.Module, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """(flax leaf name, array in flax layout): the inverse of `_convert`."""
    if isinstance(module, DenseGeneral):
        return (("bias", arr.reshape(module.bias_shape)) if name == "bias"
                else ("kernel", arr.T.reshape(module.kernel_shape)))
    if not isinstance(module, _LAYERS) or name == "bias":
        return name, arr
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return "scale", arr
    if isinstance(module, nn.Linear):
        return "kernel", arr.T
    if isinstance(module, nn.ConvTranspose2d):
        return "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    return "kernel", arr.transpose(2, 3, 1, 0)  # Conv2d OIHW -> HWIO


def to_flax_tree(model: nn.Module, tensors: Mapping[str, torch.Tensor] | None = None
                 ) -> dict[str, Any]:
    """The model's parameters (or `tensors`, keyed by the same parameter
    names, e.g. `{n: p.grad for n, p in model.named_parameters()}`) as a
    nested flax parameter tree of fp32 numpy arrays."""
    source = dict(model.named_parameters()) if tensors is None else tensors
    flat = {}
    for full, t in source.items():
        *mod_path, name = full.split(".")
        module = model.get_submodule(".".join(mod_path))
        leaf, arr = _to_flax_leaf(module, name, t.detach().float().cpu().numpy())
        flat["/".join([*mod_path, leaf])] = np.ascontiguousarray(arr)
    return unflatten_tree(flat)
