"""Versioned model archives, the JAX package's format (counterpart of
`dlwpbench_tpu/training/module_checkpoint.py`): a zip of

    metadata.json   {format, type, name, version, args}
    params.msgpack  the flax parameter tree, msgpack-serialised as flax's
                    `serialization.to_bytes` writes it

`load_module_checkpoint` reads an archive of either package into the port:
the registry builds the port's model of `type` with the saved args, and
`weights.load_flax_params` loads the tree.  `save_module_checkpoint` writes
an archive that JAX's loader reads: the port's parameters as the flax tree
`{"params": ...}` (`weights.to_flax_tree`).  The msgpack codec is the
port's own (`utils/flax_msgpack.py`); it needs no `msgpack` package.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Mapping

import torch

from dlwpbench_tpu_torch import weights as W
from dlwpbench_tpu_torch.models import registry
from dlwpbench_tpu_torch.utils import flax_msgpack

FORMAT_VERSION = "dlwpbench_tpu.module.v1"
# flax's own dataclass fields, which JAX's writer saves among the args when
# they are None (`module_checkpoint.py:27-33`), and the port's build-only
# arguments, which no JAX model takes
_NOT_ARGS = ("parent", "name", "seed", "grid_shape")


def _registered_type(model: torch.nn.Module) -> str:
    import dlwpbench_tpu_torch.models  # noqa: F401  (fills the registry)

    for name in registry.registered_models():
        if registry.get_model_class(name) is type(model):
            return name
    raise KeyError(f"{type(model).__name__} is not a registered model type")


def save_module_checkpoint(path: str, model: torch.nn.Module, args: Mapping[str, Any],
                           version: str = "0.1.0") -> None:
    """Write `model` as an archive; `args` are the keyword arguments it was
    built with (a model config without `type`), saved as JSON scalars and
    lists: those the JAX class takes, for JAX's loader passes them all."""
    saved = {}
    for k, v in args.items():
        if k in _NOT_ARGS or k == "type":
            continue
        if isinstance(v, (int, float, str, bool, type(None))):
            saved[k] = v
        elif isinstance(v, (tuple, list)):
            saved[k] = list(v)
    type_name = _registered_type(model)
    meta = {
        "format": FORMAT_VERSION,
        "type": type_name,
        "name": args.get("name") or type_name,
        "version": version,
        "args": saved,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("metadata.json", json.dumps(meta, indent=1))
        z.writestr("params.msgpack", flax_msgpack.packb({"params": W.to_flax_tree(model)}))


def load_module_checkpoint(path: str, device: str = "cpu", **build_kwargs):
    """(the port's model on `device` with the archive's weights, the flax
    parameter tree as saved); `build_kwargs` go to `registry.build_model`
    (e.g. `grid_shape` for the spectral models)."""
    import dlwpbench_tpu_torch.models  # noqa: F401  (fills the registry)

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("metadata.json"))
        blob = z.read("params.msgpack")
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {meta.get('format')!r}")
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in meta["args"].items() if k not in _NOT_ARGS}
    model = registry.build_model({"type": meta["type"], **args}, **build_kwargs)
    params = flax_msgpack.unpackb(blob)
    W.load_flax_params(model, params)
    return model.to(device), params
