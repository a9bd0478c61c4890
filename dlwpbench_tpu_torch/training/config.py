"""Minimal Hydra-style config system (reference uses Hydra 1.3).

The port's own copy of `dlwpbench_tpu/training/config.py` (the port imports
nothing of the JAX package); both compose the same `configs/` tree.

Capabilities mirrored from the reference's `configs/` tree:
- a root `config.yaml` with a `defaults` list of `group: name` entries
  (`configs/config.yaml:1-9`);
- config groups as subdirectories (`training/`, `validation/`, `testing/`,
  `data/`, `model/`);
- CLI-style overrides: `group=name` swaps a group file,
  `a.b.c=value` sets a single key;
- `${a.b}` interpolation across the composed tree (the reference wires
  `${data.height}`, `${model.context_size}` this way).

No external deps beyond PyYAML.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Dict with attribute access and dotted get/set."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError:
            raise AttributeError(k) from None
        return v

    def __setattr__(self, k, v):
        self[k] = v

    def get_dotted(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, path: str, value: Any):
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _parse_value(text: str) -> Any:
    return yaml.safe_load(text)


_MISSING = object()


def _resolve_interpolations(cfg: Config):
    active: list[str] = []  # interpolation stack for cycle detection

    def lookup(key: str) -> Any:
        """Missing keys and cycles raise like Hydra, instead of silently
        producing None/'None' or a RecursionError."""
        if key in active:
            raise ValueError(
                "interpolation cycle: " + " -> ".join([*active, key])
            )
        val = cfg.get_dotted(key, _MISSING)
        if val is _MISSING:
            raise KeyError(f"interpolation ${{{key}}} refers to a missing key")
        active.append(key)
        try:
            return resolve(val)  # chained refs resolve recursively
        finally:
            active.pop()

    def resolve(node: Any) -> Any:
        if isinstance(node, dict):
            for k in list(node):
                node[k] = resolve(node[k])
            return node
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.fullmatch(node.strip())
            if m:  # whole-value interpolation keeps the referee's type
                return lookup(m.group(1))
            return _INTERP.sub(lambda mm: str(lookup(mm.group(1))), node)
        return node

    resolve(cfg)
    return cfg


def load_config(
    config_dir: str,
    config_name: str = "config",
    overrides: list[str] | None = None,
) -> Config:
    """Compose a config from groups + overrides, Hydra-style."""
    root_path = os.path.join(config_dir, f"{config_name}.yaml")
    with open(root_path) as f:
        root = yaml.safe_load(f) or {}
    defaults = root.pop("defaults", [])
    cfg = Config()

    group_choice: dict[str, str] = {}
    for entry in defaults:
        if entry == "_self_" or entry is None:
            continue
        if isinstance(entry, dict):
            [(group, name)] = entry.items()
            group_choice[str(group)] = str(name)

    # Group swaps in overrides take effect before file loading.
    kv_overrides: list[tuple[str, str]] = []
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        if key in group_choice and "." not in key:
            group_choice[key] = val
        else:
            kv_overrides.append((key, val))

    for group, name in group_choice.items():
        path = os.path.join(config_dir, group, f"{name}.yaml")
        with open(path) as f:
            cfg[group] = _wrap(yaml.safe_load(f) or {})

    for k, v in root.items():
        cfg[k] = _wrap(v)

    for key, val in kv_overrides:
        cfg.set_dotted(key, _parse_value(val))

    return _resolve_interpolations(cfg)


def save_config(cfg: Config, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_plain(cfg), f, sort_keys=False)


def to_plain(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def load_saved_config(run_dir: str) -> Config:
    """Re-load the config snapshot a training run wrote into its run
    directory (`config.yaml`; the reference's `.hydra/config.yaml`)."""
    with open(os.path.join(run_dir, "config.yaml")) as f:
        return _resolve_interpolations(_wrap(yaml.safe_load(f)))
