"""Model registry: explicit name -> class mapping (the port's counterpart of
`dlwpbench_tpu/models/registry.py`), keyed by the config `type` strings."""

from __future__ import annotations

import inspect
from typing import Any, Callable

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_model_class(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model type {name!r}; ported to PyTorch: {sorted(_REGISTRY)}"
        ) from None


def build_model(model_cfg: dict, **kwargs):
    """Instantiate a model from a config dict with a `type` key.

    Config keys the constructor does not take (e.g. `name`, and `remat` for
    the diffusion models, which are no rollout models) are dropped, as
    the JAX `build_model` drops keys its dataclass lacks; `kwargs` (the
    init `seed`) are passed through."""
    cfg = dict(model_cfg)
    cls = get_model_class(cfg.pop("type"))
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in cfg.items() if k in params}, **kwargs)

