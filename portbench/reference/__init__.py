"""Plain PyTorch references, one module per model family, each exposing
`Reference`: the yardstick the benchmark holds the program's outputs
against.  Nothing in this package imports the program under test."""

from __future__ import annotations

import importlib


def reference_class(family: str):
    """The `Reference` class of `portbench/reference/<family>.py`."""
    return importlib.import_module(f"portbench.reference.{family}").Reference
