"""Architecture config registry (port of ``repro/configs/__init__.py``).

The port carries the configurations its slices run: ``tide_tiny`` (the
CPU parity model) and ``glm4_9b`` (the dense model the port serves on the
card).  ``get(name)`` / ``get_reduced(name)`` look them up by module name
or dashed alias.
"""
from __future__ import annotations

import importlib

ARCHS = ["glm4_9b", "tide_tiny"]

_ALIASES = {"glm4-9b": "glm4_9b", "tide-tiny": "tide_tiny"}


def _module(name: str):
    key = _ALIASES.get(name, name.replace("-", "_"))
    if key not in ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP queue 1: "
            "other model families)")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).REDUCED
