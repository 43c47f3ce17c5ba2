"""Weights between the JAX package and the port, as numpy arrays.

The JAX package flattens a parameter pytree to ``{'/'-joined key:
np.ndarray}`` (``repro/checkpoint/ckpt.py`` ``_flatten``); this module
turns such a dict into the port's ``ParamTree`` modules and back, for
the target model (``transformer.param_specs``) and the EAGLE-3 draft
(``eagle.draft_specs``).  Shapes are checked against the specs on the
way in.  Optimizer state (``training/optimizer.py``, AdamW and
Adafactor) and a trainer's flat dict of draft leaves cross the same way,
under JAX's keys (``m/<leaf>``, ``<leaf>/vr``).  The port itself never
reads JAX objects: callers hand it numpy arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamTree, check_tree, unflatten


def _to_tensors(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).to(device=device, dtype=dtype)


def from_numpy(specs, flat: Dict[str, np.ndarray], *, device,
               dtype: torch.dtype) -> ParamTree:
    """Build a ``ParamTree`` from a flat numpy dict, checked against
    ``specs`` and cast once to ``dtype``."""
    tree = unflatten(flat)
    check_tree(specs, tree)
    return ParamTree(_to_tensors(tree, device, dtype))


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_numpy(params: ParamTree) -> Dict[str, np.ndarray]:
    """The inverse: ``{'/'-joined key: np.ndarray}`` on the host (bf16
    leaves are widened to fp32, numpy having no bf16)."""
    return {key: _host(t) for key, t in params.flat().items()}


def target_from_numpy(cfg: ModelConfig, flat, *, device) -> ParamTree:
    from repro_torch.models import transformer
    return from_numpy(transformer.param_specs(cfg), flat, device=device,
                      dtype=cfg.act_dtype)


def draft_from_numpy(dcfg: ModelConfig, flat, *, device) -> ParamTree:
    from repro_torch.core import eagle
    return from_numpy(eagle.draft_specs(dcfg), flat, device=device,
                      dtype=dcfg.act_dtype)


def tree_to_numpy(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of tensors (a flat dict of draft leaves, optimizer
    state) as ``{'/'-joined key: np.ndarray}``: JAX's ``_flatten`` keys
    of the same pytree."""
    if isinstance(tree, torch.Tensor):
        return {prefix: _host(tree)}
    out = {}
    for k in sorted(tree):
        out.update(tree_to_numpy(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def adamw_state_from_numpy(flat, *, device) -> dict:
    """AdamW state ``{"m": {leaf: t}, "v": {leaf: t}}`` (fp32) from JAX's
    flattened ``{"m/<leaf>": ..., "v/<leaf>": ...}``."""
    out = {"m": {}, "v": {}}
    for key, val in flat.items():
        head, leaf = key.split("/", 1)
        out[head][leaf] = torch.tensor(np.asarray(val, np.float32),
                                       device=device)
    return out


def adafactor_state_from_numpy(flat, *, device) -> dict:
    """Adafactor state ``{leaf: {"vr", "vc"} or {"v"}}`` (fp32) from
    JAX's flattened ``{"<leaf>/vr": ...}``."""
    out: dict = {}
    for key, val in flat.items():
        leaf, part = key.rsplit("/", 1)
        out.setdefault(leaf, {})[part] = torch.tensor(
            np.asarray(val, np.float32), device=device)
    return out
