"""Weights between the JAX package and the port, as numpy arrays.

The JAX package flattens a parameter pytree to ``{'/'-joined key:
np.ndarray}`` (``repro/checkpoint/ckpt.py`` ``_flatten``); this module
turns such a dict into the port's ``ParamTree`` modules and back, for
the target model (``transformer.param_specs``) and the EAGLE-3 draft
(``eagle.draft_specs``).  Shapes are checked against the specs on the
way in.  The port itself never reads JAX objects: callers hand it
numpy arrays.
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


def to_numpy(params: ParamTree) -> Dict[str, np.ndarray]:
    """The inverse: ``{'/'-joined key: np.ndarray}`` on the host (bf16
    leaves are widened to fp32, numpy having no bf16)."""
    out = {}
    for key, t in params.flat().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[key] = t.numpy()
    return out


def target_from_numpy(cfg: ModelConfig, flat, *, device) -> ParamTree:
    from repro_torch.models import transformer
    return from_numpy(transformer.param_specs(cfg), flat, device=device,
                      dtype=cfg.act_dtype)


def draft_from_numpy(dcfg: ModelConfig, flat, *, device) -> ParamTree:
    from repro_torch.core import eagle
    return from_numpy(eagle.draft_specs(dcfg), flat, device=device,
                      dtype=dcfg.act_dtype)
