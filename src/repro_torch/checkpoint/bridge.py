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

A bf16 leaf is either widened to fp32 (``tree_to_numpy``, the
checkpoint format) or kept as its 16-bit words, numpy's ``V2`` dtype
(``host_array``, the fleet's wire format), which is what ``np.savez``
writes for JAX's bf16 arrays; ``array_tensor`` reads either back.
"""
from __future__ import annotations

import warnings
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


def target_from_numpy(cfg: ModelConfig, flat, *, device) -> ParamTree:
    from repro_torch.models import transformer
    return from_numpy(transformer.param_specs(cfg), flat, device=device,
                      dtype=cfg.act_dtype)


def draft_from_numpy(dcfg: ModelConfig, flat, *, device) -> ParamTree:
    from repro_torch.core import eagle
    return from_numpy(eagle.draft_specs(dcfg), flat, device=device,
                      dtype=dcfg.act_dtype)


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{'/'-joined key: tensor}`` of a ``ParamTree`` or a nested dict of
    tensors, in sorted-key order: JAX's ``_flatten`` keys and leaf order
    of the same pytree."""
    if isinstance(tree, ParamTree):
        return tree.flat()
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def tree_to(tree, device, non_blocking: bool = False) -> ParamTree:
    """A ``ParamTree`` (or nested dict of tensors) with every leaf copied
    to ``device`` (on the current streams of the two devices)."""
    return ParamTree(unflatten({
        k: t.to(device, non_blocking=non_blocking)
        for k, t in flat(tree).items()}))


# numpy's dtype for a bf16 word (what np.savez writes for JAX's bf16)
BF16_WORD = np.dtype("V2")


def host_array(x) -> np.ndarray:
    """A leaf as a host numpy array, its dtype kept: a tensor is copied to
    the host, a bf16 one as its 16-bit words (``BF16_WORD``)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_WORD)
        return t.numpy()
    return np.asarray(x)


def array_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, dtype kept (``BF16_WORD``
    as bf16).  The array may view a read-only buffer: a CPU tensor is a
    copy, a CUDA tensor a host-to-device copy on the current stream."""
    arr = np.asarray(arr)
    bf16 = arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    with warnings.catch_warnings():
        # a read-only buffer: the tensor below never writes it
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
    if bf16:
        t = t.view(torch.bfloat16)
    device = torch.device(device)
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)


def tree_to_numpy(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of ``from_numpy``: a ``ParamTree`` or nested dict of
    tensors (a flat dict of draft leaves, optimizer state) as
    ``{'/'-joined key: np.ndarray}`` on the host (bf16 leaves are
    widened to fp32, numpy having no bf16)."""
    return {key: _host(t) for key, t in flat(tree, prefix).items()}


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
