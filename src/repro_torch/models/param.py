"""Parameter specs and initialisation (port of ``repro/models/param.py``).

Parameters are declared as ``ParamSpec`` trees (shape, logical axes,
init scheme) exactly as in the JAX package, so the port's parameter
shapes and '/'-joined keys are the reference's.  ``init_params`` draws
them from a ``torch.Generator`` with the same fan-in scaling (truncated
normal on [-2, 2], std = scale / sqrt(fan_in), a leading "layers" stack
axis excluded from the fan-in).  The values differ from JAX's for the
same seed (another generator); tests that compare the two frameworks
bridge the JAX weights in (``checkpoint/bridge.py``).

Weights are cast once, when they are loaded, to the model's compute
dtype (``cfg.dtype``, bf16 for the served models).  The JAX model keeps
fp32 masters (``param_dtype="float32"``) and casts them with
``.astype(dtype)`` at every use, so every product sees the same bf16
values either way; casting once halves the memory the weights hold (a
9.4 B-parameter target is ~19 GB in bf16 instead of ~38 GB in fp32).

``ParamTree`` holds such a tree as an ``nn.Module`` (the target model
and the draft are ``ParamTree``s), indexable like the JAX pytree
(``params["body"]["pos0"]["mix"]["wq"]``), stacked ``(L, ...)`` layer
leaves included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axis names + init scheme."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed | scaled
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _fan_in(shape: Tuple[int, ...]) -> int:
    # Last axis is the output axis by convention (x @ W with W (in, out)).
    if len(shape) <= 1:
        return shape[0] if shape else 1
    return int(np.prod(shape[:-1]))


def init_leaf(spec: ParamSpec, gen: torch.Generator, device,
              dtype: torch.dtype) -> torch.Tensor:
    """One leaf, drawn in fp32 one layer slice at a time (so a large
    stacked leaf never needs an fp32 copy of itself) and stored in
    ``dtype``."""
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    if spec.init == "zeros":
        return out.zero_()
    if spec.init == "ones":
        return out.fill_(1.0)
    stacked = bool(spec.axes) and spec.axes[0] == "layers"
    if spec.init == "embed":
        std = 0.02 * spec.scale
    else:
        std = spec.scale / math.sqrt(
            _fan_in(spec.shape[1:] if stacked else spec.shape))
    slices = [out[i] for i in range(spec.shape[0])] if stacked else [out]
    for sl in slices:
        tmp = torch.empty(sl.shape, dtype=torch.float32, device=device)
        if spec.init == "embed":
            tmp.normal_(0.0, 1.0, generator=gen)
        else:
            nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
        sl.copy_(tmp.mul_(std))
    return out


def init_params(specs, gen: torch.Generator, device,
                dtype: torch.dtype) -> Dict[str, Any]:
    """Materialise a nested dict of ``ParamSpec`` into tensors, leaves in
    sorted-key order (the JAX pytree order)."""
    if isinstance(specs, ParamSpec):
        return init_leaf(specs, gen, device, dtype)
    return {k: init_params(specs[k], gen, device, dtype)
            for k in sorted(specs)}


def count_params(specs) -> int:
    if isinstance(specs, ParamSpec):
        return int(np.prod(specs.shape))
    return sum(count_params(v) for v in specs.values())


def map_specs(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: sub-dicts become
    child modules, tensors frozen ``nn.Parameter``s.  Indexing with
    ``[key]`` and ``get`` mirror the JAX dict pytree."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def flat(self) -> Dict[str, torch.Tensor]:
        """``{'/'-joined key: tensor}`` — the keys of the JAX package's
        ``checkpoint/ckpt.py`` ``_flatten``."""
        return {name.replace(".", "/"): p.data
                for name, p in self.named_parameters()}


def unflatten(flat: Dict[str, Any]) -> dict:
    """``{'a/b/c': x}`` -> ``{'a': {'b': {'c': x}}}``."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def check_tree(specs, tree, prefix: str = ""):
    """Raise unless ``tree``'s keys and leaf shapes are exactly
    ``specs``'s."""
    if isinstance(specs, ParamSpec):
        if tuple(tree.shape) != tuple(specs.shape):
            raise ValueError(f"{prefix}: shape {tuple(tree.shape)} != "
                             f"{specs.shape}")
        return
    if set(tree) != set(specs):
        raise ValueError(f"{prefix or '<root>'}: keys {sorted(tree)} != "
                         f"{sorted(specs)}")
    for k in specs:
        check_tree(specs[k], tree[k], f"{prefix}/{k}" if prefix else k)
