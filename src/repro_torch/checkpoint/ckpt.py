"""Parameter checkpoints: flat-key .npz save/load and the draft deploy
gate (port of ``repro/checkpoint/ckpt.py``).

A checkpoint is one ``.npz`` of ``{'/'-joined key: array}``, the keys of
``checkpoint/bridge.py`` (the JAX package's pytree keys), so a file that
either package writes loads into the other.  bf16 leaves are written
widened to fp32 (numpy has no bf16) and cast back to the leaf's dtype on
load.  The ``DraftDeployGate`` hands trained drafts from the training
service to the serving engine (the paper's "deploy if improved" edge).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import bridge
from repro_torch.models.param import ParamTree, unflatten


def save(path: str, tree, metadata: Optional[dict] = None):
    """Atomic save (tmp + rename) of a ``ParamTree`` or a nested dict of
    tensors."""
    flat = bridge.tree_to_numpy(tree)
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz")
    os.close(fd)
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2)


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    # bf16 saved by a writer that knew the type arrives as raw 16-bit
    # words, which the bridge reads as bf16
    return bridge.array_tensor(arr, "cpu").to(device=like.device,
                                              dtype=like.dtype)


def load(path: str, like) -> Any:
    """Load into the structure of ``like`` (a ``ParamTree`` or a nested
    dict of tensors): the same keys, each leaf in ``like``'s dtype and
    on its device.  A shape that differs raises."""
    like_flat = bridge.flat(like)
    out = {}
    with np.load(path) as data:
        for key, leaf in like_flat.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            out[key] = _tensor(arr, leaf)
    if isinstance(like, ParamTree):
        return ParamTree(unflatten(out))
    return _like(like, out)


def _like(tree, flat, prefix: str = ""):
    """``flat``'s tensors in the nesting of ``tree`` (whose own keys may
    hold '/')."""
    if isinstance(tree, torch.Tensor):
        return flat[prefix]
    return {k: _like(v, flat, f"{prefix}/{k}" if prefix else k)
            for k, v in tree.items()}


class DraftDeployGate:
    """Thread-safe draft handoff between training and serving (paper:
    'deployed only if it demonstrates improved acceptance')."""

    def __init__(self, initial_params):
        self._lock = threading.Lock()
        self._params = initial_params
        self.version = 0
        self.deploy_log = []

    def current(self):
        with self._lock:
            return self._params, self.version

    def reset(self, initial_params):
        with self._lock:
            self._params = initial_params
            self.version = 0
            self.deploy_log = []

    def offer(self, new_params, eval_acc: float, baseline_acc: float) -> bool:
        """Deploy iff eval acceptance improved."""
        deploy = eval_acc > baseline_acc
        with self._lock:
            if deploy:
                self._params = new_params
                self.version += 1
            self.deploy_log.append({"eval": eval_acc, "base": baseline_acc,
                                    "deployed": deploy,
                                    "version": self.version})
        return deploy
