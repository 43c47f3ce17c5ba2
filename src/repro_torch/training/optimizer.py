"""Optimizers: AdamW and Adafactor (port of
``repro/training/optimizer.py``), with the same functional interface::

    state = opt.init(params)
    params, state = opt.update(params, grads, state, step)

``params`` and ``grads`` are flat dicts ``{'/'-joined key: tensor}`` (the
keys of ``ParamTree.flat``, in its order, which is the JAX pytree's leaf
order); ``step`` is the Python int of the step (JAX's int32 array).  The
state is a dict of fp32 tensors whose '/'-joined keys are JAX's:
AdamW ``{"m": {key: t}, "v": {key: t}}`` (``m/<key>``), Adafactor
``{key: {"vr", "vc"}}`` for a leaf of two or more dimensions and
``{key: {"v"}}`` otherwise (``<key>/vr``).  ``checkpoint/bridge.py``
carries both to and from numpy.

The arithmetic is JAX's, operation for operation: fp32 moments, the
``t = step + 1`` bias correction computed in fp32, decoupled weight decay
on the fp32 parameter, one cast back to the parameter's dtype (bf16 on
the card: cast once per step, as JAX does).  Unlike JAX, ``update``
works in place: it runs under ``torch.no_grad``, overwrites the moments
and the parameters, and returns the same dicts (the values are the
functional update's; only buffers are reused, which keeps a second copy
of a 0.84 B-parameter draft out of device memory).  Each leaf's update
holds at most two fp32 temporaries of that leaf at once (the gradient
clip, too, goes leaf by leaf), in JAX's operation order: at glm4-9b's
stacked FFN leaves (2.24 B elements, 9.0 GB in fp32) an Adafactor step
fits beside the bf16 weights and gradients on one 80 GB card.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

Flat = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _f32_scalar(x) -> float:
    """A Python float holding an fp32 value (JAX computes these scalars
    as fp32 arrays)."""
    return float(np.float32(x))


# ------------------------------------------------------------------ AdamW
def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params: Flat):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"m": zeros, "v": {k: torch.zeros_like(z)
                                  for k, z in zeros.items()}}

    @torch.no_grad()
    def update(params: Flat, grads: Flat, state, step: int):
        # clip_by_global_norm's values, one leaf at a time
        scale = _clip_scale(grads, grad_clip)
        t = np.float32(step) + np.float32(1.0)
        c1 = _f32_scalar(np.float32(1.0) - np.float32(b1) ** t)
        c2 = _f32_scalar(np.float32(1.0) - np.float32(b2) ** t)
        for k, p in params.items():
            g32 = _clipped_f32(grads[k], scale)                 # buffer A
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(g32.square_().mul_(1 - b2))
            upd = torch.div(m, c1)                              # buffer B
            upd.div_(torch.div(v, c2, out=g32).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(g32.copy_(p).mul_(weight_decay))
            p.copy_(g32.copy_(p).sub_(upd.mul_(lr)))
            del g32, upd
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------- Adafactor
def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer & Stern (2018): factored second moment for >=2D params,
    no first moment: O(rows + cols) state per matrix."""

    def init(params: Flat):
        st = {}
        for k, p in params.items():
            if p.dim() >= 2:
                st[k] = {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                           device=p.device),
                         "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           dtype=torch.float32,
                                           device=p.device)}
            else:
                st[k] = {"v": torch.zeros_like(p, dtype=torch.float32)}
        return st

    @torch.no_grad()
    def update(params: Flat, grads: Flat, state, step: int):
        t = np.float32(step) + np.float32(1.0)
        beta2 = _f32_scalar(np.float32(1.0) - t ** np.float32(-decay))
        for k, p in params.items():
            g32 = grads[k].to(torch.float32, copy=True)         # buffer A
            g2 = g32.square().add_(eps)                         # buffer B
            s = state[k]
            if p.dim() >= 2:
                vr = s["vr"].mul_(beta2).add_(g2.mean(dim=-1) * (1 - beta2))
                vc = s["vc"].mul_(beta2).add_(g2.mean(dim=-2) * (1 - beta2))
                del g2
                row_mean = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = (g32.mul_(torch.rsqrt(vr / row_mean + eps)[..., None])
                     .mul_(torch.rsqrt(vc + eps)[..., None, :]))
            else:
                v = s["v"].mul_(beta2).add_(g2.mul_(1 - beta2))
                del g2
                u = g32.mul_(torch.rsqrt(v + eps))
            # update clipping (RMS(u) <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0)).mul_(lr)
            if weight_decay:
                u.add_(p.to(torch.float32, copy=True)
                       .mul_(weight_decay * lr))
            p.copy_(p.to(torch.float32, copy=True).sub_(u))
            del g32, u
        return params, state

    return Optimizer(init, update)


# ------------------------------------------------------------------ utils
def global_norm(tree: Flat) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaves added in
    the dict's order (JAX's leaf order); a 0-dim device tensor (no host
    sync)."""
    sq = None
    for g in tree.values():
        s = torch.sum(torch.square(g.float()))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _clip_scale(grads: Flat, max_norm: float):
    """``clip_by_global_norm``'s scale (a 0-dim device tensor), or None
    when clipping is off."""
    if not max_norm:
        return None
    return torch.clamp(max_norm / torch.clamp(global_norm(grads), min=1e-12),
                       max=1.0)


def _clipped_f32(g: torch.Tensor, scale) -> torch.Tensor:
    """One leaf of ``clip_by_global_norm(grads)`` widened to a new fp32
    tensor: the leaf times ``scale`` in fp32, rounded to the leaf's dtype
    and widened back (the update clips leaf by leaf through this, without
    a clipped copy of every leaf at once)."""
    g32 = g.to(torch.float32, copy=True)
    if scale is None:
        return g32
    g32.mul_(scale)
    if g.dtype != torch.float32:
        g32.copy_(g32.to(g.dtype))
    return g32


def clip_by_global_norm(grads: Flat, max_norm: float) -> Flat:
    """Scale every leaf by min(1, max_norm / max(norm, 1e-12)), cast back
    to the leaf's dtype; the scale stays on the device."""
    scale = _clip_scale(grads, max_norm)
    if scale is None:
        return grads
    return {k: _clipped_f32(g, scale).to(g.dtype) for k, g in grads.items()}
