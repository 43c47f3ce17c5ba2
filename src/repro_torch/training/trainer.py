"""Target-model training step (port of ``repro/training/trainer.py``):
microbatch gradient accumulation and remat around
``transformer.forward_train``.

The step is a function (params, opt_state, batch, step) -> (params,
opt_state, metrics) over the optimizer's flat leaves
(``training/optimizer.py``: ``{'/'-joined key: tensor}``, the keys of
``checkpoint/bridge.flat``).  Where JAX returns new arrays, the port
updates the leaves in place and returns the same dict: at glm4-9b's
9.40 B parameters a second copy of the weights would not fit beside the
gradients on one card.  Parameters and gradients stay in the config's
dtype (bf16 on the card); ``n_micro > 1`` accumulates fp32 gradients.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import bridge
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import unflatten
from repro_torch.training.optimizer import Optimizer, adamw, global_norm


def _split_microbatches(batch: Dict, n_micro: int) -> Dict:
    """(B, ...) -> (n_micro, B/n_micro, ...) for every leaf."""
    def sp(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} % microbatches {n_micro} != 0")
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    return {k: sp(v) for k, v in batch.items()}


def trainable(params) -> Dict[str, torch.Tensor]:
    """The flat leaves of a ``ParamTree`` as tensors that require grad and
    share the tree's storage, so a step updates the tree in place."""
    return {k: t.detach().requires_grad_(True)
            for k, t in bridge.flat(params).items()}


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, n_micro: int = 1,
                    moe_impl: str = "sort", remat: bool = True) -> Callable:
    """Build the train step with gradient accumulation over ``n_micro``
    microbatches (fp32 accumulators, each microbatch's gradient divided
    by ``n_micro`` before it is added, in order, as JAX's scan does).
    Metrics: ``loss``, ``ce``, ``accuracy``, ``aux`` and ``grad_norm``,
    0-dim fp32 tensors (no host sync)."""

    def grad_fn(params, mb):
        with torch.enable_grad():
            loss, metrics = T.forward_train(cfg, unflatten(params), mb,
                                            moe_impl=moe_impl, remat=remat)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(params, opt_state, batch, step: int):
        if n_micro == 1:
            loss, metrics, grads = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mbs = _split_microbatches(batch, n_micro)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            zero = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            loss, acc = zero, zero
            for i in range(n_micro):
                l_i, m_i, g_i = grad_fn(params,
                                        {k: v[i] for k, v in mbs.items()})
                for k, g in g_i.items():
                    grads[k].add_(g.float() / n_micro)
                loss = loss + l_i / n_micro
                acc = acc + m_i["accuracy"] / n_micro
                del g_i
            metrics = {"accuracy": acc, "ce": loss, "aux": zero}
        grad_norm = global_norm(grads)
        params, opt_state = opt.update(params, grads, opt_state, step)
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
        return params, opt_state, metrics

    return train_step


def pretrain_target(cfg: ModelConfig, params, corpus, *, steps: int = 200,
                    batch_size: int = 8, lr: float = 3e-3, seed: int = 0,
                    opt: Optional[Optimizer] = None, log_every: int = 0):
    """Quick next-token pretraining of a target on a token matrix (N, S):
    gives the served target structured behaviour, so the draft has
    something learnable to align to.  The batches are JAX's
    (``np.random.default_rng(seed)``); ``adamw(lr, weight_decay=0)``
    unless ``opt`` is given.  ``params`` (a ``ParamTree`` or a nested dict
    of tensors) is trained in place and returned with the per-step
    losses."""
    opt = opt or adamw(lr=lr, weight_decay=0.0)
    step_fn = make_train_step(cfg, opt, n_micro=1, remat=False)
    flat = trainable(params)
    opt_state = opt.init(flat)
    dev = next(iter(flat.values())).device
    rng = np.random.default_rng(seed)
    losses = []
    for it in range(steps):
        sel = rng.integers(0, corpus.shape[0], size=batch_size)
        rows = torch.from_numpy(np.ascontiguousarray(corpus[sel])).to(dev)
        flat, opt_state, m = step_fn(
            flat, opt_state, {"tokens": rows[:, :-1], "targets": rows[:, 1:]},
            it)
        losses.append(float(m["loss"]))
        if log_every and it % log_every == 0:
            print(f"  pretrain step {it}: loss {losses[-1]:.3f}")
    del opt_state
    return params, losses
