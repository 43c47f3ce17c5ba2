"""Draft model training engine (paper §3.3); port of
``repro/training/draft_trainer.py``.

Consumes ``SignalBatch``es drained from the signal store and fine-tunes
the EAGLE-3 draft on the captured target hidden states: no target
forward pass and no target weights besides the frozen token-embedding
table.  A step is ``eagle.draft_train_loss`` (the draft layer's attention
through the prefill kernel, its gradient through the backward kernel),
``torch.autograd.grad`` and the optimizer's update.

The draft a ``ServingEngine`` serves is a ``ParamTree`` of frozen
parameters; a cycle trains trainable copies of its leaves and returns a
new ``ParamTree`` that ``ServingEngine(cfg, params, dcfg, dparams)`` takes
as it is, leaving the served draft untouched.  The trainer runs on the
card unless it is given ``device="cpu"``, and raises without a card.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eagle
from repro_torch.core.signals import SignalBatch
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamTree, unflatten
from repro_torch.serving.engine import resolve_device
from repro_torch.training.optimizer import Optimizer, adamw


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{'/'-joined key: tensor}`` of a ``ParamTree`` or nested dict, in
    sorted-key order (the JAX pytree's leaf order)."""
    if isinstance(tree, ParamTree):
        return tree.flat()
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


class DraftTrainer:
    """Draft training cycles (one per controller trigger)."""

    def __init__(self, tcfg: ModelConfig, dcfg: ModelConfig, embed_params,
                 opt: Optional[Optimizer] = None, batch_size: int = 8,
                 ttt: bool = True, device=None):
        self.tcfg = tcfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.embed_params = embed_params     # frozen target embeddings
        self.opt = opt or adamw(lr=1e-3, weight_decay=0.0)
        self.batch_size = batch_size
        self.ttt = ttt
        self.log: List[Dict] = []
        # one blocking read per step (the logged loss and accuracy),
        # one for the eval accuracy
        self.host_syncs = 0

    # ---------------------------------------------------------------- data
    @staticmethod
    def _stack(batches: List[SignalBatch]) -> Tuple[np.ndarray, np.ndarray]:
        s = min(b.feats.shape[0] for b in batches)
        feats = np.stack([b.feats[:s] for b in batches])
        toks = np.stack([b.tokens[:s] for b in batches])
        return feats, toks

    def make_arrays(self, batches: List[SignalBatch], eval_frac: float = 0.1):
        """Split collected signals 9:1 into train/eval (paper Alg. 1)."""
        feats, toks = self._stack(batches)
        n = feats.shape[0]
        n_eval = max(1, int(n * eval_frac)) if n > 1 else 0
        return ((feats[:n - n_eval], toks[:n - n_eval]),
                (feats[n - n_eval:], toks[n - n_eval:]))

    def device_arrays(self, feats: np.ndarray, toks: np.ndarray):
        """Host signals on the trainer's device: features in the draft's
        dtype (the loss casts them to it; JAX casts inside the step),
        tokens as int64."""
        return (torch.from_numpy(np.ascontiguousarray(feats)).to(
                    device=self.device, dtype=self.dcfg.act_dtype),
                torch.from_numpy(np.ascontiguousarray(toks)).to(
                    device=self.device, dtype=torch.int64))

    def trainable(self, dparams) -> Dict[str, torch.Tensor]:
        """Trainable copies of a draft's leaves on the trainer's device,
        ``{'/'-joined key: tensor}`` (the served draft's leaves are
        frozen ``nn.Parameter``s and stay untouched)."""
        return {k: t.detach().to(self.device, copy=True).requires_grad_(True)
                for k, t in _flat(dparams).items()}

    # ---------------------------------------------------------------- step
    def loss(self, params, feats, toks, ttt: bool):
        """``eagle.draft_train_loss`` on the flat trainable leaves."""
        return eagle.draft_train_loss(self.dcfg, unflatten(params),
                                      self.embed_params, feats, toks,
                                      ttt=ttt)

    def step(self, params: Dict[str, torch.Tensor], opt_state, feats, toks,
             it: int):
        """One optimizer step on trainable leaves ``params`` (updated in
        place).  Returns (loss, accuracy) as 0-dim device tensors."""
        with torch.enable_grad():
            loss, metrics = self.loss(params, feats, toks, self.ttt)
            grads = torch.autograd.grad(loss, list(params.values()))
        self.opt.update(params, dict(zip(params, grads)), opt_state, it)
        return loss.detach(), metrics["accuracy"]

    # --------------------------------------------------------------- cycle
    def train_cycle(self, dparams, batches: List[SignalBatch], *,
                    epochs: int = 2, min_steps: int = 80,
                    seed: int = 0) -> Dict:
        """One training cycle on the drained signal buffer.  ``epochs`` is
        a floor: small buffers get extra epochs until ``min_steps``
        optimizer steps have run (training until saturation, paper Fig.
        5).  Batches are drawn in the order of
        ``np.random.default_rng(seed).permutation``, as JAX draws them.
        Returns dict(dparams, train_acc, eval_acc, steps, seconds);
        ``dparams`` is a new ``ParamTree`` on the trainer's device."""
        (tf, tt), (ef, et) = self.make_arrays(batches)
        params = self.trainable(dparams)
        opt_state = self.opt.init(params)
        feats, toks = self.device_arrays(tf, tt)
        rng = np.random.default_rng(seed)
        bs = min(self.batch_size, max(tf.shape[0], 1))
        steps_per_epoch = max(tf.shape[0] // bs, 1)
        epochs = max(epochs, -(-min_steps // steps_per_epoch))
        t0 = time.perf_counter()
        it = 0
        last_acc = 0.0
        for _ in range(epochs):
            order = rng.permutation(tf.shape[0])
            order_d = torch.from_numpy(order).to(self.device)
            for s0 in range(0, len(order) - bs + 1, bs):
                ts = time.perf_counter()
                sel = order_d[s0:s0 + bs]
                loss, acc = self.step(params, opt_state, feats[sel],
                                      toks[sel], it)
                loss_f, last_acc = torch.stack([loss.float(), acc]).tolist()
                self.host_syncs += 1
                self.log.append({"it": it, "loss": loss_f, "acc": last_acc,
                                 "batch": order[s0:s0 + bs].tolist(),
                                 "ms": (time.perf_counter() - ts) * 1e3})
                it += 1
        eval_acc = last_acc
        if ef.shape[0]:
            with torch.no_grad():
                _, metrics = self.loss(params, *self.device_arrays(ef, et),
                                       ttt=False)
            eval_acc = float(metrics["accuracy"])
            self.host_syncs += 1
        trained = ParamTree(unflatten({k: t.detach()
                                       for k, t in params.items()}))
        return {"dparams": trained, "train_acc": last_acc,
                "eval_acc": eval_acc, "steps": it,
                "seconds": time.perf_counter() - t0}
