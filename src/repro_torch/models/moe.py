"""Mixture-of-Experts FFN with top-k routing (port of
``repro/models/moe.py``).

Two dispatch implementations, held to each other and to JAX's in
``tests/test_torch_moe.py``:

* ``sort`` -- the serving path: flatten the (token, choice) assignments,
  sort them by expert (stable), give each its rank within its expert, and
  place the first ``capacity`` of each expert into (E, C, D) slots; run a
  batched expert product; each assignment reads back its slot, weighted
  by its gate.
* ``einsum`` -- the GShard one-hot dispatch (N, E, C), the oracle.

Routing and drops are JAX's: the router runs in fp32, then softmax,
top-k (ties to the lower expert index, as ``jax.lax.top_k``) and the
gates renormalised; the capacity comes from the call's token count,
pad positions and inactive lanes included (``_capacity``), so when
tokens drop a token's output depends on the other tokens of its call,
in JAX as here.

Two choices are the port's own, and neither changes a value:

* The dispatch gathers each slot's token row (unfilled slots read a zero
  row) instead of scattering rows into the slots: the overflow slot
  ``E * C`` of the reference's scatter is never read.  No step reads a
  count back to the host (no boolean mask, no ``bincount``), so a MoE
  layer adds no host sync on the card.
* The combine gathers each token's k contributions and adds them in a
  fixed order (ascending expert, the order in which JAX's
  ``.at[token_of].add`` meets them on the CPU).  On CUDA a scatter-add
  with repeated indices runs on atomics, whose order, and so whose sum,
  changes from run to run.

The expert products are ``torch.bmm`` over (E, C, D), as JAX computes
them with ``jnp.einsum`` outside any Pallas kernel.  The router's
product goes through the ``linear`` the layer is given (``linear_rows``
in the prefill), in fp32.  ``impl="shard_map"`` (JAX's expert-parallel
dispatch over a mesh, ROADMAP queue 1 item 9) takes ``sort``, as JAX's
does when no mesh is set: the port has none.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import FFN_SWIGLU, ModelConfig
from repro_torch.models.layers import EMBED, EXPERTS, MLP, ffn, ffn_specs
from repro_torch.models.param import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_hidden
    specs = {
        "router": ParamSpec((d, e), (EMBED, EXPERTS), scale=0.1),
        "w_gate": ParamSpec((e, d, f), (EXPERTS, EMBED, MLP)),
        "w_up": ParamSpec((e, d, f), (EXPERTS, EMBED, MLP)),
        "w_down": ParamSpec((e, f, d), (EXPERTS, MLP, EMBED)),
    }
    if cfg.num_shared_experts:
        specs["shared"] = ffn_specs(cfg, FFN_SWIGLU,
                                    cfg.moe_hidden * cfg.num_shared_experts)
    return specs


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert: ``n * k / e * cf`` (JAX's order of float
    operations), rounded up to 8, at least 8."""
    c = int(n_tokens * cfg.experts_per_tok / cfg.num_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def router_logits(params, x, linear=torch.matmul):
    """x (N, D) -> (N, E) fp32 router logits, through ``linear``."""
    return linear(x.float(), params["router"].float())


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest of each row, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(cfg: ModelConfig, params, x, linear=torch.matmul):
    """Returns (topk_idx (N, k) int64, topk_gate (N, k) fp32, aux_loss)
    for x (N, D)."""
    probs = torch.softmax(router_logits(params, x, linear), dim=-1)
    gate, idx = _top_k(probs, cfg.experts_per_tok)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss on the primary choice
    e = cfg.num_experts
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return idx, gate, aux


def _experts_ffn(params, xs, dtype):
    """xs: (E, C, D) -> (E, C, D), SwiGLU per expert."""
    g = torch.bmm(xs, params["w_gate"].to(dtype))
    u = torch.bmm(xs, params["w_up"].to(dtype))
    return torch.bmm(F.silu(g) * u, params["w_down"].to(dtype))


def dispatch(cfg: ModelConfig, idx, n: int) -> dict:
    """The sort dispatch of ``n`` tokens' (N, k) expert choices: ``cap``
    (slots an expert), ``keep`` (N*k,) in the flat (token, choice) order
    (False: the assignment drops; an expert's slots go to its
    assignments in that order, JAX's stable ``jnp.argsort``) and
    ``slot`` (N*k,) in that order (``E * cap`` for a dropped one)."""
    k, e = cfg.experts_per_tok, cfg.num_experts
    cap = _capacity(cfg, n)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # each expert's first place in the sorted order
    starts = torch.searchsorted(sorted_e,
                                torch.arange(e, device=idx.device))
    rank = torch.arange(n * k, device=idx.device) - starts[sorted_e]
    keep_sorted = rank < cap
    slot_sorted = torch.where(keep_sorted, sorted_e * cap + rank, e * cap)
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return {"cap": cap, "keep": keep, "slot": slot}


def moe_sort(cfg: ModelConfig, params, x,
             linear=torch.matmul) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch.  x: (B, T, D) -> (out, aux_loss)."""
    dt = x.dtype
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    idx, gate, aux = _route(cfg, params, xf, linear)
    k, e = cfg.experts_per_tok, cfg.num_experts
    dsp = dispatch(cfg, idx, n)
    cap, slot = dsp["cap"], dsp["slot"]
    # each slot's source token (n: the zero row, for unfilled slots);
    # dropped assignments land on the extra entry e * cap, cut off unread
    src = torch.full((e * cap + 1,), n, dtype=torch.long, device=x.device)
    src[slot] = torch.arange(n * k, device=x.device) // k
    rows = torch.cat([xf, xf.new_zeros((1, d))])
    xs = rows[src[:e * cap]].reshape(e, cap, d)
    ys = _experts_ffn(params, xs, dt)
    ysf = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))])
    contrib = (ysf[slot] * gate.reshape(-1, 1).to(dt)).reshape(n, k, d)
    # combine in a fixed order: each token's contributions by ascending
    # expert
    by_e = torch.argsort(idx, dim=-1)
    contrib = contrib.gather(1, by_e[..., None].expand(n, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    out = out.reshape(b, t, d)
    if cfg.num_shared_experts:
        out = out + ffn(params["shared"], x, FFN_SWIGLU, linear)
    return out, aux


def _one_hot(i, n: int):
    """One-hot rows of ``i`` over [0, n), all zero where ``i`` is out of
    range (as ``jax.nn.one_hot``), fp32."""
    return (i[..., None] == torch.arange(n, device=i.device)).float()


def moe_einsum(cfg: ModelConfig, params, x,
               linear=torch.matmul) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot dispatch oracle.  x: (B, T, D) -> (out, aux_loss)."""
    dt = x.dtype
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    idx, gate, aux = _route(cfg, params, xf, linear)
    e, k = cfg.num_experts, cfg.experts_per_tok
    cap = _capacity(cfg, n)
    # position of each (token, choice) within its expert
    flat_oh = F.one_hot(idx, e).reshape(n * k, e)
    pos = torch.cumsum(flat_oh, 0) - flat_oh
    pos_in_e = (pos * flat_oh).sum(-1).reshape(n, k)
    keep = pos_in_e < cap
    disp = ((_one_hot(idx, e) * keep[..., None])[..., None]
            * _one_hot(pos_in_e, cap)[:, :, None, :]).sum(1)   # (N, E, C)
    xs = torch.einsum("nd,nec->ecd", xf.float(), disp).to(dt)
    ys = _experts_ffn(params, xs, dt)
    comb = disp * (gate[..., None, None]
                   * _one_hot(idx, e)[..., None]).sum(1)
    out = torch.einsum("nec,ecd->nd", comb, ys.float())
    out = out.to(dt).reshape(b, t, d)
    if cfg.num_shared_experts:
        out = out + ffn(params["shared"], x, FFN_SWIGLU, linear)
    return out, aux


def moe(cfg: ModelConfig, params, x, impl: str = "sort",
        linear=torch.matmul):
    """The MoE FFN of one layer: (out (B, T, D), aux_loss)."""
    if impl == "einsum":
        return moe_einsum(cfg, params, x, linear)
    return moe_sort(cfg, params, x, linear)
