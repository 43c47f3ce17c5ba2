"""Target model, dense attention path (port of the ATTN-group part of
``repro/models/transformer.py``).

Parameters keep the JAX layout: each layer group holds stacked ``(L, ...)``
leaves (``stack_specs``), and the forward passes loop over layers in
Python where JAX scans.  The cache is the same nested dict of tensors as
the reference's (``{"lengths", "pad", "body": {"pos0": {"k", "v"}}}``
with ``(L, B, max_len, Hk, D)`` leaves).  JAX's buffer donation becomes
in-place updates: ``decode_step`` writes the new block's K/V into the
live cache tensors and returns the same tensors.

Paged caches (``init_cache(..., page_size=P, num_pages=NP)``) hold
``(L, NP + 1, P, Hk, D)`` page pools and one ``page_tbl`` (B, max_len // P)
block table instead; ``decode_step`` writes and attends through the
table, and ``prefill(..., pools=, tbl_rows=)`` writes the prompt's K/V
straight into the pools (no dense K/V is built).

Entry points: ``param_specs`` / ``init``, ``prefill``, ``decode_step``
(chain or draft tree), ``commit_cache``, ``init_cache``, ``paged_check``,
``tree_check``.  Only attention mixers
with the SwiGLU FFN are ported; other block kinds raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import (ATTN, ATTN_SW, FFN_SWIGLU, BlockDef,
                                       ModelConfig)
from repro_torch.models.layers import (LAYERS, embed, embed_specs, ffn,
                                       ffn_specs, head_specs, lm_head,
                                       rmsnorm, rmsnorm_specs)
from repro_torch.models.param import (ParamSpec, ParamTree, init_params,
                                      map_specs, unflatten)


# ===================================================================== specs
def _check_block(blk: BlockDef):
    if blk.mixer not in (ATTN, ATTN_SW) or blk.ffn != FFN_SWIGLU or blk.cross:
        raise NotImplementedError(
            f"block {blk} is not ported yet: the port runs attention "
            "mixers with the SwiGLU FFN (ROADMAP queue 1: other "
            "model families)")


def layer_specs(cfg: ModelConfig, blk: BlockDef) -> dict:
    _check_block(blk)
    d = cfg.d_model
    return {"norm1": rmsnorm_specs(d), "mix": attn.attn_specs(cfg),
            "norm2": rmsnorm_specs(d), "ffn": ffn_specs(cfg, blk.ffn)}


def stack_specs(specs, n: int):
    return map_specs(
        lambda p: ParamSpec((n,) + p.shape, (LAYERS,) + p.axes, p.init,
                            p.scale), specs)


def model_groups(cfg: ModelConfig) -> List[Tuple[str, Tuple[BlockDef, ...], int]]:
    """Decoder groups as (name, pattern, repeats)."""
    if cfg.prologue or cfg.encoder_layers or cfg.num_image_tokens:
        raise NotImplementedError(
            f"{cfg.name}: prologue/encoder/image groups are not ported yet "
            "(ROADMAP queue 1: other model families)")
    for blk in cfg.pattern:
        _check_block(blk)
    return [("body", cfg.pattern, cfg.num_pattern_repeats)]


def param_specs(cfg: ModelConfig) -> dict:
    specs: Dict[str, Any] = {"embed": embed_specs(cfg),
                             "final_norm": rmsnorm_specs(cfg.d_model)}
    if not cfg.tie_embeddings:
        specs["head"] = head_specs(cfg)
    for name, pattern, repeats in model_groups(cfg):
        specs[name] = {f"pos{i}": stack_specs(layer_specs(cfg, blk), repeats)
                       for i, blk in enumerate(pattern)}
    return specs


def init(cfg: ModelConfig, seed: int = 0, *, device) -> ParamTree:
    """Random target weights from a seeded ``torch.Generator`` on
    ``device``, stored in ``cfg.dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return ParamTree(init_params(param_specs(cfg), gen, device,
                                 cfg.act_dtype))


def _slices(group, repeats: int, pi: int):
    """Per-layer parameter dicts of one pattern position: every stacked
    leaf indexed at its layer (views, no copies)."""
    flat = group[f"pos{pi}"].flat()
    return [unflatten({k: v[i] for k, v in flat.items()})
            for i in range(repeats)]


# ============================================================== layer apply
def apply_layer_prefill(cfg: ModelConfig, p, x, positions, pad, pools=None,
                        tbl_rows=None):
    """Returns (x, (k, v)).  ``pools``/``tbl_rows``: the paged prefill
    (``attention.self_attention_prefill``)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, kv = attn.self_attention_prefill(cfg, p["mix"], h, positions, pad,
                                          pools=pools, tbl_rows=tbl_rows)
    x = x + out
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + ffn(p["ffn"], h2), kv


def apply_layer_decode(cfg: ModelConfig, p, x, k_cache, v_cache, lengths,
                       pad, page_tbl=None, tree=None):
    """Writes this layer's new K/V into k_cache/v_cache (or, with
    ``page_tbl``, its page pools) in place.  ``tree=(W, γ)``: the rows
    are a flattened draft tree, scored under the tree-causal mask."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, _ = attn.self_attention_decode(cfg, p["mix"], h, k_cache, v_cache,
                                        lengths, pad, page_tbl=page_tbl,
                                        tree=tree)
    x = x + out
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + ffn(p["ffn"], h2)


# ============================================================= group runner
def _update_caps(caps, cap_targets, lidx: int, x):
    for j, tgt in enumerate(cap_targets):
        if lidx == tgt:
            caps[j] = x
    return caps


def run_group_prefill(cfg, group_params, pattern, repeats, x, positions,
                      pad, base_idx: int, cap_targets, max_len: int, caps,
                      pool_group=None, tbl_rows=None):
    """Loop over the group's layers.  Returns (x, cache_group, caps);
    with ``pool_group`` (the live paged cache's group) each layer writes
    its K/V through ``tbl_rows`` into the pools and cache_group is
    None."""
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill len {s} > max_len {max_len}")
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    cache_group = None
    if pool_group is None:
        cache_group = {}
        for pi in range(len(pattern)):
            shape = (repeats, b, max_len, hk, hd)
            cache_group[f"pos{pi}"] = {
                "k": torch.zeros(shape, dtype=x.dtype, device=x.device),
                "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    per_pos = [_slices(group_params, repeats, pi) for pi in range(len(pattern))]
    for i in range(repeats):
        for pi in range(len(pattern)):
            pools = None
            if pool_group is not None:
                entry = pool_group[f"pos{pi}"]
                pools = (entry["k"][i], entry["v"][i])
            x, (k, v) = apply_layer_prefill(cfg, per_pos[pi][i], x,
                                            positions, pad, pools, tbl_rows)
            if cache_group is not None:
                entry = cache_group[f"pos{pi}"]
                entry["k"][i, :, :s] = k
                entry["v"][i, :, :s] = v
            caps = _update_caps(caps, cap_targets,
                                base_idx + i * len(pattern) + pi, x)
    return x, cache_group, caps


def run_group_decode(cfg, group_params, pattern, repeats, x, cache_group,
                     lengths, pad, base_idx: int, cap_targets, caps,
                     page_tbl=None, tree=None):
    per_pos = [_slices(group_params, repeats, pi) for pi in range(len(pattern))]
    for i in range(repeats):
        for pi in range(len(pattern)):
            entry = cache_group[f"pos{pi}"]
            x = apply_layer_decode(cfg, per_pos[pi][i], x, entry["k"][i],
                                   entry["v"][i], lengths, pad, page_tbl,
                                   tree)
            caps = _update_caps(caps, cap_targets,
                                base_idx + i * len(pattern) + pi, x)
    return x, caps


# ================================================================ entry pts
def _caps_to_features(caps):
    """3 x (B, T, D) -> (B, T, 3D) EAGLE-3 concatenated capture features."""
    c = torch.stack(caps)                                  # (3, B, T, D)
    n, b, t, d = c.shape
    return c.permute(1, 2, 0, 3).reshape(b, t, n * d)


def _run_groups(cfg, params, x, runner):
    caps = [torch.zeros_like(x) for _ in cfg.captures]
    base = 0
    for name, pattern, repeats in model_groups(cfg):
        x, caps = runner(name, pattern, repeats, x, base, caps)
        base += len(pattern) * repeats
    return x, caps


def prefill(cfg: ModelConfig, params, tokens, *,
            max_len: Optional[int] = None, pad=None, pools=None,
            tbl_rows=None):
    """Prompt pass.  tokens: (B, S); pad: optional (B,) left-pad widths
    (RoPE positions max(arange(S) - pad, 0)).  Returns dict(logits (B,V)
    fp32 at the last position, cache (K/V placed in max_len buffers),
    captures (B, S, 3D)).

    Paged: ``pools`` is a live paged cache (``init_cache(...,
    page_size=P)``) and ``tbl_rows`` (B, n_tbl) the page ids of each
    prompt row; every layer writes its K/V at positions [0, S) of its
    row's pages, in place, and the returned cache holds only
    ``lengths`` and ``pad``."""
    b, s = tokens.shape
    dev = tokens.device
    max_len = max_len or s
    x = embed(params["embed"], tokens, cfg.act_dtype)
    ar = torch.arange(s, device=dev)[None, :]
    if pad is None:
        positions = ar.expand(b, s)
    else:
        positions = torch.clamp(ar - pad[:, None].long(), min=0)
    cache: Dict[str, Any] = {}

    def runner(name, pattern, repeats, x, base, caps):
        x, group, caps = run_group_prefill(
            cfg, params[name], pattern, repeats, x, positions, pad, base,
            cfg.captures, max_len, caps,
            None if pools is None else pools[name], tbl_rows)
        if group is not None:
            cache[name] = group
        return x, caps

    x, caps = _run_groups(cfg, params, x, runner)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(params.get("head"), params["embed"], x[:, -1],
                     cfg.tie_embeddings)
    cache["lengths"] = torch.full((b,), s, dtype=torch.int32, device=dev)
    cache["pad"] = (torch.zeros((b,), dtype=torch.int32, device=dev)
                    if pad is None else pad.to(torch.int32, copy=True))
    return {"logits": logits.float(), "cache": cache,
            "captures": _caps_to_features(caps)}


def decode_step(cfg: ModelConfig, params, cache, tokens, *, tree=None):
    """Verify/decode block: tokens (B, T) at cache positions
    lengths + [0..T).  Writes the block's K/V into ``cache`` in place
    (through ``page_tbl`` when the cache is paged) and returns
    dict(logits (B,T,V) fp32, cache (same tensors, lengths not advanced),
    captures (B,T,3D)).  With ``tree=(W, γ)`` the block is a flattened
    draft tree (T = W·γ + 1) scored in one tree-masked pass."""
    lengths, pad = cache["lengths"], cache["pad"]
    page_tbl = cache.get("page_tbl")
    x = embed(params["embed"], tokens, cfg.act_dtype)

    def runner(name, pattern, repeats, x, base, caps):
        return run_group_decode(cfg, params[name], pattern, repeats, x,
                                cache[name], lengths, pad, base,
                                cfg.captures, caps, page_tbl, tree)

    x, caps = _run_groups(cfg, params, x, runner)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(params.get("head"), params["embed"], x,
                     cfg.tie_embeddings)
    return {"logits": logits.float(), "cache": cache,
            "captures": _caps_to_features(caps)}


def commit_cache(cfg: ModelConfig, cache, n_accept):
    """Accept ``n_accept`` (B,) tokens of the verify block: advance the
    lengths (attention caches need no rollback).  The K/V leaves are
    shared with ``cache``."""
    new = dict(cache)
    new["lengths"] = cache["lengths"] + n_accept.to(torch.int32)
    return new


def paged_check(cfg: ModelConfig, max_len: int, page_size: int):
    """Validate a paged-cache request: the lane window must tile into
    whole pages (the port's mixers are all attention)."""
    model_groups(cfg)
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    if max_len % page_size:
        raise ValueError(
            f"max_len {max_len} must be a multiple of page_size "
            f"{page_size}")


def tree_check(cfg: ModelConfig):
    """Validate a tree-speculation request: the tree verify commits only
    the accepted root path, which needs per-position K/V rollback, so
    attention mixers only (the port runs no other kind)."""
    model_groups(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               page_size: int = 0, num_pages: int = 0) -> dict:
    """Zero-initialised decode cache.  With ``page_size > 0`` the K/V
    leaves are page pools ``(repeats, num_pages + 1, page_size, Hk, D)``
    (page ``num_pages`` is the trash page) and ``page_tbl`` (batch,
    max_len // page_size) maps every entry to the trash page."""
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    cache: Dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pad": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    shape = (batch, max_len, hk, hd)
    if page_size > 0:
        paged_check(cfg, max_len, page_size)
        cache["page_tbl"] = torch.full((batch, max_len // page_size),
                                       num_pages, dtype=torch.int32,
                                       device=device)
        shape = (num_pages + 1, page_size, hk, hd)
    for name, pattern, repeats in model_groups(cfg):
        cache[name] = {
            f"pos{pi}": {k: torch.zeros((repeats,) + shape,
                                        dtype=cfg.act_dtype, device=device)
                         for k in ("k", "v")}
            for pi in range(len(pattern))}
    return cache
