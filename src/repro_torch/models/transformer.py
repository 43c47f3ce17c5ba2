"""Target model, dense attention path (port of the ATTN-group part of
``repro/models/transformer.py``).

Parameters keep the JAX layout: each layer group holds stacked ``(L, ...)``
leaves (``stack_specs``), and the forward passes loop over layers in
Python where JAX scans.  The cache is the same nested dict of tensors as
the reference's (``{"lengths", "pad", "body": {"pos0": {"k", "v"}}}``
with ``(L, B, max_len, Hk, D)`` leaves).  JAX's buffer donation becomes
in-place updates: ``decode_step`` writes the new block's K/V into the
live cache tensors and returns the same tensors.

Entry points: ``param_specs`` / ``init``, ``prefill``, ``decode_step``,
``commit_cache``, ``init_cache``.  Only attention mixers with the SwiGLU
FFN are ported; other block kinds raise ``NotImplementedError``.
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
def apply_layer_prefill(cfg: ModelConfig, p, x, positions, pad):
    """Returns (x, (k, v))."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, kv = attn.self_attention_prefill(cfg, p["mix"], h, positions, pad)
    x = x + out
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + ffn(p["ffn"], h2), kv


def apply_layer_decode(cfg: ModelConfig, p, x, k_cache, v_cache, lengths,
                       pad):
    """Writes this layer's new K/V into k_cache/v_cache in place."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, _ = attn.self_attention_decode(cfg, p["mix"], h, k_cache, v_cache,
                                        lengths, pad)
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
                      pad, base_idx: int, cap_targets, max_len: int, caps):
    """Loop over the group's layers.  Returns (x, cache_group, caps)."""
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill len {s} > max_len {max_len}")
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    cache_group = {}
    per_pos = [_slices(group_params, repeats, pi) for pi in range(len(pattern))]
    for pi in range(len(pattern)):
        shape = (repeats, b, max_len, hk, hd)
        cache_group[f"pos{pi}"] = {
            "k": torch.zeros(shape, dtype=x.dtype, device=x.device),
            "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    for i in range(repeats):
        for pi in range(len(pattern)):
            x, (k, v) = apply_layer_prefill(cfg, per_pos[pi][i], x,
                                            positions, pad)
            entry = cache_group[f"pos{pi}"]
            entry["k"][i, :, :s] = k
            entry["v"][i, :, :s] = v
            caps = _update_caps(caps, cap_targets,
                                base_idx + i * len(pattern) + pi, x)
    return x, cache_group, caps


def run_group_decode(cfg, group_params, pattern, repeats, x, cache_group,
                     lengths, pad, base_idx: int, cap_targets, caps):
    per_pos = [_slices(group_params, repeats, pi) for pi in range(len(pattern))]
    for i in range(repeats):
        for pi in range(len(pattern)):
            entry = cache_group[f"pos{pi}"]
            x = apply_layer_decode(cfg, per_pos[pi][i], x, entry["k"][i],
                                   entry["v"][i], lengths, pad)
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
            max_len: Optional[int] = None, pad=None):
    """Prompt pass.  tokens: (B, S); pad: optional (B,) left-pad widths
    (RoPE positions max(arange(S) - pad, 0)).  Returns dict(logits (B,V)
    fp32 at the last position, cache (K/V placed in max_len buffers),
    captures (B, S, 3D))."""
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
        x, cache[name], caps = run_group_prefill(
            cfg, params[name], pattern, repeats, x, positions, pad, base,
            cfg.captures, max_len, caps)
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


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """Verify/decode block: tokens (B, T) at cache positions
    lengths + [0..T).  Writes the block's K/V into ``cache`` in place and
    returns dict(logits (B,T,V) fp32, cache (same tensors, lengths not
    advanced), captures (B,T,3D))."""
    lengths, pad = cache["lengths"], cache["pad"]
    x = embed(params["embed"], tokens, cfg.act_dtype)

    def runner(name, pattern, repeats, x, base, caps):
        return run_group_decode(cfg, params[name], pattern, repeats, x,
                                cache[name], lengths, pad, base,
                                cfg.captures, caps)

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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    """Zero-initialised dense decode cache."""
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    cache: Dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pad": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    for name, pattern, repeats in model_groups(cfg):
        cache[name] = {
            f"pos{pi}": {k: torch.zeros((repeats, batch, max_len, hk, hd),
                                        dtype=cfg.act_dtype, device=device)
                         for k in ("k", "v")}
            for pi in range(len(pattern))}
    return cache
