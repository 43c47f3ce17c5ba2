"""Target model, attention and latent-attention mixers (port of the ATTN
and MLA parts of ``repro/models/transformer.py``).

Parameters keep the JAX layout: each layer group holds stacked ``(L, ...)``
leaves (``stack_specs``), and the forward passes loop over layers in
Python where JAX scans.  The groups are JAX's: a config with a
``prologue`` (DeepSeek-V3's dense layers) has a ``pre`` group of its
first block repeated ``len(prologue)`` times before ``body``, and the
EAGLE-3 capture indices run across both.  The cache is the same nested
dict of tensors as the reference's (``{"lengths", "pad", "body": {"pos0":
{"k", "v"}}}`` with ``(L, B, max_len, Hk, D)`` leaves; an MLA layer's
entry is ``{"ckv", "kr"}``, ``(L, B, max_len, R)`` and ``(L, B, max_len,
Dr)``).  JAX's buffer donation becomes in-place updates: ``decode_step``
writes the new block's K/V (or latents) into the live cache tensors and
returns the same tensors.

Paged caches (``init_cache(..., page_size=P, num_pages=NP)``) hold
``(L, NP + 1, P, Hk, D)`` page pools and one ``page_tbl`` (B, max_len // P)
block table instead; ``decode_step`` writes and attends through the
table, and ``prefill(..., pools=, tbl_rows=)`` writes the prompt's K/V
straight into the pools (no dense K/V is built).

Entry points: ``param_specs`` / ``init``, ``prefill``, ``decode_step``
(chain or draft tree), ``commit_cache``, ``init_cache``, ``paged_check``,
``tree_check``, ``train_check``, and ``forward_train`` (the
teacher-forced loss of the target trainer, ``training/trainer.py``).
Attention mixers (``ATTN``, ``ATTN_SW``) and multi-head latent attention
(``MLA``, ``models/mla.py``) with the SwiGLU, GELU or MoE FFN
(``models/moe.py``, its weights under ``moe``) are ported; other block
kinds raise ``NotImplementedError``.  MLA serves dense chain speculation
only, as in JAX: paged KV and draft trees are refused with JAX's errors,
and its training forward is not ported yet (``train_check``).  A MoE
layer's expert capacity comes from the token count of the call (JAX's
``_capacity``), so no shape choice of the port (``last_only``, the
paged prefill) changes the rows a MoE layer sees: the head's rows are
picked after the last layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.checkpoint import bridge
from repro_torch.kernels.linear_rows.ops import linear_rows
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import (ATTN, ATTN_SW, FFN_GELU, FFN_MOE,
                                       FFN_SWIGLU, MLA, BlockDef,
                                       ModelConfig)
from repro_torch.models.layers import (LAYERS, embed, embed_specs, ffn,
                                       ffn_specs, head_specs, lm_head,
                                       rmsnorm, rmsnorm_specs)
from repro_torch.models.param import (ParamSpec, ParamTree, init_params,
                                      map_specs, unflatten)


# ===================================================================== specs
_FFNS = (FFN_SWIGLU, FFN_GELU, FFN_MOE)
_MIXERS = (ATTN, ATTN_SW, MLA)


def _check_block(blk: BlockDef):
    if blk.mixer not in _MIXERS or blk.ffn not in _FFNS or blk.cross:
        raise NotImplementedError(
            f"block {blk} is not ported yet: the port runs attention and "
            "MLA mixers with the SwiGLU, GELU or MoE FFN (ROADMAP queue 1 "
            "item 8: the Mamba, RWKV-6 and cross-attention blocks)")


def layer_specs(cfg: ModelConfig, blk: BlockDef) -> dict:
    _check_block(blk)
    d = cfg.d_model
    mix = mla_mod.mla_specs(cfg) if blk.mixer == MLA \
        else attn.attn_specs(cfg)
    s = {"norm1": rmsnorm_specs(d), "mix": mix, "norm2": rmsnorm_specs(d)}
    if blk.ffn == FFN_MOE:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["ffn"] = ffn_specs(cfg, blk.ffn)
    return s


def stack_specs(specs, n: int):
    return map_specs(
        lambda p: ParamSpec((n,) + p.shape, (LAYERS,) + p.axes, p.init,
                            p.scale), specs)


def model_groups(cfg: ModelConfig) -> List[Tuple[str, Tuple[BlockDef, ...], int]]:
    """Decoder groups as (name, pattern, repeats): JAX's, a ``pre`` group
    of the prologue's first block before ``body`` when there is one."""
    if cfg.encoder_layers or cfg.num_image_tokens:
        raise NotImplementedError(
            f"{cfg.name}: encoder/image groups are not ported yet (ROADMAP "
            "queue 1 item 8: the cross-attention and encoder groups)")
    groups = []
    if cfg.prologue:
        groups.append(("pre", (cfg.prologue[0],), len(cfg.prologue)))
    groups.append(("body", cfg.pattern, cfg.num_pattern_repeats))
    for _, pattern, _ in groups:
        for blk in pattern:
            _check_block(blk)
    return groups


def _entry_shapes(cfg: ModelConfig, blk: BlockDef, batch: int,
                  max_len: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's dense cache entry, leaf -> shape (JAX's
    ``_entry_shape``): K/V rows for attention, the latents for MLA."""
    if blk.mixer == MLA:
        return {"ckv": (batch, max_len, cfg.kv_lora_rank),
                "kr": (batch, max_len, cfg.qk_rope_head_dim)}
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


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


def _train_slices(group, repeats: int, pi: int):
    """``_slices`` for a training forward: every stacked leaf unbound
    once, so that its gradient is one stacked tensor made by a single
    ``unbind`` backward (indexing ``v[i]`` would make each layer's
    backward allocate a zero tensor of the whole leaf)."""
    parts = {k: v.unbind(0)
             for k, v in bridge.flat(group[f"pos{pi}"]).items()}
    return [unflatten({k: u[i] for k, u in parts.items()})
            for i in range(repeats)]


# ============================================================== layer apply
def apply_ffn(cfg: ModelConfig, blk: BlockDef, p, h, linear=torch.matmul,
              moe_impl: str = "sort"):
    """The layer's FFN on ``h`` (B, T, D): (out, aux), aux a 0-dim fp32
    tensor for a MoE block (its load-balance loss), else None.  Serving
    takes the sort dispatch; ``moe_impl`` is ``forward_train``'s."""
    if blk.ffn == FFN_MOE:
        return moe_mod.moe(cfg, p["moe"], h, moe_impl, linear)
    return ffn(p["ffn"], h, blk.ffn, linear), None


def apply_layer_prefill(cfg: ModelConfig, blk: BlockDef, p, x, positions,
                        pad, pools=None, tbl_rows=None, *, linear):
    """Returns (x, cache entry, aux), the entry {"k", "v"} (B, S, Hk, D)
    or, for MLA, {"ckv", "kr"} (B, S, R) and (B, S, Dr).
    ``pools``/``tbl_rows``: the paged prefill
    (``attention.self_attention_prefill``; attention mixers only).
    ``linear``: the matrix product of the projections, the FFN and the
    router."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if blk.mixer == MLA:
        out, (ckv, kr) = mla_mod.mla_prefill(cfg, p["mix"], h, positions,
                                             pad, linear=linear)
        entry = {"ckv": ckv, "kr": kr}
    else:
        out, (k, v) = attn.self_attention_prefill(
            cfg, p["mix"], h, positions, pad, pools=pools,
            tbl_rows=tbl_rows, linear=linear)
        entry = {"k": k, "v": v}
    x = x + out
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    out2, aux = apply_ffn(cfg, blk, p, h2, linear)
    return x + out2, entry, aux


def apply_layer_decode(cfg: ModelConfig, blk: BlockDef, p, x, entry,
                       lengths, pad, page_tbl=None, tree=None,
                       linear=torch.matmul):
    """``entry``: this layer's cache leaves, {"k", "v"} (B, Smax, Hk, D)
    (with ``page_tbl``, its page pools) or, for MLA, {"ckv", "kr"};
    the new block's K/V or latents are written into them in place.
    ``tree=(W, γ)``: the rows are a flattened draft tree, scored under
    the tree-causal mask (attention mixers only).  ``linear``: the
    matrix product of the projections, the FFN and the router."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if blk.mixer == MLA:
        if page_tbl is not None or tree is not None:
            what = "tree speculation" if tree else "paged KV cache"
            raise ValueError(f"{what} supports attention mixers only; "
                             f"config has {blk.mixer!r}")
        out, _ = mla_mod.mla_decode(cfg, p["mix"], h, entry["ckv"],
                                    entry["kr"], lengths, pad, linear=linear)
    else:
        out, _ = attn.self_attention_decode(
            cfg, p["mix"], h, entry["k"], entry["v"], lengths, pad,
            page_tbl=page_tbl, tree=tree, linear=linear)
    x = x + out
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + apply_ffn(cfg, blk, p, h2, linear)[0]


def apply_layer_train(cfg: ModelConfig, blk: BlockDef, moe_impl: str, p, x):
    """One layer of the training forward: causal over positions [0, S),
    products through ``torch.matmul``, the attention through
    ``attention.self_attention_train`` (the prefill kernel storing its
    LSE, its gradient the backward kernel).  Returns (x, aux), aux a
    0-dim fp32 tensor (0 for a dense FFN).  An MLA block raises
    (``train_check``)."""
    if blk.mixer == MLA:
        raise NotImplementedError(_MLA_TRAIN)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attn.self_attention_train(cfg, p["mix"], h)
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, aux = apply_ffn(cfg, blk, p, h2, moe_impl=moe_impl)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


# ============================================================= group runner
def _update_caps(caps, cap_targets, lidx: int, x):
    for j, tgt in enumerate(cap_targets):
        if lidx == tgt:
            caps[j] = x
    return caps


def run_group_prefill(cfg, group_params, pattern, repeats, x, positions,
                      pad, base_idx: int, cap_targets, max_len: int, caps,
                      pool_group=None, tbl_rows=None):
    """Loop over the group's layers.  Returns (x, cache_group, caps,
    aux); with ``pool_group`` (the live paged cache's group) each layer
    writes its K/V through ``tbl_rows`` into the pools and cache_group
    is None.  ``aux``: the MoE layers' summed load-balance loss (None
    without a MoE layer)."""
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill len {s} > max_len {max_len}")
    cache_group = None
    if pool_group is None:
        cache_group = {
            f"pos{pi}": {leaf: torch.zeros((repeats,) + shape,
                                           dtype=x.dtype, device=x.device)
                         for leaf, shape in _entry_shapes(
                             cfg, blk, b, max_len).items()}
            for pi, blk in enumerate(pattern)}
    per_pos = [_slices(group_params, repeats, pi) for pi in range(len(pattern))]
    aux = None
    for i in range(repeats):
        for pi, blk in enumerate(pattern):
            pools = None
            if pool_group is not None:
                entry = pool_group[f"pos{pi}"]
                pools = (entry["k"][i], entry["v"][i])
            x, new, a = apply_layer_prefill(
                cfg, blk, per_pos[pi][i], x, positions, pad, pools,
                tbl_rows, linear=linear_rows)
            if a is not None:
                aux = a if aux is None else aux + a
            if cache_group is not None:
                for leaf, t in new.items():
                    cache_group[f"pos{pi}"][leaf][i, :, :s] = t
            caps = _update_caps(caps, cap_targets,
                                base_idx + i * len(pattern) + pi, x)
    return x, cache_group, caps, aux


def run_group_decode(cfg, group_params, pattern, repeats, x, cache_group,
                     lengths, pad, base_idx: int, cap_targets, caps,
                     page_tbl=None, tree=None, linear=torch.matmul):
    per_pos = [_slices(group_params, repeats, pi) for pi in range(len(pattern))]
    for i in range(repeats):
        for pi, blk in enumerate(pattern):
            entry = {leaf: t[i] for leaf, t in
                     cache_group[f"pos{pi}"].items()}
            x = apply_layer_decode(cfg, blk, per_pos[pi][i], x, entry,
                                   lengths, pad, page_tbl, tree, linear)
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
    captures (B, S, 3D), aux (the MoE layers' load-balance loss, a
    0-dim fp32 tensor)).  Its matrix products whose row count is the
    refill's (the projections, the dense FFN, the router and the
    last-position LM head) run through ``linear_rows``, so a prompt's
    rows do not depend on the prompts that share its refill (a MoE
    layer's do through its capacity, as in JAX).

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
    auxes = []

    def runner(name, pattern, repeats, x, base, caps):
        x, group, caps, aux = run_group_prefill(
            cfg, params[name], pattern, repeats, x, positions, pad, base,
            cfg.captures, max_len, caps,
            None if pools is None else pools[name], tbl_rows)
        if group is not None:
            cache[name] = group
        if aux is not None:
            auxes.append(aux)
        return x, caps

    x, caps = _run_groups(cfg, params, x, runner)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(params.get("head"), params["embed"], x[:, -1],
                     cfg.tie_embeddings, linear=linear_rows)
    cache["lengths"] = torch.full((b,), s, dtype=torch.int32, device=dev)
    cache["pad"] = (torch.zeros((b,), dtype=torch.int32, device=dev)
                    if pad is None else pad.to(torch.int32, copy=True))
    aux = sum(auxes[1:], auxes[0]) if auxes else torch.zeros(
        (), dtype=torch.float32, device=dev)
    return {"logits": logits.float(), "cache": cache,
            "captures": _caps_to_features(caps), "aux": aux}


def decode_step(cfg: ModelConfig, params, cache, tokens, *, tree=None,
                linear=torch.matmul, last_only: bool = False):
    """Verify/decode block: tokens (B, T) at cache positions
    lengths + [0..T).  Writes the block's K/V into ``cache`` in place
    (through ``page_tbl`` when the cache is paged) and returns
    dict(logits (B,T,V) fp32, cache (same tensors, lengths not advanced),
    captures (B,T,3D)).  With ``tree=(W, γ)`` the block is a flattened
    draft tree (T = W·γ + 1) scored in one tree-masked pass.

    ``linear`` computes every matrix product, the LM head's included
    (a chunked refill's continuation passes ``linear_rows``, as the
    prefill does).  ``last_only``: the LM head runs on the last position
    alone and ``logits`` is (B, V), the row the prefill returns (through
    ``linear_rows`` a row's value does not depend on the rows beside
    it); every layer, a MoE layer's capacity included, still sees all
    B·T rows."""
    lengths, pad = cache["lengths"], cache["pad"]
    page_tbl = cache.get("page_tbl")
    x = embed(params["embed"], tokens, cfg.act_dtype)

    def runner(name, pattern, repeats, x, base, caps):
        return run_group_decode(cfg, params[name], pattern, repeats, x,
                                cache[name], lengths, pad, base,
                                cfg.captures, caps, page_tbl, tree, linear)

    x, caps = _run_groups(cfg, params, x, runner)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(params.get("head"), params["embed"],
                     x[:, -1] if last_only else x, cfg.tie_embeddings,
                     linear=linear)
    return {"logits": logits.float(), "cache": cache,
            "captures": _caps_to_features(caps)}


def commit_cache(cfg: ModelConfig, cache, n_accept):
    """Accept ``n_accept`` (B,) tokens of the verify block: advance the
    lengths (attention caches need no rollback).  The K/V leaves are
    shared with ``cache``."""
    new = dict(cache)
    new["lengths"] = cache["lengths"] + n_accept.to(torch.int32)
    return new


# ================================================================= training
_MLA_TRAIN = ("the MLA training forward and its backward kernel are not "
              "ported yet (ROADMAP queue 1 item 8)")


def train_check(cfg: ModelConfig):
    """Validate a training request (``forward_train``, the train CLI, the
    serve CLI's target pretraining): an MLA block raises
    ``NotImplementedError`` naming ROADMAP queue 1 item 8, before any
    weight is made or any layer runs."""
    for _, pattern, _ in model_groups(cfg):
        if any(blk.mixer == MLA for blk in pattern):
            raise NotImplementedError(f"{cfg.name}: {_MLA_TRAIN}")


def forward_train(cfg: ModelConfig, params, batch, *, moe_impl: str = "sort",
                  remat: bool = True):
    """Teacher-forced LM loss (JAX ``models/transformer.py:428``).  batch:
    {"tokens" (B, S), "targets" (B, S)} integer tensors; a target < 0 is
    masked out of the loss and the accuracy.  ``params``: a ``ParamTree``
    or a nested dict of tensors (a trainer's leaves that require grad).
    ``remat=True`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as JAX's
    ``jax.checkpoint`` does.  ``moe_impl``: the MoE layers' dispatch
    (``models/moe.py``).  Returns (loss, {"ce", "aux", "accuracy"}),
    0-dim fp32 tensors: the loss is ce + aux, aux the MoE layers' summed
    load-balance loss (0 without one), the accuracy detached.  An MLA
    config raises (``train_check``)."""
    train_check(cfg)
    tokens, targets = batch["tokens"], batch["targets"].long()
    x = embed(params["embed"], tokens, cfg.act_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, pattern, repeats in model_groups(cfg):
        per_pos = [_train_slices(params[name], repeats, pi)
                   for pi in range(len(pattern))]
        for i in range(repeats):
            for pi, blk in enumerate(pattern):
                if remat:
                    x, a = torch.utils.checkpoint.checkpoint(
                        apply_layer_train, cfg, blk, moe_impl,
                        per_pos[pi][i], x, use_reentrant=False)
                else:
                    x, a = apply_layer_train(cfg, blk, moe_impl,
                                             per_pos[pi][i], x)
                aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(params.get("head"), params["embed"], x,
                     cfg.tie_embeddings).float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = (targets >= 0).float()
    tgt = torch.clamp(targets, min=0)
    ll = logits.gather(-1, tgt[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = ((logz - ll) * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == tgt).float() * mask).sum() / denom
    return ce + aux, {"ce": ce, "aux": aux, "accuracy": acc}


def _attention_only(cfg: ModelConfig, what: str):
    for _, pattern, _ in model_groups(cfg):
        for blk in pattern:
            if blk.mixer not in (ATTN, ATTN_SW):
                raise ValueError(f"{what} supports attention mixers only; "
                                 f"config has {blk.mixer!r}")


def paged_check(cfg: ModelConfig, max_len: int, page_size: int):
    """Validate a paged-cache request: the lane window must tile into
    whole pages, and paging covers attention K/V pools only, so every
    mixer must be ``ATTN``/``ATTN_SW`` (an MLA config raises JAX's
    ``ValueError``)."""
    model_groups(cfg)
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    if max_len % page_size:
        raise ValueError(
            f"max_len {max_len} must be a multiple of page_size "
            f"{page_size}")
    _attention_only(cfg, "paged KV cache")


def tree_check(cfg: ModelConfig):
    """Validate a tree-speculation request: the tree verify commits only
    the accepted root path, which needs per-position K/V rollback, so
    attention mixers only (an MLA config raises JAX's ``ValueError``)."""
    _attention_only(cfg, "tree speculation")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               page_size: int = 0, num_pages: int = 0) -> dict:
    """Zero-initialised decode cache.  With ``page_size > 0`` the K/V
    leaves are page pools ``(repeats, num_pages + 1, page_size, Hk, D)``
    (page ``num_pages`` is the trash page) and ``page_tbl`` (batch,
    max_len // page_size) maps every entry to the trash page."""
    cache: Dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pad": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if page_size > 0:
        paged_check(cfg, max_len, page_size)
        cache["page_tbl"] = torch.full((batch, max_len // page_size),
                                       num_pages, dtype=torch.int32,
                                       device=device)
    pool = (num_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    for name, pattern, repeats in model_groups(cfg):
        group = {}
        for pi, blk in enumerate(pattern):
            shapes = ({"k": pool, "v": pool} if page_size > 0
                      else _entry_shapes(cfg, blk, batch, max_len))
            group[f"pos{pi}"] = {
                leaf: torch.zeros((repeats,) + shape, dtype=cfg.act_dtype,
                                  device=device)
                for leaf, shape in shapes.items()}
        cache[name] = group
    return cache
