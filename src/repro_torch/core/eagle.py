"""EAGLE-3 draft model, chain drafting (port of ``repro/core/eagle.py``).

One decoder layer + LM head over the target's concatenated low/mid/high
capture features (3·D, fused to D) and the embedding of the most recent
token; during chain drafting the draft's own hidden state stands in for
the target feature.  The draft shares the target's token embedding.

The draft cache is a dense dict ``{"k", "v": (B, max_len, Hk, D),
"lengths", "pad"}``.  ``draft_extend`` / ``draft_propose`` write their K/V
rows into it in place (JAX donates the buffers) and return a new dict
with the advanced lengths.  Only greedy drafting is ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ATTN, FFN_SWIGLU, BlockDef, ModelConfig
from repro_torch.models.layers import (EMBED, MLP, embed, ffn, ffn_specs,
                                       rmsnorm, rmsnorm_specs)
from repro_torch.models.param import (ParamSpec, ParamTree, count_params,
                                      init_params)


def draft_config(tcfg: ModelConfig) -> ModelConfig:
    """Draft architecture derived from the target: 1 decoder layer, same
    d_model/vocab, small GQA."""
    bound = max(min(tcfg.num_heads, tcfg.d_model // 64), 1)
    heads = next(h for h in range(bound, 0, -1) if tcfg.d_model % h == 0)
    kv = min(tcfg.num_kv_heads, heads)
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        tcfg,
        name=tcfg.name + "-eagle3",
        family="dense",
        num_layers=1,
        prologue=(),
        pattern=(BlockDef(ATTN, FFN_SWIGLU),),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=tcfg.d_model // heads,
        d_ff=2 * tcfg.d_model,
        num_experts=0,
        experts_per_tok=0,
        num_shared_experts=0,
        encoder_layers=0,
        num_image_tokens=0,
        q_lora_rank=0,
        kv_lora_rank=0,
        window=0,
        capture_layers=(0, 0, 0),
    )


def draft_specs(dcfg: ModelConfig) -> dict:
    d, v = dcfg.d_model, dcfg.vocab_size
    return {
        "fuse": ParamSpec((3 * d, d), (MLP, EMBED)),
        "fc": ParamSpec((2 * d, d), (MLP, EMBED)),
        "norm1": rmsnorm_specs(d),
        "attn": attn.attn_specs(dcfg),
        "norm2": rmsnorm_specs(d),
        "ffn": ffn_specs(dcfg, FFN_SWIGLU),
        "final_norm": rmsnorm_specs(d),
        "head": {"w": ParamSpec((d, v), (EMBED, "vocab"))},
    }


def draft_init(dcfg: ModelConfig, seed: int = 0, *, device) -> ParamTree:
    """Random draft weights from a seeded ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return ParamTree(init_params(draft_specs(dcfg), gen, device,
                                 dcfg.act_dtype))


def draft_param_count(dcfg: ModelConfig) -> int:
    return count_params(draft_specs(dcfg))


# ------------------------------------------------------------ core layer
def _layer(dcfg: ModelConfig, p, x, k_cache, v_cache, lengths, pad):
    """One decoder layer over new positions (decode form, in-place cache
    write)."""
    h = rmsnorm(p["norm1"], x, dcfg.norm_eps)
    out, _ = attn.self_attention_decode(dcfg, p["attn"], h, k_cache, v_cache,
                                        lengths, pad)
    x = x + out
    h2 = rmsnorm(p["norm2"], x, dcfg.norm_eps)
    return x + ffn(p["ffn"], h2)


def _head(dcfg, dparams, x):
    return (x @ dparams["head"]["w"]).float()


def _fuse_inputs(dcfg, dparams, feats, tok_emb):
    """feats: (B,T,3D) target captures (or (B,T,D) self features);
    tok_emb: (B,T,D).  Returns fc([fused; emb]).  The 3D→D fuse is the
    sum of three D-contraction products, one per capture level, as in
    the reference."""
    dt = tok_emb.dtype
    d = dcfg.d_model
    if feats.shape[-1] == 3 * d:
        w = dparams["fuse"]
        f = feats.to(dt)
        fused = sum(f[..., i * d:(i + 1) * d] @ w[i * d:(i + 1) * d]
                    for i in range(3))
    else:
        fused = feats.to(dt)
    x = torch.cat([fused, tok_emb], dim=-1)
    return x @ dparams["fc"]


# ------------------------------------------------------------- cache
def init_draft_cache(dcfg: ModelConfig, batch: int, max_len: int, *,
                     device) -> dict:
    hk, hd = dcfg.num_kv_heads, dcfg.head_dim
    z = dict(dtype=dcfg.act_dtype, device=device)
    return {
        "k": torch.zeros((batch, max_len, hk, hd), **z),
        "v": torch.zeros((batch, max_len, hk, hd), **z),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pad": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ------------------------------------------------------- serving functions
def draft_extend(dcfg: ModelConfig, dparams, embed_params, dcache, feats,
                 tokens, advance):
    """Append ``T`` (feature, token) pairs to the draft cache.

    feats: (B, T, 3D) target captures; tokens: (B, T) the tokens
    following each feature position; advance: (B,) how many are valid.
    Returns (logits (B,T,V), h (B,T,D), dcache')."""
    tok_emb = embed(embed_params, tokens, dcfg.act_dtype)
    x = _fuse_inputs(dcfg, dparams, feats, tok_emb)
    x = _layer(dcfg, dparams, x, dcache["k"], dcache["v"],
               dcache["lengths"], dcache["pad"])
    h = rmsnorm(dparams["final_norm"], x, dcfg.norm_eps)
    logits = _head(dcfg, dparams, h)
    new_cache = dict(dcache, lengths=dcache["lengths"] + advance.to(torch.int32))
    return logits, h, new_cache


def draft_propose(dcfg: ModelConfig, dparams, embed_params, dcache, h_last,
                  first_logits, gamma: int, *, greedy: bool = True):
    """Chain-draft γ tokens greedily.  h_last: (B, D) draft hidden at the
    last verified position; first_logits: (B, V) draft logits there.

    Returns (draft_tokens (B, γ), draft_logits (B, γ, V), dcache') with
    dcache' lengths advanced by γ (the caller rolls them back)."""
    if not greedy:
        raise NotImplementedError("sampled drafting is not ported yet "
                                  "(ROADMAP queue 1: sampled decoding)")
    h, logits, cache = h_last, first_logits, dcache
    toks, logitss = [], []
    for _ in range(gamma):
        tok = logits.argmax(-1).to(torch.int32)
        tok_emb = embed(embed_params, tok[:, None], dcfg.act_dtype)
        x = _fuse_inputs(dcfg, dparams, h[:, None], tok_emb)
        x = _layer(dcfg, dparams, x, cache["k"], cache["v"],
                   cache["lengths"], cache["pad"])
        h_new = rmsnorm(dparams["final_norm"], x, dcfg.norm_eps)[:, 0]
        logits_new = _head(dcfg, dparams, h_new[:, None])[:, 0]
        cache = dict(cache, lengths=cache["lengths"] + 1)
        toks.append(tok)
        logitss.append(logits)
        h, logits = h_new, logits_new
    return torch.stack(toks, dim=1), torch.stack(logitss, dim=1), cache


def reset_propose(dcache, gamma: int):
    """Roll the speculative lengths back after verification."""
    return dict(dcache, lengths=dcache["lengths"] - gamma)


def seed_prompt_pairs(dcfg: ModelConfig, dparams, embed_params, dcache,
                      captures, tokens, pad):
    """The draft 'prefill': set the cache's pad and ingest the prompt
    pairs (caps[i], t_{i+1}) for i < S-1 (one ``draft_extend`` of
    T = S - 1)."""
    b, s, _ = captures.shape
    dcache = dict(dcache, pad=pad.to(torch.int32, copy=True))
    _, _, dcache = draft_extend(
        dcfg, dparams, embed_params, dcache, captures[:, :s - 1],
        tokens[:, 1:],
        torch.full((b,), s - 1, dtype=torch.int32, device=captures.device))
    return dcache


def seed_refill_cache(dcfg: ModelConfig, dparams, embed_params, captures,
                      tokens, pad, max_len: int):
    """A fresh draft cache for a refill batch, seeded with its prompts."""
    dcache = init_draft_cache(dcfg, captures.shape[0], max_len,
                              device=captures.device)
    return seed_prompt_pairs(dcfg, dparams, embed_params, dcache, captures,
                             tokens, pad)


def scatter_batch_rows(live, new, mask, src, axis: int = 0):
    """Overwrite, **in place**, the batch rows of ``live`` selected by
    ``mask`` (B,) with rows of ``new`` gathered at ``src`` (B,); batch at
    ``axis``.  A gather + where over the whole live tensor, as in the
    reference (fixed shapes, no host sync); ``src`` is arbitrary where
    ``mask`` is False.  Returns ``live``."""
    rows = new.index_select(axis, src.long())
    shp = [1] * rows.dim()
    shp[axis] = mask.shape[0]
    live.copy_(torch.where(mask.reshape(shp), rows.to(live.dtype), live))
    return live


def scatter_draft_rows(live, new, mask, src):
    """Replace the masked lanes of a live draft cache with lanes of a
    refill-batch cache, in place."""
    for k in live:
        scatter_batch_rows(live[k], new[k], mask, src, axis=0)
    return live
