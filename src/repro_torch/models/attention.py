"""GQA attention, dense subset (port of ``repro/models/attention.py``):
RoPE, the masked reference ``attend``, the q/k/v and output projections,
the KV scatter, and the serving prefill and decode attention.

Unlike the JAX model, which computes its attention with jnp, the port
runs both attention calls through its kernels: the left-padded serving
prefill through ``kernels/flash_attn`` and every decode-side call (target
verify and plain decode, draft extend and propose) through
``kernels/verify_attn``.  On CPU tensors those wrappers run their plain
versions, which are ``attend`` under the same masks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import EMBED, HEADS, KV_HEADS, QKV
from repro_torch.models.param import ParamSpec


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """Half-split rotation in fp32.  x: (B, T, H, D); positions: (B, T)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv                 # (B, T, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------- full masked attention
def attend(q, k, v, mask, *, softcap: float = 0.0):
    """Reference masked attention, fp32 throughout.

    q: (B, T, Hq, D); k, v: (B, S, Hk, D); mask: broadcastable to
    (B, Hk, G, T, S).  Returns (B, T, Hq, D) in q.dtype.  A row whose
    mask is all False is zeros (the JAX reference averages it
    uniformly; the kernels define it as zeros, and this is their plain
    version).  Unlike the kernels, masked keys are weighted by an exact
    zero here, so this version expects finite K/V everywhere (the
    port's caches are zero-initialised and only ever hold finite
    rows)."""
    b, t, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qr = q.float().reshape(b, t, hk, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qr, k.float()) / math.sqrt(d)
    if softcap and softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~mask, float("-inf"))
    mx = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(mx), mx,
                                       torch.zeros_like(mx)))
    p = p.masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


# -------------------------------------------------------- module wrapper
def attn_specs(cfg: ModelConfig) -> dict:
    d, hq, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, hq, hd), (EMBED, HEADS, QKV)),
        "wk": ParamSpec((d, hk, hd), (EMBED, KV_HEADS, QKV)),
        "wv": ParamSpec((d, hk, hd), (EMBED, KV_HEADS, QKV)),
        "wo": ParamSpec((hq, hd, d), (HEADS, QKV, EMBED)),
    }


def _proj(x, w):
    """einsum('btd,dhk->bthk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv_proj(params, x):
    return (_proj(x, params["wq"]), _proj(x, params["wk"]),
            _proj(x, params["wv"]))


def out_proj(params, o):
    h, k, d = params["wo"].shape
    return o.reshape(*o.shape[:-2], h * k) @ params["wo"].reshape(h * k, d)


def scatter_kv(cache, new, lengths):
    """Write ``new`` (B, T, Hk, D) into ``cache`` (B, Smax, Hk, D) at
    positions lengths[b] + t, **in place** (the JAX version returns a new
    array that XLA writes into the donated buffer).

    Writes past Smax are dropped, as JAX drops out-of-bounds scatter
    updates: such a row is redirected to position (p mod Smax) and
    rewritten with the value already there, which no other write of the
    same call touches (T <= Smax), so the result is deterministic with
    no host sync."""
    b, t = new.shape[:2]
    smax = cache.shape[1]
    pos = lengths[:, None].long() + torch.arange(t, device=cache.device)[None]
    valid = (pos < smax)[..., None, None]
    pos = pos % smax
    bidx = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    rows = torch.where(valid, new.to(cache.dtype), cache[bidx, pos])
    cache[bidx, pos] = rows
    return cache


def self_attention_prefill(cfg: ModelConfig, params, x, positions, pad=None):
    """Causal prefill over the whole prompt.  positions: (B, S) RoPE
    positions; pad: optional (B,) left-pad widths.  Returns
    (out, (k, v)), k/v kept for the cache."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    q, k, v = qkv_proj(params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, pad, causal=True, window=cfg.window,
                        softcap=cfg.attn_logit_softcap)
    return out_proj(params, o), (k, v)


def self_attention_decode(cfg: ModelConfig, params, x, k_cache, v_cache,
                          lengths, pad=None):
    """x: (B, T, D) new tokens at cache positions lengths + [0..T).
    RoPE positions are lengths - pad + t.  Writes the new K/V into the
    caches in place, then attends through the verify kernel."""
    from repro_torch.kernels.verify_attn.ops import verify_attention
    b, t, _ = x.shape
    q, k, v = qkv_proj(params, x)
    rope_pos = lengths[:, None].long() + torch.arange(t, device=x.device)[None]
    if pad is not None:
        rope_pos = rope_pos - pad[:, None].long()
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)
    scatter_kv(k_cache, k, lengths)
    scatter_kv(v_cache, v, lengths)
    o = verify_attention(q, k_cache, v_cache, lengths, pad, window=cfg.window,
                         softcap=cfg.attn_logit_softcap)
    return out_proj(params, o), (k_cache, v_cache)
