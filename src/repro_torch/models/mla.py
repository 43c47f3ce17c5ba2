"""Multi-head latent attention, DeepSeek-V3 (port of
``repro/models/mla.py``, arXiv:2412.19437).

KV is compressed into a per-token latent ``c_kv`` (kv_lora_rank wide) and
one RoPE key shared by every head (qk_rope_head_dim).  The prefill runs
JAX's expanded form: the latents are expanded per head through ``wkv_b``
into k_nope and v, and the attention goes through the prefill kernel
(``kernels.flash_attn``) at q/k width qk_nope + qk_rope and v width
v_head_dim.  The decode runs the absorbed form, the deployment form:
W_uk is folded into the query (``q_lat``), the attention runs in latent
space through ``kernels.mla_attn`` (the keys are [c_kv ‖ k_rope], the
values c_kv), and W_uv is applied to its output, so the cache holds
only the latents, ``ckv`` (B, S, R) and ``kr`` (B, S, Dr).  The two
absorption products are ``torch.einsum``: JAX computes them outside
any Pallas kernel too.

Unlike JAX, whose ``mla_prefill`` takes a jnp blockwise path when there
is no pad and the prompt is longer than ``attn_block_kv``, the port runs
every prefill through the one kernel: both compute the same attention.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (EMBED, HEADS, QKV, rmsnorm,
                                       rmsnorm_specs)
from repro_torch.models.param import ParamSpec

LATENT = "latent"


def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, qr), (EMBED, LATENT)),
        "q_norm": rmsnorm_specs(qr)["scale"],
        "wq_b": ParamSpec((qr, h, dn + dr), (LATENT, HEADS, QKV)),
        "wkv_a": ParamSpec((d, kr + dr), (EMBED, LATENT)),
        "kv_norm": rmsnorm_specs(kr)["scale"],
        "wkv_b": ParamSpec((kr, h, dn + dv), (LATENT, HEADS, QKV)),
        "wo": ParamSpec((h, dv, d), (HEADS, QKV, EMBED)),
    }


def _queries(cfg: ModelConfig, params, x, positions, linear):
    qa = rmsnorm({"scale": params["q_norm"]}, linear(x, params["wq_a"]),
                 cfg.norm_eps)
    q = attn._proj(qa, params["wq_b"], linear)             # (B, T, H, dn+dr)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = attn.apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                             cfg.rope_theta)
    return q_nope, q_rope


def latent_kv(cfg: ModelConfig, params, x, positions, linear=torch.matmul):
    """Per-token latent cache entries: (c_kv normed (B, T, R), k_rope
    (B, T, Dr), the head shared)."""
    kv = linear(x, params["wkv_a"])
    ckv = rmsnorm({"scale": params["kv_norm"]}, kv[..., :cfg.kv_lora_rank],
                  cfg.norm_eps)
    k_rope = attn.apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                             cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_prefill(cfg: ModelConfig, params, x, positions, pad=None, *,
                linear=torch.matmul):
    """Expanded-form causal MLA over the prompt.  positions: (B, S) RoPE
    positions; pad: optional (B,) left-pad widths.  Returns (out, (ckv,
    k_rope)) for the cache.  ``linear`` computes every product of the
    layer (``linear_rows`` in the serving prefill).  The rows before a
    lane's pad get JAX's value, the mean of v over the S keys
    (``attention.pad_rows_mean_v``): a MoE layer after this one routes
    them against its capacity."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _queries(cfg, params, x, positions, linear)
    ckv, k_rope = latent_kv(cfg, params, x, positions, linear)
    kv = attn._proj(ckv, params["wkv_b"], linear)          # (B, S, H, dn+dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope[:, :, None].expand(b, s, h, dr)],
                  dim=-1)
    v = kv[..., dn:].contiguous()
    o = attn.pad_rows_mean_v(flash_attention(q, k, v, pad, causal=True), v,
                             pad)
    return attn.out_proj(params, o, linear), (ckv, k_rope)


def mla_decode(cfg: ModelConfig, params, x, ckv_cache, kr_cache, lengths,
               pad=None, *, linear=torch.matmul):
    """Absorbed-form decode: the attention runs in latent space.

    x: (B, T, D) new tokens at cache positions lengths + [0..T), RoPE'd
    at positions lengths - pad + t; ckv_cache: (B, Smax, R); kr_cache:
    (B, Smax, Dr).  The new latents are written into the caches in place
    (``attention.scatter_kv``), then the block attends through
    ``kernels.mla_attn``.  Returns (out, (ckv_cache, kr_cache))."""
    from repro_torch.kernels.mla_attn.ops import mla_attention
    b, t, _ = x.shape
    dn = cfg.qk_nope_head_dim
    rope_pos = lengths[:, None].long() + torch.arange(t, device=x.device)[None]
    if pad is not None:
        rope_pos = rope_pos - pad[:, None].long()
    q_nope, q_rope = _queries(cfg, params, x, rope_pos, linear)
    ckv_new, kr_new = latent_kv(cfg, params, x, rope_pos, linear)
    attn.scatter_kv(ckv_cache, ckv_new, lengths)
    attn.scatter_kv(kr_cache, kr_new, lengths)
    w = params["wkv_b"]                                     # (R, H, dn+dv)
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope, w[..., :dn])
    o_lat = mla_attention(q_lat.contiguous(), q_rope.contiguous(), ckv_cache,
                          kr_cache, lengths, pad, scale=_scale(cfg))
    o = torch.einsum("bthr,rhk->bthk", o_lat, w[..., dn:])
    return attn.out_proj(params, o, linear), (ckv_cache, kr_cache)
