"""GQA attention, dense subset (port of ``repro/models/attention.py``):
RoPE, the masked reference ``attend``, the draft-tree slot helpers, the
q/k/v and output projections, the KV scatter, and the serving prefill and
decode attention (chain or draft tree).

Unlike the JAX model, which computes its attention with jnp, the port
runs every attention call through its kernels: the left-padded serving
prefill through ``kernels/flash_attn``, every decode-side call (target
verify and plain decode, draft extend and propose) through
``kernels/verify_attn``, and the draft's training forward
(``self_attention_train``) through the prefill kernel with its backward
kernel as the gradient.  On CPU tensors those wrappers run their plain
versions, which are ``attend`` under the same masks.

Paged caches (``core/paging``): decode writes the new K/V through the
block table and attends straight through it (``verify_attention_paged``);
where JAX gathers a dense ``(B, max_len)`` view first, the port never
builds one.  The paged refill prefill writes each layer's prompt K/V into
the lanes' reserved pages and attends over them
(``flash_attention_paged``); JAX prefills into a dense staging cache and
copies it through the table afterwards.  Both compute what JAX computes.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.paging import scatter_kv_paged, write_rows_paged
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
    """Reference masked attention, float64 throughout.

    q: (B, T, Hq, D); k, v: (B, S, Hk, D); mask: broadcastable to
    (B, Hk, G, T, S).  Returns (B, T, Hq, D) in q.dtype.  Both products
    and the softmax between them run in float64, which no BLAS path
    computes in reduced precision: the result does not depend on
    ``torch.get_float32_matmul_precision()`` or on the fp32 kernel a
    process's CPU BLAS picks.  A row whose
    mask is all False is zeros (the JAX reference averages it
    uniformly; the kernels define it as zeros, and this is their plain
    version).  Unlike the kernels, masked keys are weighted by an exact
    zero here, so this version expects finite K/V everywhere (the
    port's caches are zero-initialised and only ever hold finite
    rows)."""
    b, t, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qr = q.double().reshape(b, t, hk, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qr, k.double()) / math.sqrt(d)
    if softcap and softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~mask, float("-inf"))
    mx = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(mx), mx,
                                       torch.zeros_like(mx)))
    p = p.masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.einsum("bkgts,bskd->btkgd", p, v.double())
    return out.reshape(b, t, hq, d).to(q.dtype)


# --------------------------------------------------------- draft trees
def tree_offsets(width: int, gamma: int, device=None):
    """Logical depth of each slot of a flattened draft-tree block: slot 0
    is the root, slot 1 + r·γ + (j-1) branch r's depth-j node.  Returns
    (W·γ + 1,) int64 depths [0, 1..γ, 1..γ, ...]."""
    idx = torch.arange(width * gamma + 1, device=device)
    return torch.where(idx == 0, 0, (idx - 1) % gamma + 1)


@functools.lru_cache(maxsize=None)
def _tree_offsets_on(width: int, gamma: int, device: torch.device):
    """``tree_offsets`` made once per (shape, device): a decode step asks
    for it in every layer, and it never changes (read only)."""
    return tree_offsets(width, gamma, device=device)


def tree_block_visible(qi, kslot, width: int, gamma: int):
    """In-block tree-causal visibility: query slot ``qi`` sees key slot
    ``kslot`` iff the key is the shared root or a same-branch
    ancestor-or-self.  Broadcastable integer tensors."""
    t = width * gamma + 1
    same_branch = (kslot - 1) // gamma == (qi - 1) // gamma
    anc = (kslot - 1) % gamma <= (qi - 1) % gamma
    return (kslot == 0) | ((qi > 0) & (kslot > 0) & (kslot < t)
                           & same_branch & anc)


# -------------------------------------------------------- module wrapper
def attn_specs(cfg: ModelConfig) -> dict:
    d, hq, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, hq, hd), (EMBED, HEADS, QKV)),
        "wk": ParamSpec((d, hk, hd), (EMBED, KV_HEADS, QKV)),
        "wv": ParamSpec((d, hk, hd), (EMBED, KV_HEADS, QKV)),
        "wo": ParamSpec((hq, hd, d), (HEADS, QKV, EMBED)),
    }


def _proj(x, w, linear=torch.matmul):
    """einsum('btd,dhk->bthk') as one matrix product, ``linear(x, w2d)``."""
    d, h, k = w.shape
    return linear(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv_proj(params, x, linear=torch.matmul):
    """``linear``: the matrix product (``torch.matmul``, or the prefill's
    ``kernels.linear_rows.ops.linear_rows``)."""
    return (_proj(x, params["wq"], linear), _proj(x, params["wk"], linear),
            _proj(x, params["wv"], linear))


def out_proj(params, o, linear=torch.matmul):
    h, k, d = params["wo"].shape
    return linear(o.reshape(*o.shape[:-2], h * k),
                  params["wo"].reshape(h * k, d))


def scatter_kv(cache, new, lengths, valid=None):
    """Write ``new`` (B, T, Hk, D) into ``cache`` (B, Smax, Hk, D) at
    positions lengths[b] + t, **in place** (the JAX version returns a new
    array that XLA writes into the donated buffer); rows where the
    optional (B, T) ``valid`` is False are not written.

    Writes past Smax are dropped, as JAX drops out-of-bounds scatter
    updates: such a row is redirected to position (p mod Smax) and
    rewritten with the value already there, which no other write of the
    same call touches (T <= Smax), so the result is deterministic with
    no host sync."""
    b, t = new.shape[:2]
    smax = cache.shape[1]
    pos = lengths[:, None].long() + torch.arange(t, device=cache.device)[None]
    valid = (pos < smax) if valid is None else (pos < smax) & valid
    valid = valid[..., None, None]
    pos = pos % smax
    bidx = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    rows = torch.where(valid, new.to(cache.dtype), cache[bidx, pos])
    cache[bidx, pos] = rows
    return cache


def self_attention_prefill(cfg: ModelConfig, params, x, positions, pad=None,
                           *, pools=None, tbl_rows=None, linear=torch.matmul):
    """Causal prefill over the whole prompt.  positions: (B, S) RoPE
    positions; pad: optional (B,) left-pad widths.  Returns
    (out, (k, v)), k/v kept for the cache.  ``linear`` computes the
    q/k/v and output projections (``qkv_proj``).

    Paged (``pools`` = this layer's (k_pool, v_pool), each (NP + 1, P,
    Hk, D), and ``tbl_rows`` (B, n_tbl) page ids): the prompt's K/V is
    written at positions [0, S) through ``tbl_rows``, in place, and the
    attention reads it back through the table."""
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_paged)
    q, k, v = qkv_proj(params, x, linear)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if pools is None:
        o = flash_attention(q, k, v, pad, causal=True, window=cfg.window,
                            softcap=cfg.attn_logit_softcap)
    else:
        k_pool, v_pool = pools
        write_rows_paged(k_pool, tbl_rows, k)
        write_rows_paged(v_pool, tbl_rows, v)
        o = flash_attention_paged(q, k_pool, v_pool, tbl_rows, pad,
                                  causal=True, window=cfg.window,
                                  softcap=cfg.attn_logit_softcap)
    return out_proj(params, pad_rows_mean_v(o, v, pad), linear), (k, v)


def pad_rows_mean_v(o, v, pad):
    """JAX's value at the rows before a lane's left pad, put into the
    prefill kernels' output ``o`` (B, S, Hq, D), where those rows are
    zero.  JAX masks every key of such a row at -1e30, so its softmax is
    uniform over the S keys: the row reads the mean of the lane's V (B, S,
    Hk, D), its weight 1/S cast to V's dtype as JAX's mixed-precision
    ``attend`` casts it.  A dense FFN never lets these rows reach a valid
    one; a MoE layer routes them and counts them against its capacity,
    so they decide which valid assignments drop."""
    if pad is None:
        return o
    b, s, hq, _ = o.shape
    w = float(torch.tensor(1.0 / s).to(v.dtype))
    mean = (v.float().sum(1) * w).to(o.dtype)                  # (B, Hk, D)
    mean = mean.repeat_interleave(hq // v.shape[2], dim=1)     # (B, Hq, D)
    rows = torch.arange(s, device=o.device)[None] < pad.to(o.device)[:, None]
    return torch.where(rows[:, :, None, None], mean[:, None], o)


def self_attention_train(cfg: ModelConfig, params, x):
    """Training form of the prefill attention (the draft layer's
    ``_layer_full``): causal over positions [0, S), no pad, no cache,
    products through ``torch.matmul``, and the attention through
    ``kernels.flash_attn.ops.attention_train``, whose gradient is the
    backward kernel (a pad, window or softcap raises when a gradient is
    needed).  Returns (B, S, D)."""
    from repro_torch.kernels.flash_attn.ops import attention_train
    b, s, _ = x.shape
    q, k, v = qkv_proj(params, x)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention_train(q, k, v, causal=True, window=cfg.window,
                        softcap=cfg.attn_logit_softcap)
    return out_proj(params, o)


def decode_qkv(cfg: ModelConfig, params, x, lengths, pad=None, *,
               tree=None, linear=torch.matmul):
    """The q, k, v of new tokens x (B, T, D) at cache positions
    lengths + [0..T), RoPE'd at positions lengths - pad + t (each tree
    slot's logical depth in place of t for ``tree=(W, γ)``).  The decode
    attention's rows, and the draft re-seed's
    (``eagle.reseed_draft_rows_from_ring``), come from here.  ``linear``
    computes the projections (``qkv_proj``)."""
    t = x.shape[1]
    q, k, v = qkv_proj(params, x, linear)
    offs = (torch.arange(t, device=x.device) if tree is None
            else _tree_offsets_on(*tree, x.device))
    rope_pos = lengths[:, None].long() + offs[None]
    if pad is not None:
        rope_pos = rope_pos - pad[:, None].long()
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)
    return q, k, v


def self_attention_decode(cfg: ModelConfig, params, x, k_cache, v_cache,
                          lengths, pad=None, *, page_tbl=None, tree=None,
                          linear=torch.matmul):
    """x: (B, T, D) new tokens at cache positions lengths + [0..T).
    RoPE positions are lengths - pad + t.  Writes the new K/V into the
    caches in place, then attends through the verify kernel.

    Paged (``page_tbl`` (B, n_tbl) given): k/v_cache are the layer's
    (NP + 1, P, Hk, D) page pools; the write and the attention go
    through the block table.

    Tree (``tree=(W, γ)``): the T = W·γ + 1 rows are a flattened draft
    tree; RoPE positions use each slot's logical depth
    (``tree_offsets``), the K/V write is unchanged (flat slots), and the
    verify kernel runs its tree-causal mode.  ``linear`` computes the
    q/k/v and output projections."""
    from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                     verify_attention_paged)
    q, k, v = decode_qkv(cfg, params, x, lengths, pad, tree=tree,
                         linear=linear)
    if page_tbl is None:
        scatter_kv(k_cache, k, lengths)
        scatter_kv(v_cache, v, lengths)
        o = verify_attention(q, k_cache, v_cache, lengths, pad,
                             window=cfg.window,
                             softcap=cfg.attn_logit_softcap,
                             tree=tree or (0, 0))
    else:
        scatter_kv_paged(k_cache, page_tbl, k, lengths)
        scatter_kv_paged(v_cache, page_tbl, v, lengths)
        o = verify_attention_paged(q, k_cache, v_cache, page_tbl, lengths,
                                   pad, window=cfg.window,
                                   softcap=cfg.attn_logit_softcap,
                                   tree=tree or (0, 0))
    return out_proj(params, o, linear), (k_cache, v_cache)
