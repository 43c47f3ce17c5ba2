"""Prefill attention, dense and paged: CUDA kernels on the card, plain
versions on the CPU; and the training form of the dense one,
``FlashAttentionFn``, whose backward is ``flash_attention_bwd`` (the CUDA
kernel ``csrc/flash_attn_bwd.cu``, which no Pallas kernel has: JAX
differentiates its jnp attention)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (HEAD_DIMS, check_pools, dtype_code,
                                 lane_ints, on_cpu, require, stream_of)
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_lse_ref,
                                                flash_attention_paged_ref,
                                                flash_attention_ref)


def flash_attention(q, k, v, pad=None, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    return_lse: bool = False):
    """q: (B, S, Hq, D); k, v: (B, S, Hk, D); pad: optional (B,) left-pad
    widths (keys before pad[b] are invisible to lane b; rows before it
    are zeros).  Returns (B, S, Hq, D) in q.dtype; with ``return_lse``
    also each row's log-sum-exp of its scaled scores, (B, S, Hq) float32
    (-inf for a row that sees no key), which the backward reads.

    CPU tensors take ``flash_attention_ref``; CUDA tensors launch
    ``csrc/flash_attn.cu`` or raise: bfloat16 runs on tensor cores
    (``csrc/prefill_rows.cuh``), float32 on the FMA loop
    (``csrc/attn_rows.cuh``).  The LSE is stored by the same launch,
    behind a pointer that serving calls leave null, so it changes no
    output bit.  ``flash_attention.launches`` counts the kernel
    launches."""
    if on_cpu(q, k, v):
        out = flash_attention_ref(q, k, v, pad, causal=causal,
                                  window=window, softcap=softcap)
        if not return_lse:
            return out
        if softcap:
            raise NotImplementedError("no LSE under a logit softcap")
        return out, flash_attention_lse_ref(q, k, pad, causal=causal,
                                            window=window)
    if softcap:
        raise NotImplementedError("the CUDA prefill kernel has no logit "
                                  "softcap (no Pallas kernel has one)")
    b, s, hq, d = q.shape
    require(k.shape[:2] == (b, s) and k.shape == v.shape and k.dim() == 4,
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    hk = k.shape[2]
    require(k.shape[3] == d and hq % hk == 0 and d in HEAD_DIMS,
            f"heads {hq}/{hk}, head_dim {d} not supported")
    require(q.dtype == k.dtype == v.dtype, "q/k/v dtypes differ")
    require(all(t.is_contiguous() for t in (q, k, v)), "q/k/v must be contiguous")
    require(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
            "q/k/v must be 16-byte aligned (the kernel loads 16-byte vectors)")
    code = dtype_code(q)
    pad_t = lane_ints(pad, b, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q.device):
        err = library().repro_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_t.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, s,
            hq, hk, d, int(bool(causal)), int(window), code, stream_of(q))
    check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_paged(q, k_pool, v_pool, tbl, pad=None, *,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0):
    """q: (B, S, Hq, D) at positions [0, S); k/v_pool: (NP + 1, P, Hk, D)
    page pools holding the prompt's K/V; tbl: (B, n_tbl) page ids with
    n_tbl * P >= S; pad: optional (B,) left-pad widths (rows before pad[b]
    are zeros).  Returns (B, S, Hq, D) in q.dtype.

    CPU tensors take ``flash_attention_paged_ref``; CUDA tensors launch
    ``csrc/flash_attn_paged.cu`` (the dense kernel's loops, K/V rows
    through the table) or raise.  ``flash_attention_paged.launches``
    counts the kernel launches."""
    if on_cpu(q, k_pool, v_pool, tbl):
        return flash_attention_paged_ref(q, k_pool, v_pool, tbl, pad,
                                         causal=causal, window=window,
                                         softcap=softcap)
    if softcap:
        raise NotImplementedError("the CUDA prefill kernel has no logit "
                                  "softcap (no Pallas kernel has one)")
    tbl_t = check_pools(q, k_pool, v_pool, tbl)
    b, s, hq, d = q.shape
    p, hk = k_pool.shape[1], k_pool.shape[2]
    require(s <= tbl_t.shape[1] * p,
            f"prompt width {s} overruns the block table ({tbl_t.shape[1]} "
            f"pages of {p})")
    code = dtype_code(q)
    pad_t = lane_ints(pad, b, q.device)
    out = torch.empty_like(q)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q.device):
        err = library().repro_flash_attn_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tbl_t.data_ptr(), pad_t.data_ptr(), out.data_ptr(), b, s,
            tbl_t.shape[1], p, hq, hk, d, int(bool(causal)), int(window),
            code, stream_of(q))
    check(err, "flash_attention_paged")
    flash_attention_paged.launches += 1
    return out


flash_attention_paged.launches = 0


def _bwd_refusal(q, k, pad=None, causal=True, window=0, softcap=0.0):
    """Why the backward kernel cannot serve this call, or None."""
    if pad is not None:
        return "a left pad"
    if not causal:
        return "a non-causal mask"
    if window:
        return "a window"
    if softcap:
        return "a logit softcap"
    if q.shape[-1] not in HEAD_DIMS:
        return f"head_dim {q.shape[-1]} (the kernel takes {HEAD_DIMS})"
    if q.dtype not in (torch.float32, torch.bfloat16):
        return f"dtype {q.dtype}"
    if q.shape[2] % k.shape[2]:
        return f"{q.shape[2]} query heads over {k.shape[2]} kv heads"
    return None


# The splits of key tile 0, which every row sees, in the bf16 backward's
# dK/dV pass
BWD_SPLITS = 8


@functools.cache
def bwd_tile() -> dict:
    """The built bf16 backward's tiles: ``rows`` per row tile and ``keys``
    per key tile (csrc/flash_attn_bwd.cu kTbRows, kTbKeys; the card's
    library, built on first call)."""
    from repro_torch.kernels.build import check, library
    out = (ctypes.c_int * 2)()
    check(library().repro_flash_attn_bwd_tile(out), "flash_attention_bwd tile")
    return dict(zip(("rows", "keys"), out))


def bwd_schedule(s: int, g: int, rows: int, keys: int):
    """The dK/dV work split of the bf16 backward kernel, a function of the
    sequence length ``s``, the query heads per kv head ``g`` and the
    kernel's tiles (``bwd_tile``) alone: never of the batch, never of the
    data, so a lane's gradients are the same bits alone and in a batch.

    Rows are (position, query head) pairs, t-major, in row tiles of
    ``rows``; keys are in tiles of ``keys`` from key 0.  Key tile j is
    seen by the row tiles from the one holding its first key's position
    on; they are cut into splits of ``per`` row tiles each, counted from
    that first row tile, ``per`` chosen so that key tile 0 has
    ``BWD_SPLITS`` splits (fewer when it has fewer row tiles).  Returns
    ``(splits, tiles)``: ``splits`` a list of (key tile, first row tile,
    end row tile, splits of that key tile), key tiles in ascending order
    and each one's splits in ascending row order (the order the kernel's
    reduce adds them in); ``tiles`` a list of (index of the key tile's
    first split, its split count), one per key tile."""
    n_rt = -(-s * g // rows)
    per = -(-n_rt // BWD_SPLITS)
    splits, tiles = [], []
    for j in range(-(-s // keys)):
        lo = j * keys * g // rows
        n = -(-(n_rt - lo) // per)
        tiles.append((len(splits), n))
        splits += [(j, lo + i * per, min(lo + (i + 1) * per, n_rt), n)
                   for i in range(n)]
    return splits, tiles


@functools.lru_cache(maxsize=32)
def _bwd_tables(s: int, g: int, device: torch.device):
    """``bwd_schedule`` of (s, g) at the built kernel's tiles as int32
    tables on ``device`` (made once per shape, so a train step copies
    nothing to the card), and the keys per key tile when a key tile has
    several splits (then the kernel needs the scratch), else 0."""
    tile = bwd_tile()
    splits, tiles = bwd_schedule(s, g, tile["rows"], tile["keys"])
    return (torch.tensor(splits, dtype=torch.int32, device=device),
            torch.tensor(tiles, dtype=torch.int32, device=device),
            tile["keys"] if any(n > 1 for _, n in tiles) else 0)


def flash_attention_bwd(q, k, v, o, do, lse):
    """Gradient of causal GQA prefill attention (no pad, no window, no
    softcap).  q, o, do: (B, S, Hq, D); k, v: (B, S, Hk, D); lse: (B, S,
    Hq) float32, the forward's row log-sum-exp.  Returns (dq, dk, dv) in
    the dtypes and shapes of (q, k, v).

    CPU tensors take ``flash_attention_bwd_ref``; CUDA tensors launch
    ``csrc/flash_attn_bwd.cu`` or raise.  bfloat16 runs on tensor cores:
    dQ per row tile (with delta), then dK/dV per split of a key tile's
    rows (``bwd_schedule``), then the splits' partial sums added in
    order; float32 on the FMA loop.  No atomics, so two calls give equal
    results.  ``flash_attention_bwd.launches`` counts the wrapper's
    launches."""
    why = _bwd_refusal(q, k)
    if why:
        raise NotImplementedError(f"the attention backward kernel has no "
                                  f"{why}")
    if on_cpu(q, k, v, o, do, lse):
        return flash_attention_bwd_ref(q, k, v, o, do, lse)
    b, s, hq, d = q.shape
    hk = k.shape[2]
    require(k.shape == v.shape == (b, s, hk, d),
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    require(o.shape == do.shape == q.shape, "o/do must have q's shape")
    require(tuple(lse.shape) == (b, s, hq) and lse.dtype == torch.float32,
            f"lse {tuple(lse.shape)} {lse.dtype} is not ({b}, {s}, {hq}) "
            "float32")
    require(q.dtype == k.dtype == v.dtype == o.dtype == do.dtype,
            "q/k/v/o/do dtypes differ")
    require(all(t.is_contiguous() for t in (q, k, v, o, do, lse)),
            "q/k/v/o/do/lse must be contiguous")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do)),
            "q/k/v/o/do must be 16-byte aligned (the kernel loads 16-byte "
            "vectors)")
    code = dtype_code(q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
    split = ktile = ws = None
    n_split = 0
    if q.dtype == torch.bfloat16:
        split, ktile, ws_keys = _bwd_tables(s, hq // hk, q.device)
        n_split = split.shape[0]
        if ws_keys:
            ws = torch.empty((b, hk, n_split, 2, ws_keys, d),
                             dtype=torch.float32, device=q.device)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q.device):
        err = library().repro_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (split, ktile, ws)),
            b, s, hq, hk, d, n_split, code, stream_of(q))
    check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The prefill attention as a differentiable function: the forward is
    ``flash_attention`` with its LSE (one launch of the prefill kernel),
    the backward ``flash_attention_bwd`` (one launch of the backward
    kernel).  Causal, with no pad, window or softcap, which the backward
    kernel does not take: ``attention_train`` refuses them before any
    launch.  ``apply(q, k, v)``."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, do.contiguous(), lse)


def attention_train(q, k, v, pad=None, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0):
    """The prefill attention of a training forward: through
    ``FlashAttentionFn`` when a gradient is needed, which refuses
    (``NotImplementedError``) what the backward kernel does not take (a
    pad, a non-causal mask, a window, a softcap, a head dim outside
    ``HEAD_DIMS``) instead of falling back to anything; through
    ``flash_attention`` alone otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        why = _bwd_refusal(q, k, pad, causal, window, softcap)
        if why:
            raise NotImplementedError(
                f"no gradient of the prefill attention with {why}: the "
                "backward kernel does not take it")
        return FlashAttentionFn.apply(q, k, v)
    return flash_attention(q, k, v, pad, causal=causal, window=window,
                           softcap=softcap)
