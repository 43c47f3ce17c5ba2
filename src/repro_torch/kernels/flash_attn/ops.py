"""Prefill attention, dense and paged: CUDA kernels on the card, plain
versions on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import (HEAD_DIMS, check_pools, dtype_code,
                                 lane_ints, on_cpu, require, stream_of)
from repro_torch.kernels.flash_attn.ref import (flash_attention_paged_ref,
                                                flash_attention_ref)


def flash_attention(q, k, v, pad=None, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0):
    """q: (B, S, Hq, D); k, v: (B, S, Hk, D); pad: optional (B,) left-pad
    widths (keys before pad[b] are invisible to lane b; rows before it
    are zeros).  Returns (B, S, Hq, D) in q.dtype.

    CPU tensors take ``flash_attention_ref``; CUDA tensors launch
    ``csrc/flash_attn.cu`` or raise: bfloat16 runs on tensor cores
    (``csrc/prefill_rows.cuh``), float32 on the FMA loop
    (``csrc/attn_rows.cuh``).  ``flash_attention.launches`` counts the
    kernel launches."""
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, pad, causal=causal,
                                   window=window, softcap=softcap)
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
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q.device):
        err = library().repro_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_t.data_ptr(),
            out.data_ptr(), b, s, hq, hk, d, int(bool(causal)), int(window),
            code, stream_of(q))
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


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
