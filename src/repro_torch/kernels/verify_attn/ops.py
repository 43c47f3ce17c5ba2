"""Decode-side attention: CUDA kernel on the card, plain version on the
CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import (HEAD_DIMS, dtype_code, lane_ints, on_cpu,
                                 require, stream_of)
from repro_torch.kernels.verify_attn.ref import verify_attention_ref


def verify_attention(q, k_cache, v_cache, lengths, pad=None, *,
                     window: int = 0, softcap: float = 0.0):
    """q: (B, T, Hq, D) queries at cache positions lengths[b] + [0..T);
    k/v_cache: (B, Smax, Hk, D) holding the new block; lengths, pad:
    (B,) ints.  Returns (B, T, Hq, D) in q.dtype.

    CPU tensors take ``verify_attention_ref``; CUDA tensors launch
    ``csrc/verify_attn.cu`` or raise.  ``verify_attention.launches``
    counts the kernel launches."""
    if on_cpu(q, k_cache, v_cache, lengths):
        return verify_attention_ref(q, k_cache, v_cache, lengths, pad,
                                    window=window, softcap=softcap)
    if softcap:
        raise NotImplementedError("the CUDA verify kernel has no logit "
                                  "softcap (no Pallas kernel has one)")
    b, t, hq, d = q.shape
    require(k_cache.dim() == 4 and k_cache.shape == v_cache.shape
            and k_cache.shape[0] == b and k_cache.shape[3] == d,
            f"cache {tuple(k_cache.shape)}/{tuple(v_cache.shape)} vs q "
            f"{tuple(q.shape)}")
    smax, hk = k_cache.shape[1], k_cache.shape[2]
    require(hq % hk == 0 and d in HEAD_DIMS,
            f"heads {hq}/{hk}, head_dim {d} not supported")
    require(q.dtype == k_cache.dtype == v_cache.dtype, "q/cache dtypes differ")
    require(all(x.is_contiguous() for x in (q, k_cache, v_cache)),
            "q/k/v must be contiguous")
    require(all(x.data_ptr() % 16 == 0 for x in (q, k_cache, v_cache)),
            "q/k/v must be 16-byte aligned (the kernel loads 16-byte vectors)")
    code = dtype_code(q)
    len_t = lane_ints(lengths, b, q.device)
    pad_t = lane_ints(pad, b, q.device)
    out = torch.empty_like(q)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q.device):
        err = library().repro_verify_attn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            len_t.data_ptr(), pad_t.data_ptr(), out.data_ptr(), b, t, smax,
            hq, hk, d, int(window), code, stream_of(q))
    check(err, "verify_attention")
    verify_attention.launches += 1
    return out


verify_attention.launches = 0
