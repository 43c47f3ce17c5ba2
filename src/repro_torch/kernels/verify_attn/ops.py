"""Decode-side attention, dense and paged, chain or draft-tree mode: CUDA
kernels on the card, plain versions on the CPU.  Unlike the JAX
``ops.verify_attn``, which sends a tree to its plain version off the TPU,
a tree on a CUDA tensor launches the kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import (HEAD_DIMS, check_pools, dtype_code,
                                 lane_ints, on_cpu, require, stream_of)
from repro_torch.kernels.verify_attn.ref import (
    verify_attention_paged_ref, verify_attention_ref,
    verify_attention_tree_paged_ref, verify_attention_tree_ref)


def _tree(tree, t: int):
    """(W, γ) as ints; a tree (W > 0) must have T = W·γ + 1 rows."""
    width, gamma = (int(x) for x in tree)
    require(width >= 0 and (width == 0 or (gamma > 0
                                           and t == width * gamma + 1)),
            f"tree={tuple(tree)} does not fit a block of {t} rows")
    return width, gamma


def verify_attention(q, k_cache, v_cache, lengths, pad=None, *,
                     window: int = 0, softcap: float = 0.0, tree=(0, 0)):
    """q: (B, T, Hq, D) queries at cache positions lengths[b] + [0..T);
    k/v_cache: (B, Smax, Hk, D) holding the new block; lengths, pad:
    (B,) ints.  ``tree=(W, γ)`` with W > 0 scores a flattened draft tree
    (T = W·γ + 1) under the tree-causal mask; (0, 0) is the chain.
    Returns (B, T, Hq, D) in q.dtype.

    CPU tensors take the plain version (``verify_attention_ref``, or
    ``verify_attention_tree_ref`` for a tree); CUDA tensors launch
    ``csrc/verify_attn.cu`` in either mode or raise.
    ``verify_attention.launches`` counts the kernel launches,
    ``verify_attention.tree_launches`` those in tree mode."""
    width, gamma = _tree(tree, q.shape[1])
    if on_cpu(q, k_cache, v_cache, lengths):
        if width:
            return verify_attention_tree_ref(q, k_cache, v_cache, lengths,
                                             pad, tree=(width, gamma),
                                             window=window, softcap=softcap)
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
            hq, hk, d, int(window), width, gamma, code, stream_of(q))
    check(err, "verify_attention")
    verify_attention.launches += 1
    verify_attention.tree_launches += width > 0
    return out


verify_attention.launches = 0
verify_attention.tree_launches = 0


def verify_attention_paged(q, k_pool, v_pool, tbl, lengths, pad=None, *,
                           window: int = 0, softcap: float = 0.0,
                           tree=(0, 0)):
    """q: (B, T, Hq, D) queries at positions lengths[b] + [0..T);
    k/v_pool: (NP + 1, P, Hk, D) page pools holding the new block;
    tbl: (B, n_tbl) page ids (lane window n_tbl * P); lengths, pad: (B,)
    ints; ``tree`` as in ``verify_attention``.  Returns (B, T, Hq, D) in
    q.dtype.

    CPU tensors take the plain version (``verify_attention_paged_ref``,
    or ``verify_attention_tree_paged_ref`` for a tree); CUDA tensors
    launch ``csrc/verify_attn_paged.cu`` in either mode or raise.
    ``verify_attention_paged.launches`` counts the kernel launches,
    ``verify_attention_paged.tree_launches`` those in tree mode."""
    width, gamma = _tree(tree, q.shape[1])
    if on_cpu(q, k_pool, v_pool, tbl, lengths):
        if width:
            return verify_attention_tree_paged_ref(
                q, k_pool, v_pool, tbl, lengths, pad, tree=(width, gamma),
                window=window, softcap=softcap)
        return verify_attention_paged_ref(q, k_pool, v_pool, tbl, lengths,
                                          pad, window=window,
                                          softcap=softcap)
    if softcap:
        raise NotImplementedError("the CUDA verify kernel has no logit "
                                  "softcap (no Pallas kernel has one)")
    tbl_t = check_pools(q, k_pool, v_pool, tbl)
    b, t, hq, d = q.shape
    p, hk = k_pool.shape[1], k_pool.shape[2]
    code = dtype_code(q)
    len_t = lane_ints(lengths, b, q.device)
    pad_t = lane_ints(pad, b, q.device)
    out = torch.empty_like(q)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q.device):
        err = library().repro_verify_attn_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tbl_t.data_ptr(), len_t.data_ptr(), pad_t.data_ptr(),
            out.data_ptr(), b, t, tbl_t.shape[1], p, hq, hk, d, int(window),
            width, gamma, code, stream_of(q))
    check(err, "verify_attention_paged")
    verify_attention_paged.launches += 1
    verify_attention_paged.tree_launches += width > 0
    return out


verify_attention_paged.launches = 0
verify_attention_paged.tree_launches = 0
