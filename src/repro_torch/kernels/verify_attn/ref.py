"""Plain PyTorch versions of the decode-side attention kernels (port of
``repro/kernels/verify_attn/ref.py``, chain mode): dense and paged.

Used by the CPU path and as the card's comparison for the CUDA kernels
(``csrc/verify_attn.cu``, ``csrc/verify_attn_paged.cu``).  A row with no visible key is zeros, as in
the kernel (the JAX reference gives such rows a uniform average; they
occur only on inert lanes)."""
from __future__ import annotations

import torch

from repro_torch.core.paging import gather_view
from repro_torch.models.attention import attend


def verify_mask(lengths, t: int, smax: int, pad=None, *, window: int = 0):
    """(B, T, Smax) bool: query t of lane b (at position lengths[b] + t)
    sees key kpos."""
    dev = lengths.device
    qpos = lengths[:, None].long() + torch.arange(t, device=dev)[None, :]
    kpos = torch.arange(smax, device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if pad is not None:
        mask = mask & (kpos >= pad.to(dev)[:, None, None])
    if window:
        mask = mask & (kpos > qpos[:, :, None] - window)
    return mask


def verify_attention_ref(q, k_cache, v_cache, lengths, pad=None, *,
                         window: int = 0, softcap: float = 0.0):
    """q: (B, T, Hq, D) at cache positions lengths[b] + [0..T);
    k/v_cache: (B, Smax, Hk, D) with the new block already written.
    Returns (B, T, Hq, D)."""
    mask = verify_mask(lengths, q.shape[1], k_cache.shape[1], pad,
                       window=window)
    return attend(q, k_cache, v_cache, mask[:, None, None], softcap=softcap)


def verify_attention_paged_ref(q, k_pool, v_pool, tbl, lengths, pad=None, *,
                               window: int = 0, softcap: float = 0.0):
    """Paged version: ``verify_attention_ref`` over each lane's dense
    (B, n_tbl * P) view gathered through the block table (the JAX
    ``verify_attention_paged_ref``).  k/v_pool: (NP + 1, P, Hk, D);
    tbl: (B, n_tbl)."""
    return verify_attention_ref(q, gather_view(k_pool, tbl),
                                gather_view(v_pool, tbl), lengths, pad,
                                window=window, softcap=softcap)
