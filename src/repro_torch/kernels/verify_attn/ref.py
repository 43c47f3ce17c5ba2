"""Plain PyTorch versions of the decode-side attention kernels (port of
``repro/kernels/verify_attn/ref.py``): chain and tree mode, dense and
paged.

Used by the CPU path and as the card's comparison for the CUDA kernels
(``csrc/verify_attn.cu``, ``csrc/verify_attn_paged.cu``).  A row with no visible key is zeros, as in
the kernel (the JAX reference gives such rows a uniform average; they
occur only on inert lanes)."""
from __future__ import annotations

import torch

from repro_torch.core.paging import gather_view
from repro_torch.models.attention import (attend, tree_block_visible,
                                          tree_offsets)


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


def tree_mask(lengths, tree, smax: int, pad=None, *, window: int = 0):
    """(B, T, Smax) bool, T = W·γ + 1: the tree-causal mask of the Pallas
    kernel's ``tree=(W, γ)`` mode (``verify_attn/kernel.py:27``
    ``_tree_mask``).  Query slot qi of lane b sees the committed keys
    [pad[b], lengths[b]) and the in-block keys of its root path; the
    window compares logical positions lengths[b] + depth."""
    width, gamma = tree
    t = width * gamma + 1
    dev = lengths.device
    qi = torch.arange(t, device=dev)[None, :, None]
    kpos = torch.arange(smax, device=dev)[None, None, :]
    length = lengths.to(dev).long()[:, None, None]
    kslot = kpos - length
    committed = kpos < length
    if pad is not None:
        committed = committed & (kpos >= pad.to(dev).long()[:, None, None])
    in_block = (kpos >= length) & (kpos < length + t)
    mask = committed | (in_block & tree_block_visible(qi, kslot, width,
                                                      gamma))
    if window:
        qdepth = tree_offsets(width, gamma, device=dev)[None, :, None]
        kdepth = torch.where(kslot == 0, 0, (kslot - 1) % gamma + 1)
        k_logical = torch.where(in_block, length + kdepth, kpos)
        mask = mask & (k_logical > length + qdepth - window)
    return mask


def verify_attention_tree_ref(q, k_cache, v_cache, lengths, pad=None, *,
                              tree, window: int = 0, softcap: float = 0.0):
    """Tree mode of ``verify_attention_ref`` (the JAX
    ``verify_attention_tree_ref``): q (B, W·γ + 1, Hq, D) is a flattened
    draft tree written at cache positions lengths[b] + [0..T)."""
    mask = tree_mask(lengths, tree, k_cache.shape[1], pad, window=window)
    return attend(q, k_cache, v_cache, mask[:, None, None], softcap=softcap)


def verify_attention_tree_paged_ref(q, k_pool, v_pool, tbl, lengths,
                                    pad=None, *, tree, window: int = 0,
                                    softcap: float = 0.0):
    """Paged tree mode: ``verify_attention_tree_ref`` over the view
    gathered through the block table."""
    return verify_attention_tree_ref(q, gather_view(k_pool, tbl),
                                     gather_view(v_pool, tbl), lengths, pad,
                                     tree=tree, window=window,
                                     softcap=softcap)
