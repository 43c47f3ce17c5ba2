"""Plain PyTorch versions of the prefill attention kernels (port of
``repro/kernels/flash_attn/ref.py``, with the serving pad): dense and
paged.

Used by the CPU path and as the card's comparison for the CUDA kernels
(``csrc/flash_attn.cu``, ``csrc/flash_attn_paged.cu``): the same masked attention computed densely in
float64 through ``models/attention.attend``.  Rows with no visible key
(query positions before ``pad[b]``) are zeros, as in the kernel."""
from __future__ import annotations

import torch

from repro_torch.core.paging import gather_view
from repro_torch.models.attention import attend


def prefill_mask(b: int, s: int, pad=None, *, causal: bool = True,
                 window: int = 0, device=None):
    """(B, S, S) bool: query i sees key j."""
    kpos = torch.arange(s, device=device)[None, None, :]
    qpos = torch.arange(s, device=device)[None, :, None]
    mask = torch.ones((1, s, s), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if pad is not None:
        mask = mask & (kpos >= pad.to(device)[:, None, None])
    if window:
        mask = mask & (kpos > qpos - window)
    return mask.expand(b, s, s)


def flash_attention_ref(q, k, v, pad=None, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """q: (B, S, Hq, D); k, v: (B, S, Hk, D); pad: optional (B,) int.
    Returns (B, S, Hq, D) in q.dtype; math in float64."""
    b, s = q.shape[:2]
    mask = prefill_mask(b, s, pad, causal=causal, window=window,
                        device=q.device)
    return attend(q, k, v, mask[:, None, None], softcap=softcap)


def flash_attention_paged_ref(q, k_pool, v_pool, tbl, pad=None, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0):
    """Paged version: ``flash_attention_ref`` over the first S positions
    of each lane's view gathered through the block table (the JAX
    ``flash_attention_paged_ref``, plus the pad).  q: (B, S, Hq, D);
    k/v_pool: (NP + 1, P, Hk, D); tbl: (B, n_tbl) with n_tbl * P >= S."""
    s = q.shape[1]
    n_pg = -(-s // k_pool.shape[1])
    k = gather_view(k_pool, tbl[:, :n_pg])[:, :s]
    v = gather_view(v_pool, tbl[:, :n_pg])[:, :s]
    return flash_attention_ref(q, k, v, pad, causal=causal, window=window,
                               softcap=softcap)
