"""Plain PyTorch version of the signal pack kernel (port of
``repro/kernels/extract_pack/ref.py``)."""
from __future__ import annotations

import torch


def extract_pack_ref(feats, tokens, mask):
    """Compact accepted positions to the front of each row.

    feats: (B, T, F); tokens: (B, T) int32; mask: (B, T) bool.
    Returns (packed_feats (B,T,F), packed_tokens (B,T), counts (B,)):
    row b holds the masked entries in order at [0, counts[b]); the tail
    is zero."""
    b, t, f = feats.shape
    m = mask.to(torch.int32)
    pos = m.cumsum(dim=1) - m
    slot = torch.where(mask, pos, torch.full_like(pos, t)).long()
    bidx = torch.arange(b, device=feats.device)[:, None].expand(b, t)
    pf = torch.zeros((b, t + 1, f), dtype=feats.dtype, device=feats.device)
    pt = torch.zeros((b, t + 1), dtype=torch.int32, device=feats.device)
    pf[bidx, slot] = feats
    pt[bidx, slot] = tokens.to(torch.int32)
    return pf[:, :t], pt[:, :t], m.sum(dim=1).to(torch.int32)
