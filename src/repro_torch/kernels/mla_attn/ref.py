"""Plain PyTorch version of the latent-space decode attention kernel
(``csrc/mla_attn.cu``): the masked attention core of JAX's absorbed MLA
decode (``repro/models/mla.py:133-142``), in float64.

Used by the CPU path and as the card's comparison for the CUDA kernel.
A row with no visible key is zeros, as in the kernel and the other
attention kernels' plain versions (the JAX reference averages such a
row uniformly; it occurs only on inert lanes)."""
from __future__ import annotations

import torch

from repro_torch.kernels.verify_attn.ref import verify_mask


def mla_attention_ref(q_lat, q_rope, ckv, kr, lengths, pad=None, *,
                      scale: float):
    """q_lat: (B, T, H, R) queries with W_uk absorbed; q_rope: (B, T, H,
    Dr); ckv: (B, Smax, R) the latent cache, keys' first R columns and
    the values; kr: (B, Smax, Dr) the shared RoPE keys; lengths, pad:
    (B,) ints.  Row t of lane b sees kpos in [pad[b], lengths[b] + t].
    Scores (q_lat·ckv + q_rope·kr) · ``scale``.  Returns o_lat (B, T, H,
    R) in q_lat.dtype; math in float64."""
    b, t, h, r = q_lat.shape
    mask = verify_mask(lengths, t, ckv.shape[1], pad)[:, :, None, :]
    scores = (torch.einsum("bthr,bsr->bths", q_lat.double(), ckv.double())
              + torch.einsum("bthk,bsk->bths", q_rope.double(),
                             kr.double())) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    mx = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(mx), mx,
                                       torch.zeros_like(mx)))
    p = p.masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.einsum("bths,bsr->bthr", p, ckv.double())
    return out.to(q_lat.dtype)
