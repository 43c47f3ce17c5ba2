"""Plain PyTorch version of the prefill attention kernel (port of
``repro/kernels/flash_attn/ref.py``, with the serving pad).

Used by the CPU path and as the card's comparison for the CUDA kernel
(``csrc/flash_attn.cu``): the same masked attention computed densely in
fp32 through ``models/attention.attend``.  Rows with no visible key
(query positions before ``pad[b]``) are zeros, as in the kernel."""
from __future__ import annotations

import torch

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
    Returns (B, S, Hq, D) in q.dtype; math in fp32."""
    b, s = q.shape[:2]
    mask = prefill_mask(b, s, pad, causal=causal, window=window,
                        device=q.device)
    return attend(q, k, v, mask[:, None, None], softcap=softcap)
