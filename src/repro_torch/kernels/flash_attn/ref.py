"""Plain PyTorch versions of the prefill attention kernels (port of
``repro/kernels/flash_attn/ref.py``, with the serving pad): dense and
paged.

Used by the CPU path and as the card's comparison for the CUDA kernels
(``csrc/flash_attn.cu``, ``csrc/flash_attn_paged.cu``): the same masked attention computed densely in
float64 through ``models/attention.attend``.  Rows with no visible key
(query positions before ``pad[b]``) are zeros, as in the kernel.  The
training form adds the forward's row log-sum-exp
(``flash_attention_lse_ref``) and the backward
(``flash_attention_bwd_ref``, the plain version of
``csrc/flash_attn_bwd.cu``)."""
from __future__ import annotations

import math

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
    """q: (B, S, Hq, D); k: (B, S, Hk, D); v: (B, S, Hk, Dv) (Dv apart
    from D for the expanded MLA prefill); pad: optional (B,) int.  Scale
    1/sqrt(D).  Returns (B, S, Hq, Dv) in q.dtype; math in float64."""
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


def flash_attention_lse_ref(q, k, pad=None, *, causal: bool = True,
                            window: int = 0):
    """Row log-sum-exp of the prefill's scaled scores, the second output
    of the forward the backward kernel needs: (B, S, Hq) float32, -inf
    for a row that sees no key; math in float64."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    mask = prefill_mask(b, s, pad, causal=causal, window=window,
                        device=q.device)
    qr = q.double().reshape(b, s, hk, hq // hk, d)
    scores = torch.einsum("btkgd,bskd->btkgs", qr, k.double()) / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    return torch.logsumexp(scores, dim=-1).reshape(b, s, hq).float()


def flash_attention_bwd_ref(q, k, v, o, do, lse):
    """Plain version of ``csrc/flash_attn_bwd.cu``: the gradient of causal
    GQA prefill attention (no pad, no window, no softcap) from the
    forward's output ``o`` and row log-sum-exp ``lse`` (B, S, Hq), in
    float64 throughout, as ``attend``.

    P = exp(Q·K^T / sqrt(D) - lse) on the causal keys, delta =
    rowsum(dO ∘ O), dV = P^T·dO, dS = P ∘ (dO·V^T - delta), dQ = dS·K /
    sqrt(D), dK = dS^T·Q / sqrt(D), the G query heads of a kv head
    summed into its dK and dV.  Returns (dq, dk, dv) in the dtypes of
    (q, k, v)."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    qr = q.double().reshape(b, s, hk, g, d)
    dor = do.double().reshape(b, s, hk, g, d)
    kd, vd = k.double(), v.double()
    causal = prefill_mask(1, s, device=q.device)[0]          # (S, S)
    scores = torch.einsum("btkgd,bskd->bkgts", qr, kd) * scale
    lse_r = lse.double().reshape(b, s, hk, g).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(scores - lse_r).masked_fill(~causal, 0.0)
    delta = (do.double() * o.double()).sum(-1).reshape(b, s, hk, g)
    dp = torch.einsum("btkgd,bskd->bkgts", dor, vd)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bkgts,btkgd->bskd", p, dor)
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qr) * scale
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kd) * scale
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
