"""Latent-space decode attention of multi-head latent attention (MLA):
the CUDA kernel ``csrc/mla_attn.cu`` on the card, its plain version on
the CPU.  It is the counterpart, at MLA's latent shapes, of
``verify_attention`` (``src/repro/kernels/verify_attn/kernel.py:214``):
JAX computes this attention with jnp in its absorbed decode
(``src/repro/models/mla.py:133-142``)."""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import (count, count_at, lane_ints, on_cpu,
                                 require, stream_of)
from repro_torch.kernels.mla_attn.ref import mla_attention_ref

# (latent width R, rope width Dr) the CUDA kernel takes: DeepSeek-V3's
# kv_lora_rank and qk_rope_head_dim, bfloat16 only
MLA_DIMS = (512, 64)


def mla_attention(q_lat, q_rope, ckv, kr, lengths, pad=None, *,
                  scale: float):
    """q_lat: (B, T, H, R) and q_rope: (B, T, H, Dr), the queries of T
    new tokens at cache positions lengths[b] + [0..T); ckv: (B, Smax, R)
    and kr: (B, Smax, Dr), the latent cache holding the new block;
    lengths, pad: (B,) ints; ``scale``: 1/sqrt(qk_nope + qk_rope).  Row
    t sees kpos in [pad[b], lengths[b] + t]; the keys are [ckv ‖ kr], the
    values ckv.  Returns o_lat (B, T, H, R) in q_lat.dtype.

    CPU tensors take ``mla_attention_ref``; CUDA tensors launch
    ``csrc/mla_attn.cu`` or raise: bfloat16 at (R, Dr) = ``MLA_DIMS``
    only.  ``mla_attention.launches`` counts the kernel launches,
    ``mla_attention.launches_at_t`` (a ``Counter``) those by T."""
    if on_cpu(q_lat, q_rope, ckv, kr, lengths):
        return mla_attention_ref(q_lat, q_rope, ckv, kr, lengths, pad,
                                 scale=scale)
    b, t, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    require(q_rope.shape == (b, t, h, dr) and ckv.dim() == kr.dim() == 3
            and ckv.shape[0] == kr.shape[0] == b
            and ckv.shape[1] == kr.shape[1] and ckv.shape[2] == r
            and kr.shape[2] == dr,
            f"q_lat {tuple(q_lat.shape)} q_rope {tuple(q_rope.shape)} ckv "
            f"{tuple(ckv.shape)} kr {tuple(kr.shape)} do not fit")
    require((r, dr) == MLA_DIMS,
            f"latent dims (R, Dr) = {(r, dr)} not supported: the kernel "
            f"takes {MLA_DIMS} (ROADMAP queue 1 item 8: the MLA training "
            "slice adds the REDUCED fp32 dims)")
    require(all(x.dtype == torch.bfloat16 for x in (q_lat, q_rope, ckv, kr)),
            f"the kernel takes bfloat16, got {q_lat.dtype}/{q_rope.dtype}/"
            f"{ckv.dtype}/{kr.dtype} (ROADMAP queue 1 item 8: the MLA "
            "training slice adds fp32)")
    xs = (q_lat, q_rope, ckv, kr)
    require(all(x.is_contiguous() for x in xs),
            "q_lat/q_rope/ckv/kr must be contiguous")
    require(all(x.data_ptr() % 16 == 0 for x in xs),
            "q_lat/q_rope/ckv/kr must be 16-byte aligned (the kernel loads "
            "16-byte vectors)")
    len_t = lane_ints(lengths, b, q_lat.device)
    pad_t = lane_ints(pad, b, q_lat.device)
    out = torch.empty_like(q_lat)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(q_lat.device):
        err = library().repro_mla_attn(
            q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
            kr.data_ptr(), len_t.data_ptr(), pad_t.data_ptr(),
            out.data_ptr(), b, t, ckv.shape[1], h, r, dr, float(scale),
            stream_of(q_lat))
    check(err, "mla_attention")
    count(mla_attention)
    count_at(mla_attention, "launches_at_t", t)
    return out


mla_attention.launches = 0
mla_attention.launches_at_t = Counter()
