"""Training-signal pack: CUDA kernel on the card, plain version on the
CPU.  ``pack_signals`` is the superstep's per-round signal compactor
(``core/speculative.decode_superstep``), which packs each round into its
slot of the superstep's signal buffers through ``out=``."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cpu, stream_of
from repro_torch.kernels.build import check, library
from repro_torch.kernels.extract_pack.ref import extract_pack_ref

MAX_T = 32


def checked_out(out, feats):
    """``out`` as (packed_feats, packed_tokens, counts) when it fits
    ``feats`` (B, T, F): feats' shape, dtype and device, int32 (B, T) and
    (B,), every one contiguous.  Raises ValueError on anything else."""
    try:
        pf, pt, cnt = out
    except (TypeError, ValueError):
        raise ValueError("out must be (packed_feats, packed_tokens, "
                         "counts)") from None
    b, t, _ = feats.shape
    if pf.shape != feats.shape or pf.dtype != feats.dtype:
        raise ValueError(f"out feats {tuple(pf.shape)} {pf.dtype} vs "
                         f"{tuple(feats.shape)} {feats.dtype}")
    if pt.shape != (b, t) or pt.dtype != torch.int32:
        raise ValueError(f"out tokens {tuple(pt.shape)} {pt.dtype}, want "
                         f"({b}, {t}) int32")
    if cnt.shape != (b,) or cnt.dtype != torch.int32:
        raise ValueError(f"out counts {tuple(cnt.shape)} {cnt.dtype}, want "
                         f"({b},) int32")
    if not pf.device == pt.device == cnt.device == feats.device:
        raise ValueError(f"out on {pf.device}/{pt.device}/{cnt.device}, "
                         f"feats on {feats.device}")
    if not (pf.is_contiguous() and pt.is_contiguous()
            and cnt.is_contiguous()):
        raise ValueError("out tensors must be contiguous")
    return pf, pt, cnt


def pack_signals(feats, tokens, mask, out=None):
    """feats: (B, T, F); tokens: (B, T) int; mask: (B, T) bool.
    Returns (packed_feats, packed_tokens int32, counts int32): accepted
    entries compacted to the front per row, zero tail.  With ``out`` the
    three are written into ``out`` (``checked_out``; not overlapping the
    inputs) and it is returned; nothing is allocated.

    CPU tensors take ``extract_pack_ref``; CUDA tensors launch
    ``csrc/extract_pack.cu`` or raise.  ``pack_signals.launches`` counts
    the kernel launches."""
    if on_cpu(feats, tokens, mask):
        packed = extract_pack_ref(feats, tokens, mask)
        if out is None:
            return packed
        out = checked_out(out, feats)
        for o, p in zip(out, packed):
            o.copy_(p)
        return out
    b, t, f = feats.shape
    if tokens.shape != (b, t) or mask.shape != (b, t):
        raise ValueError(f"tokens {tuple(tokens.shape)} / mask "
                         f"{tuple(mask.shape)} vs feats {tuple(feats.shape)}")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"T={t} outside [1, {MAX_T}]")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    esize = feats.element_size()
    if esize not in (2, 4):
        raise ValueError(f"feats dtype {feats.dtype} not supported")
    if not feats.is_contiguous():
        feats = feats.contiguous()
    if tokens.dtype != torch.int32 or not tokens.is_contiguous():
        tokens = tokens.to(torch.int32).contiguous()
    if not mask.is_contiguous():
        mask = mask.contiguous()
    if out is None:
        pf = torch.empty_like(feats)
        pt = torch.empty((b, t), dtype=torch.int32, device=feats.device)
        cnt = torch.empty((b,), dtype=torch.int32, device=feats.device)
    else:
        pf, pt, cnt = checked_out(out, feats)
    args = (feats.data_ptr(), tokens.data_ptr(), mask.data_ptr(),
            pf.data_ptr(), pt.data_ptr(), cnt.data_ptr(), b, t, f, esize)
    stream = torch.cuda.current_stream()
    if stream.device == feats.device:
        err = library().repro_extract_pack(*args, stream.cuda_stream)
    else:
        with torch.cuda.device(feats.device):
            err = library().repro_extract_pack(*args, stream_of(feats))
    check(err, "pack_signals")
    pack_signals.launches += 1
    return pf, pt, cnt


pack_signals.launches = 0
