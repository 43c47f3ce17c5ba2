"""Training-signal pack: CUDA kernel on the card, plain version on the
CPU.  ``pack_signals`` is the superstep's per-round signal compactor
(``core/speculative.decode_superstep``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cpu, require, stream_of
from repro_torch.kernels.extract_pack.ref import extract_pack_ref

MAX_T = 32


def pack_signals(feats, tokens, mask):
    """feats: (B, T, F); tokens: (B, T) int; mask: (B, T) bool.
    Returns (packed_feats, packed_tokens int32, counts int32): accepted
    entries compacted to the front per row, zero tail.

    CPU tensors take ``extract_pack_ref``; CUDA tensors launch
    ``csrc/extract_pack.cu`` or raise.  ``pack_signals.launches`` counts
    the kernel launches."""
    if on_cpu(feats, tokens, mask):
        return extract_pack_ref(feats, tokens, mask)
    b, t, f = feats.shape
    require(tuple(tokens.shape) == (b, t) and tuple(mask.shape) == (b, t),
            f"tokens {tuple(tokens.shape)} / mask {tuple(mask.shape)} vs "
            f"feats {tuple(feats.shape)}")
    require(1 <= t <= MAX_T, f"T={t} outside [1, {MAX_T}]")
    require(mask.dtype == torch.bool, f"mask must be bool, got {mask.dtype}")
    esize = feats.element_size()
    require(esize in (2, 4), f"feats dtype {feats.dtype} not supported")
    feats = feats.contiguous()
    toks = tokens.to(torch.int32).contiguous()
    mask = mask.contiguous()
    pf = torch.empty_like(feats)
    pt = torch.empty((b, t), dtype=torch.int32, device=feats.device)
    cnt = torch.empty((b,), dtype=torch.int32, device=feats.device)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(feats.device):
        err = library().repro_extract_pack(
            feats.data_ptr(), toks.data_ptr(), mask.data_ptr(), pf.data_ptr(),
            pt.data_ptr(), cnt.data_ptr(), b, t, f, esize, stream_of(feats))
    check(err, "pack_signals")
    pack_signals.launches += 1
    return pf, pt, cnt


pack_signals.launches = 0
