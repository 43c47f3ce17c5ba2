"""The prefill's matrix products: ``y = x @ w`` whose row result does
not depend on the row count.  CUDA kernel on the card
(``csrc/linear_rows.cu``), plain version on the CPU.

The serving refill packs several prompts into one prefill, so the row
count M of its projections changes with the prompts that share a
refill.  A library GEMM picks its algorithm by M, and on the card that
moved a prompt's rows in the last bits, and with them its greedy stream.
``transformer.prefill`` sends the target's q/k/v, output and FFN
products and its last-position LM head through ``linear_rows``; decode
keeps ``torch.matmul`` (its M = B·T is fixed for a serve)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import count, dtype_code, on_cpu, require, stream_of
from repro_torch.kernels.linear_rows.ref import linear_rows_ref

# The bf16 kernel's column tile and K chunk (kLrBN, kLrBK of
# csrc/linear_rows.cu; a CPU test holds them to the source, ``tile()``
# reads the built kernel's on the card).
BLOCK_N, BLOCK_K = 256, 64
SPLIT_BLOCKS = 4    # blocks that one row tile aims at through the split


def k_splits(n: int, k: int) -> int:
    """How many parts the kernel splits K into, from (N, K) alone: about
    SPLIT_BLOCKS blocks for a single row tile, at least 8 K chunks a
    part.  Never from M, so a row's sum runs over the same parts for
    every M.  The fp32 partials cost S·M·N·8 bytes: two parts made q/o
    (K 4096) a third slower at M 3968 on an H100 (tiles.py), so only
    narrow products (glm4-9b's k/v, N 256) split."""
    tiles = -(-n // BLOCK_N)
    return max(1, min(SPLIT_BLOCKS // tiles, -(-k // BLOCK_K) // 8))


def tile() -> dict:
    """The built bf16 kernel's tile: BM, BN, BK and STAGES (the card's
    library, built on first call)."""
    from repro_torch.kernels.build import check, library
    out = (ctypes.c_int * 4)()
    check(library().repro_linear_rows_tile(out), "linear_rows tile")
    return dict(zip(("BM", "BN", "BK", "STAGES"), out))


def linear_rows(x, w):
    """x: (..., K) float32 or bfloat16; w: (K, N) row-major, the same
    dtype.  Returns x @ w, (..., N) in x.dtype, with fp32 accumulation.

    CPU tensors take ``linear_rows_ref`` (``x @ w``); CUDA tensors launch
    ``csrc/linear_rows.cu`` or raise: row r of the result depends only
    on row r of x and on w, bit for bit, whatever the other rows.
    ``linear_rows.launches`` counts the kernel launches.

    The kernel reads w through a TMA descriptor, whose row stride must be
    a multiple of 16 bytes.  An N off that (granite-moe's vocabulary,
    49 155) runs on a copy of w padded with zero columns to the next
    multiple, and the result is cut back to N columns: its columns are
    the unpadded product's, and rows stay independent of M."""
    if on_cpu(x, w):
        return linear_rows_ref(x, w)
    require(w.dim() == 2 and x.shape[-1] == w.shape[0],
            f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    require(x.dtype == w.dtype, f"x {x.dtype} vs w {w.dtype}")
    require(w.is_contiguous(), "w must be a row-major (K, N) tensor")
    k, n = w.shape
    code = dtype_code(x)
    vec = 8 if code == 1 else 4
    require(k % vec == 0,
            f"K {k} must be a multiple of {vec} (16-byte rows)")
    if n % vec:
        wide = torch.nn.functional.pad(w, (0, vec - n % vec))
        return linear_rows(x, wide)[..., :n].contiguous()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    require(x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
            "x and w must be 16-byte aligned")
    splits = k_splits(n, k)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    from repro_torch.kernels.build import check, library
    with torch.cuda.device(x.device):
        err = library().repro_linear_rows(
            x2.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, splits, code,
            stream_of(x))
    check(err, "linear_rows")
    count(linear_rows)
    return y


linear_rows.launches = 0
