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

import torch

from repro_torch.kernels import dtype_code, on_cpu, require, stream_of
from repro_torch.kernels.linear_rows.ref import linear_rows_ref

BLOCK_N = 128       # the bf16 kernel's column tile
BLOCK_K = 64        # its K chunk


def k_splits(n: int, k: int) -> int:
    """How many parts the kernel splits K into, from (N, K) alone: about
    64 blocks for a single row tile, at least 8 K chunks a part.  Never
    from M, so a row's sum runs over the same parts for every M."""
    tiles = -(-n // BLOCK_N)
    return max(1, min(64 // tiles, -(-k // BLOCK_K) // 8))


def linear_rows(x, w):
    """x: (..., K) float32 or bfloat16; w: (K, N) row-major, the same
    dtype.  Returns x @ w, (..., N) in x.dtype, with fp32 accumulation.

    CPU tensors take ``linear_rows_ref`` (``x @ w``); CUDA tensors launch
    ``csrc/linear_rows.cu`` or raise: row r of the result depends only
    on row r of x and on w, bit for bit, whatever the other rows.
    ``linear_rows.launches`` counts the kernel launches."""
    if on_cpu(x, w):
        return linear_rows_ref(x, w)
    require(w.dim() == 2 and x.shape[-1] == w.shape[0],
            f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    require(x.dtype == w.dtype, f"x {x.dtype} vs w {w.dtype}")
    require(w.is_contiguous(), "w must be a row-major (K, N) tensor")
    k, n = w.shape
    code = dtype_code(x)
    vec = 8 if code == 1 else 4
    require(k % vec == 0 and n % vec == 0,
            f"K {k} and N {n} must be multiples of {vec} (16-byte rows)")
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
    linear_rows.launches += 1
    return y


linear_rows.launches = 0
