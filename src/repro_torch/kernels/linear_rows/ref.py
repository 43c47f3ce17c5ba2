"""Plain PyTorch version of the row-invariant matrix product
(``csrc/linear_rows.cu``)."""
from __future__ import annotations


def linear_rows_ref(x, w):
    """x: (..., K); w: (K, N).  Returns x @ w, (..., N)."""
    return x @ w
