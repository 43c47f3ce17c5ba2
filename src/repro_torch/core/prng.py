"""JAX's threefry PRNG in plain PyTorch, bit for bit.

The port's twin of the ``jax.random`` functions the reference calls, so a
sampled stream of the port draws the numbers JAX draws from the same
seed.  It reproduces JAX 0.9.0 with ``jax_default_prng_impl =
"threefry2x32"`` and ``jax_threefry_partitionable = True`` (the default
since JAX 0.5), following these functions of ``jax/_src/prng.py`` and
``jax/_src/random.py``:

  * ``threefry_2x32`` (``_threefry2x32_lowering``): 20 rounds over two
    32-bit words, a key injection every 4 rounds;
  * ``threefry_seed``: ``key(s)`` is the word pair ``(s >> 32, s &
    0xFFFFFFFF)``, and ``(0, s)`` for the 32-bit seeds JAX takes without
    x64;
  * ``_threefry_fold_in``: ``fold_in(k, d) = threefry2x32(k, (0, d))``;
  * ``_threefry_split_foldlike``: ``split(k, n)[i] = threefry2x32(k, (i
    >> 32, i & 0xFFFFFFFF))``, so ``split(k, n)[i] == fold_in(k, i)``;
  * ``_threefry_random_bits_partitionable``: the 32 bits at flat index i
    of the shape are the xor of the two words of ``threefry2x32(k, (i >>
    32, i & 0xFFFFFFFF))``;
  * ``_uniform``: ``bitcast((bits >> 9) | 0x3F800000) - 1``, scaled to
    ``[minval, maxval)`` and clamped at ``minval``, in float32;
  * ``_gumbel`` (mode "low"): ``-log(-log(uniform(minval=tiny)))``;
  * ``categorical``: ``argmax(logits + gumbel)``, the first maximum wins.

Representation: a key is a ``(..., 2)`` int64 tensor whose entries are
uint32 words; every function is batched over the leading shape.  Words
stay in int64 and are masked with ``& 0xFFFFFFFF`` after each sum, so no
product, shift or rotation depends on signed 32-bit overflow and the
bits are the same on the CPU and on the card.  Seeds and fold-in data
convert to uint32 as JAX converts them: negative int32 values wrap.

Float results are float32, like JAX's; ``torch.log`` and XLA's ``log``
may differ in the last ulp, so ``gumbel`` agrees with JAX's to ~1 ulp
and ``categorical`` picks JAX's index except where the top two of
``logits + gumbel`` lie within such an ulp.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(torch.finfo(torch.float32).tiny)

IntLike = Union[int, torch.Tensor]


def _words(x: IntLike, device=None) -> torch.Tensor:
    """x as int64 uint32 words (negative values wrap, as uint32(x))."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash of the counter words (x0, x1) under the key
    words (k0, k1); int64 tensors of uint32 words, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def hash_pairs(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """keys (..., 2), counters (..., N, 2) → (..., N, 2): the hash of
    every counter pair under its row's key (the plain version of the
    ``threefry2x32`` kernel)."""
    k = keys[..., None, :]
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], counters[..., 0],
                          counters[..., 1])
    return torch.stack([y0, y1], dim=-1)


def key(seed: IntLike, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data: (0, seed & 0xFFFFFFFF)."""
    s = _words(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The key's uint32 words (the key is its data)."""
    return k


def fold_in(k: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2), data an int or a tensor
    broadcasting against the keys' leading shape."""
    d = _words(data, k.device)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _pairs(i: torch.Tensor) -> torch.Tensor:
    return torch.stack([i >> 32, i & MASK], dim=-1)


def counters(n: int, device=None) -> torch.Tensor:
    """The (n, 2) counter pairs (i >> 32, i & 0xFFFFFFFF) of the flat
    indices i < n."""
    return _pairs(torch.arange(n, dtype=torch.int64, device=device))


def row_counters(rows: int, n: int, row_stride: int = 0,
                 device=None) -> torch.Tensor:
    """(rows, n, 2) counter pairs: row r holds the flat indices
    r·row_stride + [0, n) (0: each row its own key's indices; n: one
    key's indices over a (rows, n) array)."""
    i = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
         * row_stride + torch.arange(n, dtype=torch.int64, device=device))
    return _pairs(i)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) → (..., num, 2)."""
    return hash_pairs(k, counters(num, k.device))


def _flat_bits(pairs: torch.Tensor) -> torch.Tensor:
    return pairs[..., 0] ^ pairs[..., 1]


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): keys (..., 2) → (..., *shape) uint32
    words in int64."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    bits = _flat_bits(hash_pairs(k, counters(n, k.device)))
    return bits.reshape(k.shape[:-1] + shape)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's ``_uniform`` from 32 random bits, in float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # JAX converts minval/maxval to float32 first, then scales in float32;
    # Python scalars keep the values off the device (no host copy)
    lo, hi = torch.tensor([minval, maxval], dtype=torch.float32)
    span, lo = (hi - lo).item(), lo.item()
    return torch.clamp(f * span + lo, min=lo)


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32)."""
    return uniform_from_bits(random_bits(k, shape), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's low-mode ``_gumbel`` from 32 random bits."""
    return -torch.log(-torch.log(uniform_from_bits(bits, TINY, 1.0)))


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode "low")."""
    return gumbel_from_bits(random_bits(k, shape))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of float32 logits
    with one key (2,): the noise covers the whole logits shape (flat
    index over it), as JAX's does.  Returns int64 indices."""
    return (logits + gumbel(k, logits.shape)).argmax(-1)
