"""Sampling with JAX's threefry keys: the CUDA kernels of
``csrc/threefry_sample.cu`` on the card, their plain versions (``ref.py``)
on the CPU.

``threefry2x32`` and ``categorical_rows`` are the two kernel wrappers,
each counting its launches; the helpers below are the ``jax.random``
calls of the reference's sampling code (``fold_in``, ``split``,
``uniform``, ``categorical``) written over them, so that every hash and
every vocabulary-wide draw of a sampled round is one launch.  Keys are
``(..., 2)`` int64 tensors of uint32 words (``core/prng.py``)."""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels import count, on_cpu, require, stream_of
from repro_torch.kernels.build import check, library
from repro_torch.kernels.sample.ref import categorical_rows_ref, \
    threefry2x32_ref

# vocabulary elements a block of the categorical kernel draws, at most
CHUNK = 2048


def _words(t: torch.Tensor) -> torch.Tensor:
    require(t.dtype == torch.int64, f"key/counter words must be int64, got "
            f"{t.dtype}")
    return t.contiguous()


def threefry2x32(keys, counters):
    """keys (R, 2), counters (R, N, 2) → (R, N, 2): the threefry-2x32 hash
    of each counter pair under its row's key, int64 uint32 words.

    CPU tensors take ``threefry2x32_ref``; CUDA tensors launch
    ``repro_threefry2x32`` or raise.  ``threefry2x32.launches`` counts
    the kernel launches."""
    if on_cpu(keys, counters):
        return threefry2x32_ref(keys, counters)
    require(keys.dim() == 2 and keys.shape[1] == 2, f"keys "
            f"{tuple(keys.shape)} are not (R, 2)")
    r = keys.shape[0]
    require(counters.dim() == 3 and counters.shape[0] == r
            and counters.shape[2] == 2, f"counters {tuple(counters.shape)} "
            f"are not ({r}, N, 2)")
    n = counters.shape[1]
    keys, counters = _words(keys), _words(counters)
    out = torch.empty_like(counters)
    if r and n:
        with torch.cuda.device(keys.device):
            err = library().repro_threefry2x32(
                keys.data_ptr(), counters.data_ptr(), out.data_ptr(), r, n,
                stream_of(keys))
        check(err, "threefry2x32")
        count(threefry2x32)
    return out


threefry2x32.launches = 0


def categorical_rows(keys, logits, row_stride: int = 0):
    """``jax.random.categorical`` of each row of logits (R, V) under its
    own key (R, 2), the noise of row r at flat indices r·row_stride +
    [0, V) (0: a key a row, as ``vmap(categorical)``; V: one key over the
    whole (R, V) array).  Returns (R,) int32.

    CPU tensors take ``categorical_rows_ref``; CUDA tensors launch
    ``repro_categorical_rows`` (float32 logits) or raise.
    ``categorical_rows.launches`` counts the kernel launches."""
    if on_cpu(keys, logits):
        return categorical_rows_ref(keys, logits.float(), row_stride)
    require(logits.dim() == 2, f"logits {tuple(logits.shape)} are not (R, V)")
    r, v = logits.shape
    require(tuple(keys.shape) == (r, 2), f"keys {tuple(keys.shape)} vs "
            f"logits {tuple(logits.shape)}")
    require(logits.dtype == torch.float32, f"logits must be float32, got "
            f"{logits.dtype}")
    require(0 < r <= 65535 and 0 < v < 2 ** 31 and row_stride >= 0,
            f"R {r}, V {v}, row_stride {row_stride} out of range")
    keys, logits = _words(keys), logits.contiguous()
    chunks = -(-v // CHUNK)
    out = torch.empty((r,), dtype=torch.int32, device=logits.device)
    scratch = torch.empty((2 * r * chunks,), dtype=torch.int32,
                          device=logits.device)
    with torch.cuda.device(logits.device):
        err = library().repro_categorical_rows(
            keys.data_ptr(), logits.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), r, v, chunks, row_stride,
            stream_of(logits))
    check(err, "categorical_rows")
    count(categorical_rows)
    return out


categorical_rows.launches = 0


# ------------------------------------------- jax.random over the kernels
# Counters are made on the device (arange), never copied from the host:
# a host-to-device copy of a pageable tensor would wait for the stream.
def fold_in(keys, data):
    """``vmap(fold_in)``: keys (R, 2), data (R,) ints (uint32 words as JAX
    converts them) → (R, 2).  One launch."""
    d = data.to(torch.int64) & prng.MASK
    ctr = torch.stack([torch.zeros_like(d), d], dim=-1)[:, None]
    return threefry2x32(keys, ctr)[:, 0]


def fold_in_each(keys, n: int):
    """``fold_in(keys[r], j)`` for j < n: keys (R, 2) → (R, n, 2).  One
    launch."""
    ctr = prng.counters(n, keys.device)
    return threefry2x32(keys, ctr[None].expand(keys.shape[0], n, 2))


def split(key, num: int = 2):
    """``jax.random.split`` of one key (2,) → (num, 2).  One launch."""
    return fold_in_each(key[None], num)[0]


def uniform(keys, n: int, row_stride: int = 0):
    """Float32 uniforms in [0, 1): row r of (R, n) from keys[r] at flat
    indices r·row_stride + [0, n) (0: ``vmap(uniform(k, (n,)))``; n with
    one key repeated: ``uniform(key, (R, n))``).  One launch."""
    ctr = prng.row_counters(keys.shape[0], n, row_stride, keys.device)
    pairs = threefry2x32(keys, ctr)
    return prng.uniform_from_bits(pairs[..., 0] ^ pairs[..., 1])


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` for one key (2,) over
    (R, V) logits: the noise spans the whole array.  One launch."""
    r, v = logits.shape
    return categorical_rows(key[None].expand(r, 2), logits, row_stride=v)
