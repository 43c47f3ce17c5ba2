"""Adaptive speculative-decoding control (paper §4.1, Eqs. 2–5).

The Adaptive Drafter profiles target decode latency T(n) across batch
sizes and the (batch-independent) draft latency D0 at startup, then
estimates the *practical speedup* of speculation at runtime:

    E[l]      = (1 - α^{γ+1}) / (1 - α)                       (Eq. 2)
    SD(b)     = (γ·D(b) + T(b·(γ+1))) / E[l]                  (Eq. 3)
    Speedup   = T(b) / SD(b)                                  (Eq. 4)
              = (1 - α^{γ+1}) / ((1-α)(c(b)·γ + β(b)))        (Eq. 5)

with c(b) = D0 / T(b) and β(b) = T(b(γ+1)) / T(b).  Speculation is
enabled only when the estimate exceeds 1 (+ hysteresis margin).

T(n) is interpolated log-linearly between profiled batch sizes.  Port of
``repro/core/adaptive.py`` without its TPU roofline model: the port's
profiles come from ``profile_engine`` run on the card or from the
paper's own H100 measurements (``PAPER_PROFILES``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class LatencyProfile:
    """Profiled T(n) curve + D0 (paper Table 5)."""
    batch_sizes: List[int]
    t_ms: List[float]
    d0_ms: float

    def t(self, n: float) -> float:
        """Log-linear interpolation of T(n) in ms, with log-linear
        extrapolation beyond the profiled range (np.interp would clamp,
        which wrongly makes β(b) → 1 at large batch)."""
        bs = np.log(np.asarray(self.batch_sizes, dtype=np.float64))
        ts = np.log(np.asarray(self.t_ms, dtype=np.float64))
        x = np.log(max(float(n), 1.0))
        if x <= bs[0]:
            slope = (ts[1] - ts[0]) / (bs[1] - bs[0])
            return float(np.exp(ts[0] + slope * (x - bs[0])))
        if x >= bs[-1]:
            slope = (ts[-1] - ts[-2]) / (bs[-1] - bs[-2])
            return float(np.exp(ts[-1] + slope * (x - bs[-1])))
        return float(np.exp(np.interp(x, bs, ts)))

    def c(self, b: int) -> float:
        return self.d0_ms / self.t(b)

    def beta(self, b: int, gamma: int) -> float:
        return self.t(b * (gamma + 1)) / self.t(b)


def expected_accept_len(alpha: float, gamma: int) -> float:
    """Eq. 2. alpha in [0, 1)."""
    alpha = min(max(alpha, 0.0), 0.999999)
    if alpha == 0.0:
        return 1.0
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)


def alpha_from_accept_len(ell: float, gamma: int) -> float:
    """Invert Eq. 2 numerically (monotone in alpha)."""
    lo, hi = 0.0, 0.999999
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if expected_accept_len(mid, gamma) < ell:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def theoretical_speedup(alpha: float, gamma: int, c: float) -> float:
    """Eq. 1 (memory-bound assumption β = 1)."""
    return expected_accept_len(alpha, gamma) / (c * gamma + 1.0)


def practical_speedup(alpha: float, gamma: int, profile: LatencyProfile,
                      batch: int) -> float:
    """Eq. 5."""
    return expected_accept_len(alpha, gamma) / (
        profile.c(batch) * gamma + profile.beta(batch, gamma))


def min_accept_len_for_gain(gamma: int, profile: LatencyProfile,
                            batch: int, margin: float = 1.0) -> float:
    """Minimum E[l] at which speculation wins at this batch size
    (used by the Adaptive Drafter's runtime threshold, paper §5.4)."""
    return margin * (profile.c(batch) * gamma + profile.beta(batch, gamma))


def accept_threshold_table(profile: LatencyProfile, gamma: int,
                           max_batch: int, margin: float = 1.0) -> np.ndarray:
    """Eq. 5 break-even E[l] for every possible active-request count.

    The pure functional core of the Adaptive Drafter: index ``b`` holds
    ``min_accept_len_for_gain(gamma, profile, b)``, so the speculate-vs-
    plain choice becomes a device-side table lookup + compare
    (``drafter_decide``) in the decode superstep.  Index 0 is a sentinel
    (no active requests → the round is skipped anyway)."""
    return np.array(
        [min_accept_len_for_gain(gamma, profile, max(b, 1), margin)
         for b in range(max_batch + 1)], np.float32)


def drafter_decide(threshold_table, n_active, accept_len_ema):
    """Eq. 5 decision on device (torch tensors).

    threshold_table: (B+1,) f32 from ``accept_threshold_table``;
    n_active: () int active-request count; accept_len_ema: () f32.
    Returns a bool tensor: speculate iff the EMA acceptance length
    clears the break-even threshold at this effective batch size."""
    import torch
    idx = torch.clamp(n_active, 0, threshold_table.shape[0] - 1)
    return accept_len_ema >= threshold_table[idx]


@dataclasses.dataclass
class AdaptiveDrafter:
    """Runtime enable/disable decision for speculative decoding."""
    profile: LatencyProfile
    gamma: int = 3
    margin: float = 1.0          # hysteresis: require speedup > margin
    enabled: bool = True

    def update(self, batch: int, accept_len_ema: float) -> bool:
        """Decide from the *observed* EMA acceptance length (E[l]).
        The compare runs in float32 to match the in-graph decision of
        the fused superstep (``drafter_decide`` on the f32 table)."""
        threshold = min_accept_len_for_gain(self.gamma, self.profile, batch,
                                            self.margin)
        self.enabled = bool(np.float32(accept_len_ema)
                            >= np.float32(threshold))
        return self.enabled

    def threshold_table(self, max_batch: int) -> np.ndarray:
        """Device-side decision table for the fused superstep."""
        return accept_threshold_table(self.profile, self.gamma, max_batch,
                                      self.margin)

    def predicted_speedup(self, batch: int, accept_len: float) -> float:
        alpha = alpha_from_accept_len(accept_len, self.gamma)
        return practical_speedup(alpha, self.gamma, self.profile, batch)


# --------------------------------------------------------- profiling
def profile_engine(step_fn: Callable[[int], None],
                   batch_sizes: Sequence[int],
                   draft_fn: Optional[Callable[[], None]] = None,
                   warmup: int = 1, iters: int = 3) -> LatencyProfile:
    """Measure T(n) by timing ``step_fn(n)`` (which must block until the
    device finishes, e.g. via ``torch.cuda.synchronize``) and D0 via
    ``draft_fn``.  This is the startup profiling pass of paper §4.1."""
    t_ms = []
    for n in batch_sizes:
        for _ in range(warmup):
            step_fn(n)
        t0 = time.perf_counter()
        for _ in range(iters):
            step_fn(n)
        t_ms.append((time.perf_counter() - t0) / iters * 1e3)
    d0 = 0.0
    if draft_fn is not None:
        draft_fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            draft_fn()
        d0 = (time.perf_counter() - t0) / iters * 1e3
    return LatencyProfile(list(batch_sizes), t_ms, d0)


# Paper Table 5: the paper's measured T(n)/D0 on H100 nodes (ms).
PAPER_PROFILES: Dict[str, LatencyProfile] = {
    "gpt-oss-120b": LatencyProfile(
        [1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
        [3.416, 3.844, 4.341, 5.236, 6.123, 7.637, 9.345, 11.79, 15.50,
         21.50], 0.393),
    "qwen3-235b-a22b": LatencyProfile(
        [1, 2, 4, 8, 16, 32, 64, 128],
        [9.057, 10.07, 11.86, 14.68, 17.84, 23.47, 26.68, 31.46], 0.137),
    "llama-4-scout-17b-16e": LatencyProfile(
        [1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
        [6.461, 7.953, 8.932, 11.01, 13.61, 16.82, 19.58, 23.82, 27.89,
         40.86], 0.330),
    "llama-3.3-70b-instruct": LatencyProfile(
        [1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
        [15.50, 16.00, 16.11, 16.36, 17.10, 18.45, 19.00, 21.38, 27.54,
         64.76], 0.843),
}
