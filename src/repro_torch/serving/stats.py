"""Bounded host-side serving statistics.

Truly endless request streams must not grow host memory linearly:
``Ring`` is a list with a retention cap (drop-oldest), ``P2Quantile``
is the classic P² streaming percentile estimator (Jain & Chlamtac
1985) — five markers, O(1) memory, no sample retention — and ``Peak``
is a running max/mean, so ``ServingStats`` can report p50/p95 and
worst-case prefill-stall metrics over the *whole* stream while only
the recent window is kept for exact inspection.
"""
from __future__ import annotations

from typing import List


class Ring(list):
    """A list whose ``append`` drops the oldest entries beyond
    ``maxlen``.  Full list semantics otherwise (slicing, iteration) —
    existing consumers of the stats lists keep working, they just see
    the trailing window once the cap is hit."""

    def __init__(self, maxlen: int = 4096, iterable=()):
        super().__init__(iterable)
        self.maxlen = maxlen
        if len(self) > maxlen:
            del self[:len(self) - maxlen]

    def append(self, x):
        super().append(x)
        if len(self) > self.maxlen:
            del self[:len(self) - self.maxlen]


class Peak:
    """Running max / sum / count over a stream of scalar observations
    (O(1) memory).  ``ServingStats`` uses one per prefill-stall metric:
    the engine records how many prompt tokens each prefill op (one-shot
    refill or pipeline chunk) processes and how many land in each
    inter-superstep gap, so benchmarks can gate the *deterministic*
    worst-case refill stall (``max``) next to the noisy wall-clock
    goodput numbers."""

    def __init__(self):
        self._max: float = 0.0
        self.total = 0.0
        self.n = 0

    def add(self, x: float):
        # lazy max: the first observation seeds the peak, so all-negative
        # streams report their true (negative) max instead of 0.0
        if self.n == 0 or x > self._max:
            self._max = float(x)
        self.n += 1
        self.total += x

    @property
    def max(self) -> float:
        return self._max if self.n else 0.0

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)

    def __repr__(self):
        return f"Peak(max={self.max}, mean={self.mean:.1f}, n={self.n})"


class P2Quantile:
    """P² one-pass quantile estimator for quantile ``q`` in (0, 1).

    Exact for the first five observations, then maintains five markers
    whose heights converge to (min, q/2, q, (1+q)/2, max) via parabolic
    interpolation.  ``value`` is the current q-estimate."""

    def __init__(self, q: float):
        assert 0.0 < q < 1.0
        self.q = q
        self.n_obs = 0
        self._h: List[float] = []          # marker heights
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self._dpos = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def add(self, x: float):
        self.n_obs += 1
        if len(self._h) < 5:
            self._h.append(float(x))
            self._h.sort()
            return
        h, pos = self._h, self._pos
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dpos[i]
        # adjust the three interior markers
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                d = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, d)
                if not (h[i - 1] < hp < h[i + 1]):
                    hp = self._linear(i, d)
                h[i] = hp
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i])
            / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1])
            / (pos[i] - pos[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])

    @property
    def value(self) -> float:
        if not self._h:
            return 0.0
        if self.n_obs <= 5:
            # exact small-sample quantile (nearest-rank interpolation,
            # matching np.percentile's default 'linear')
            idx = self.q * (len(self._h) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(self._h) - 1)
            return self._h[lo] + (idx - lo) * (self._h[hi] - self._h[lo])
        return self._h[2]
