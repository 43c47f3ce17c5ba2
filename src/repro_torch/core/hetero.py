"""Heterogeneous resource allocation model (paper §5.5, Figs. 10-12);
port of ``repro/core/hetero.py``.

TIDE decouples inference serving from draft training and maps them to
different card classes.  This module captures the decision problem:
given per-class inference/training throughput ratios and the speculative
speedup *s* that draft training unlocks, should the low-end cards train
the draft or serve?  It reproduces the paper's GPU numbers.

The model is live: ``core.transport.pick_training_device`` calls
``plan_tpu_submesh`` (the reference's name, kept so a reader finds the
counterpart) over the host's CUDA cards to place the training service
(``training/service.py``) on its own card, and returns None on a
one-card host, where training runs on a background thread of the
serving process.

The reference's ``TPU_DEVICES`` presets (TPU throughput ratios) are left
out: nothing on the port's path reads them, and the port states no TPU
figure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    name: str
    # throughput relative to the reference class (paper Fig. 11:
    # normalized to MI250)
    inference: float
    training: float


# Paper Fig. 11 measurements (normalized to MI250).
PAPER_DEVICES = {
    "MI250": DeviceClass("MI250", 1.0, 1.0),
    "MI300X": DeviceClass("MI300X", 4.42, 1.77),
    "H100": DeviceClass("H100", 6.76, 2.44),
}


def relative_throughput(high: DeviceClass, low: DeviceClass,
                        n_high: int, n_low: int, s: float) -> float:
    """Fig. 12 model: relative throughput of TIDE's split (the high cards
    serve with speculative speedup s, the low cards train) against the
    all-inference baseline (every card serves, no speculation).

    baseline  = n_high·I_high + n_low·I_low
    tide      = n_high·I_high·s          (the low class is busy training)
    """
    baseline = n_high * high.inference + n_low * low.inference
    tide = n_high * high.inference * s
    return tide / baseline


def best_split(high: DeviceClass, low: DeviceClass, n_high: int, n_low: int,
               s: float) -> Dict:
    """Compare TIDE's split against all-inference; the paper's decision."""
    rel = relative_throughput(high, low, n_high, n_low, s)
    return {
        "relative_throughput": rel,
        "use_tide": rel > 1.0,
        "config": f"{high.name}:{low.name} ({n_high}:{n_low})",
        "s": s,
    }


def paper_figure12_grid() -> List[Dict]:
    """All configurations evaluated in paper Fig. 12."""
    out = []
    for hi, lo, nh, nl in [("H100", "MI250", 4, 1), ("H100", "MI250", 2, 1),
                           ("MI300X", "MI250", 4, 1), ("MI300X", "MI250", 2, 1)]:
        for s in (1.1, 1.2, 1.3):
            out.append(best_split(PAPER_DEVICES[hi], PAPER_DEVICES[lo],
                                  nh, nl, s))
    return out


@dataclasses.dataclass(frozen=True)
class SubmeshPlan:
    """A split of a host's cards: ``serve_chips`` serve, ``train_chips``
    train the draft (the reference's field names)."""
    serve_chips: int
    train_chips: int
    s: float                   # speculative speedup from online adaptation

    def relative_throughput(self) -> float:
        total = self.serve_chips + self.train_chips
        return (self.serve_chips * self.s) / total


def plan_tpu_submesh(total_chips: int, s: float,
                     train_fraction_grid=(0.0, 1 / 64, 1 / 32, 1 / 16, 1 / 8)
                     ) -> SubmeshPlan:
    """Pick the number of training cards that maximizes serving
    throughput.  The draft is 1 layer, so a few cards suffice (the paper
    uses 4 MI250s of 12 GPUs); fractions beyond 1/8 never pay off."""
    best = None
    for f in train_fraction_grid:
        tc = max(int(total_chips * f), 0) if f else 0
        eff_s = s if tc > 0 else 1.0     # no training -> the draft goes stale
        plan = SubmeshPlan(total_chips - tc, tc, eff_s)
        if best is None or plan.relative_throughput() > \
                best.relative_throughput():
            best = plan
    return best
