"""Selective draft-training control (paper §4.2, Algorithm 1); a copy of
``repro/core/controller.py``.

Maintains short/long EMAs of the acceptance rate; a short-EMA drop below
the long EMA (minus ε) signals distribution shift and enables training-
signal collection.  When enough samples accumulate, a training cycle is
triggered; the new draft deploys only if eval acceptance beats the
collection-time average, otherwise collection is disabled until the next
shift.  This module is pure host-side control logic, driven by the
serving engine.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class Decision(enum.Enum):
    NONE = "none"
    START_COLLECTION = "start_collection"
    TRIGGER_TRAINING = "trigger_training"


@dataclasses.dataclass
class TrainingController:
    """Algorithm 1 state machine."""
    lambda_short: float = 0.9
    lambda_long: float = 0.99
    epsilon: float = 0.02
    n_init: int = 8
    n_threshold: int = 2048          # stored samples to trigger training

    collection_enabled: bool = False
    alpha_short: Optional[float] = None
    alpha_long: Optional[float] = None
    stored_samples: int = 0
    collected_alpha_sum: float = 0.0
    collected_alpha_n: int = 0
    _init_buf: List[float] = dataclasses.field(default_factory=list)
    # bookkeeping for experiments
    history: List[dict] = dataclasses.field(default_factory=list)

    def reset(self):
        """Back to the post-construction state (fresh shift detector,
        empty collection window)."""
        self.collection_enabled = False
        self.alpha_short = None
        self.alpha_long = None
        self.stored_samples = 0
        self.collected_alpha_sum = 0.0
        self.collected_alpha_n = 0
        self._init_buf = []
        self.history = []

    # ---- Algorithm 1, line by line -------------------------------------
    def observe(self, alpha: float, n_new_samples: int = 0) -> Decision:
        """Feed one acceptance-rate measurement (per engine step).
        ``n_new_samples`` = training-signal rows stored this step if
        collection is on.  Returns the control decision."""
        if self.alpha_short is None:
            # initialization phase: plain average of the first N_init
            self._init_buf.append(alpha)
            if len(self._init_buf) >= self.n_init:
                mean = sum(self._init_buf) / len(self._init_buf)
                self.alpha_short = mean
                self.alpha_long = mean
            return Decision.NONE

        self.alpha_short = (self.lambda_short * self.alpha_short
                            + (1 - self.lambda_short) * alpha)
        self.alpha_long = (self.lambda_long * self.alpha_long
                           + (1 - self.lambda_long) * alpha)

        decision = Decision.NONE
        if (not self.collection_enabled
                and self.alpha_short < self.alpha_long - self.epsilon):
            self.collection_enabled = True
            decision = Decision.START_COLLECTION

        if self.collection_enabled and n_new_samples > 0:
            self.stored_samples += n_new_samples
            self.collected_alpha_sum += alpha * n_new_samples
            self.collected_alpha_n += n_new_samples

        if (self.collection_enabled
                and self.stored_samples >= self.n_threshold):
            decision = Decision.TRIGGER_TRAINING

        self.history.append({
            "alpha": alpha,
            "short": self.alpha_short,
            "long": self.alpha_long,
            "collecting": self.collection_enabled,
            "stored": self.stored_samples,
        })
        return decision

    def observe_gated(self, alpha: float, n_new_samples: int) -> Decision:
        """`observe` with the serving-loop gating applied internally:
        signal rows only count if collection was already enabled *before*
        this observation.  The per-step loop and the fused superstep's
        deferred telemetry replay share this entry point so Algorithm 1
        sees an identical measurement sequence in both modes."""
        collecting_before = self.collection_enabled
        return self.observe(alpha, n_new_samples if collecting_before else 0)

    @property
    def alpha_train(self) -> float:
        """Average acceptance over the collected window (Alg. 1's
        \\bar{alpha}_train)."""
        if self.collected_alpha_n == 0:
            return 0.0
        return self.collected_alpha_sum / self.collected_alpha_n

    def training_result(self, alpha_eval: float) -> bool:
        """Deploy gate: returns True (deploy M_new) iff eval acceptance
        beats the collection-window average; on a strict regression,
        collection is disabled until the next detected shift."""
        deploy = alpha_eval > self.alpha_train
        if alpha_eval < self.alpha_train:
            self.collection_enabled = False
        # either way the buffer was consumed by this cycle
        self.stored_samples = 0
        self.collected_alpha_sum = 0.0
        self.collected_alpha_n = 0
        # reset the shift detector baseline so the same dip doesn't
        # immediately re-trigger
        if deploy:
            self.alpha_long = self.alpha_short
        return deploy
