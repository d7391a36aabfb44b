"""Hedged launches: straggler cut-off by speculative re-issue.

PRIM-style characterization shows PIM launch latency is long *and*
high-variance; under a :class:`~repro_torch.faults.model.FaultPlan` the
variance comes from link-degrade factors and transient-retry storms.  A
:class:`HedgePolicy` bounds that tail: when a step's measured seconds
exceed a trigger derived from its fault-free price (and optionally from
a profile quantile), the cluster speculatively re-issues the step on
spare/idle ranks and takes the first completion.  The duplicate is
*cancel-priced* like a preemption — both sides' seconds until the
winner completes are charged to the job and to rank occupancy, and the
duplicate's submission lands in the timeline's ``shed`` phase so
goodput accounting sees speculation as overhead, never as useful work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HedgePolicy:
    """When to speculate: a step whose measured duration exceeds
    ``max(min_seconds, factor * ideal)`` is hedged (``ideal`` is the
    step's fault-free price).  ``factor`` must exceed 1 — hedging a
    step that ran at its clean price would duplicate every launch."""

    factor: float = 1.5
    min_seconds: float = 0.0

    def __post_init__(self):
        if self.factor <= 1.0:
            raise ValueError("hedge factor must be > 1")
        if self.min_seconds < 0:
            raise ValueError("min_seconds must be >= 0")

    def trigger(self, ideal: float) -> float:
        """Seconds past which a step with this fault-free price is a
        straggler worth hedging."""
        return max(self.min_seconds, self.factor * ideal)

    @classmethod
    def from_profile(cls, profile, quantile: float = 95.0,
                     factor: float = 1.5) -> "HedgePolicy":
        """Derive ``min_seconds`` from a :class:`JobProfile`: the q-th
        percentile of its per-step costs — steps cheaper than the bulk
        of the profile are never worth a duplicate's setup."""
        secs = [s.seconds for s in profile.steps if s.seconds > 0]
        floor = float(np.percentile(np.asarray(secs, np.float64),
                                    quantile)) if secs else 0.0
        return cls(factor=factor, min_seconds=floor)
