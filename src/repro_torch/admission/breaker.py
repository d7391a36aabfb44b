"""Per-rank circuit breakers: quarantine sick ranks, probe them back.

The ``fault_aware`` health floor retires a rank only once enough of its
DPUs are *permanently* dead.  A rank can be far sicker than its mask
shows — transient-retry storms and degraded links burn goodput without
killing a single DPU.  The breaker watches the *outcome stream*
instead: every step records clean/faulted per rank into a rolling
window; a rank whose failure rate trips the threshold opens its breaker
and is excluded from placement for a cooldown, after which it goes
half-open — the next job placed on it is the probe, and its outcome
either closes the breaker or re-opens it with an exponentially longer
cooldown.

All state is a pure function of the ``(rank, ok, t)`` record stream, so
breaker decisions are bit-deterministic and journal-replayable.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class CircuitBreaker:
    """Trip configuration (the mutable per-rank state lives in
    :class:`RankBreakers`).

    A rank opens when, over its last ``window`` recorded steps (at
    least ``min_samples`` of them), the faulted fraction reaches
    ``trip_rate``; it stays quarantined for ``cooldown_seconds``,
    multiplied by ``cooldown_factor`` per consecutive re-trip."""

    window: int = 16
    trip_rate: float = 0.5
    min_samples: int = 4
    cooldown_seconds: float = 0.01
    cooldown_factor: float = 2.0

    def __post_init__(self):
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        if self.min_samples > self.window:
            raise ValueError("min_samples cannot exceed window")
        if not 0.0 < self.trip_rate <= 1.0:
            raise ValueError("trip_rate must be in (0, 1]")
        if self.cooldown_seconds <= 0 or self.cooldown_factor < 1.0:
            raise ValueError("cooldown_seconds must be positive and "
                             "cooldown_factor >= 1")


class _RankState:
    __slots__ = ("history", "open", "until", "trips")

    def __init__(self, window: int):
        self.history: deque = deque(maxlen=window)
        self.open = False
        self.until = 0.0
        self.trips = 0


class RankBreakers:
    """Mutable breaker state for a fleet of ranks."""

    def __init__(self, policy: CircuitBreaker, n_ranks: int):
        self.policy = policy
        self._state: Dict[int, _RankState] = {
            r: _RankState(policy.window) for r in range(n_ranks)}

    def state(self, rank: int, t: float) -> str:
        """``closed`` | ``open`` | ``half_open`` at time ``t`` — the
        transition from open to half_open is time-driven, so the caller
        supplies the clock it places at."""
        st = self._state[rank]
        if not st.open:
            return "closed"
        return "open" if self._now_open(st, t) else "half_open"

    @staticmethod
    def _now_open(st: _RankState, t: float) -> bool:
        return st.open and t < st.until

    def quarantined(self, rank: int, t: float) -> bool:
        """True while the rank must be excluded from placement.  Once
        the cooldown elapses the rank is placeable again (half-open):
        the next recorded outcome decides."""
        st = self._state[rank]
        return st.open and t < st.until

    def quarantined_ranks(self, t: float) -> List[int]:
        return [r for r in sorted(self._state)
                if self.quarantined(r, t)]

    def cooldown_until(self, rank: int) -> float:
        """When the rank's current cooldown ends (0.0 if never opened) —
        the time a placement-layer probe event should fire at."""
        return self._state[rank].until

    def record(self, rank: int, ok: bool, t: float) -> Optional[str]:
        """Fold one step outcome in; returns the transition this record
        caused (``tripped`` / ``restored`` / ``reopened``) or None."""
        st = self._state[rank]
        pol = self.policy
        if st.open:
            if t < st.until:
                # outcomes while open (a job admitted before the trip
                # still finishing on the rank) neither close nor extend
                return None
            # half-open probe: one outcome decides
            if ok:
                st.open = False
                st.trips = 0
                st.history.clear()
                st.history.append(True)
                return "restored"
            st.until = t + (pol.cooldown_seconds
                            * pol.cooldown_factor ** st.trips)
            st.trips += 1
            return "reopened"
        st.history.append(bool(ok))
        if len(st.history) >= pol.min_samples:
            fail = sum(1 for h in st.history if not h) / len(st.history)
            if fail >= pol.trip_rate:
                st.open = True
                st.until = t + (pol.cooldown_seconds
                                * pol.cooldown_factor ** st.trips)
                st.trips += 1
                return "tripped"
        return None
