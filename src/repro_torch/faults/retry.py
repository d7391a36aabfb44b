"""Retry policies: bounded attempts with exponential backoff, priced as
modeled time.

A :class:`RetryPolicy` governs how the host runtime reacts to retryable
faults (transient kernel faults, link timeouts): each failed attempt is
re-enqueued on the same command stream as a ``phase="retry"`` command
whose full duration counts as *wasted* (it holds real link/compute
resources but produces nothing), followed by an exponentially growing
backoff hold.  The :class:`~repro_torch.core.host.Timeline` accumulates the
"retry" phase separately so benchmarks can report goodput — useful
seconds over total seconds — rather than hiding recovery cost inside
the kernel/h2d buckets."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a faulted command, and at what price.

    ``backoff_after(k)`` is charged as modeled time between attempt
    ``k`` and attempt ``k+1``; ``timeout_seconds`` caps how long a
    single transfer attempt may run before the runtime declares it hung
    (the wasted charge is clipped to the timeout)."""

    max_attempts: int = 3
    backoff_seconds: float = 1e-6      # first backoff (1 µs at 350 MHz scale)
    backoff_factor: float = 2.0
    timeout_seconds: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_seconds < 0:
            raise ValueError("backoff_seconds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if self.timeout_seconds is not None and self.timeout_seconds <= 0:
            raise ValueError("timeout_seconds must be positive")

    def backoff_after(self, attempt: int) -> float:
        """Backoff charged after failed attempt ``attempt`` (0-based)."""
        return self.backoff_seconds * (self.backoff_factor ** attempt)

    def worst_case_seconds(self, ideal: float) -> float:
        """Upper bound on what one command can cost under this policy
        before it either succeeds or exhausts: ``max_attempts - 1``
        failed tries (each clipped to ``timeout_seconds`` when set) plus
        every backoff hold, plus one full-duration success.  This is the
        straggler envelope a :class:`~repro_torch.admission.HedgePolicy`
        trigger should sit inside: a step that has been running longer
        than its ideal price but less than this bound may still just be
        retrying its way to success."""
        if ideal < 0:
            raise ValueError("ideal seconds must be >= 0")
        failed_try = (ideal if self.timeout_seconds is None
                      else min(ideal, self.timeout_seconds))
        total = ideal
        for attempt in range(self.max_attempts - 1):
            total += failed_try + self.backoff_after(attempt)
        return total


#: no retries at all — every fault surfaces immediately (fail-stop)
FAIL_FAST = RetryPolicy(max_attempts=1, backoff_seconds=0.0)

#: runtime default when a FaultPlan is installed without a policy
DEFAULT_POLICY = RetryPolicy()
