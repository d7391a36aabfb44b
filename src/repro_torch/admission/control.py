"""Admission control primitives: typed backpressure + token buckets.

Overloaded queues fail slow — latency grows without bound while every
queued job's SLO silently expires.  The admission layer fails *fast*
instead: a bounded queue and per-tenant token-bucket rate limits turn
excess offered load into a typed :class:`AdmissionRejected` (cluster
jobs become ``status="rejected"`` outcomes; :meth:`ServeEngine.submit`
raises) carrying a ``retry_after`` hint — the backpressure signal a
client needs to shed or retry intelligently.

Everything here is deterministic on the caller's clock: a
:class:`TokenBucket` refills as a pure function of the timestamps it is
queried at, so same-seed cluster runs stay bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple


class AdmissionRejected(RuntimeError):
    """Typed backpressure: the system refused new work *now*.

    ``reason`` is machine-readable (``queue_full`` / ``rate_limited`` /
    ``capacity``); ``retry_after`` — when known — is the modeled seconds
    until a retry could succeed (token-bucket refill time)."""

    def __init__(self, tenant: str, reason: str, detail: str = "",
                 retry_after: Optional[float] = None):
        self.tenant = tenant
        self.reason = reason
        self.detail = detail
        self.retry_after = retry_after
        msg = f"{tenant}: {reason}"
        if detail:
            msg += f" ({detail})"
        if retry_after is not None:
            msg += f"; retry after {retry_after:.6g}s"
        super().__init__(msg)


class TokenBucket:
    """Deterministic token bucket on an external clock.

    Holds up to ``burst`` tokens, refilling at ``rate_hz``; one
    admission takes one token.  The caller supplies the timestamps
    (cluster event clock, serve tick count), so refill is a pure
    function of the query times — no wall clock anywhere."""

    def __init__(self, rate_hz: float, burst: float):
        if rate_hz <= 0:
            raise ValueError("rate_hz must be positive")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        self.rate_hz = float(rate_hz)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = 0.0

    def _refill(self, t: float):
        if t > self.t:
            self.tokens = min(self.burst,
                              self.tokens + (t - self.t) * self.rate_hz)
            self.t = t

    def try_take(self, t: float) -> bool:
        """Take one token at time ``t``; False when the bucket is dry."""
        self._refill(t)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after(self) -> float:
        """Seconds (from the last query) until one token is available."""
        return max(0.0, (1.0 - self.tokens) / self.rate_hz)


@dataclass(frozen=True)
class AdmissionPolicy:
    """What :class:`~repro_torch.cluster.scheduler.PimCluster` enforces at the
    arrival boundary.

    * ``max_queue`` — bound on the number of *waiting* (not running)
      jobs; arrivals past it are rejected ``queue_full``.
    * ``rate_limits`` — ``tenant -> (rate_hz, burst)`` token buckets;
      a tenant exceeding its contracted rate is rejected
      ``rate_limited`` without consuming fleet capacity.  Tenants
      absent from the map are unlimited.

    Both default off: ``AdmissionPolicy()`` admits everything, exactly
    like no policy at all."""

    max_queue: Optional[int] = None
    rate_limits: Optional[Mapping[str, Tuple[float, float]]] = None

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        for tenant, (rate, burst) in (self.rate_limits or {}).items():
            if rate <= 0 or burst < 1:
                raise ValueError(f"bad rate limit for {tenant!r}: "
                                 f"rate_hz={rate}, burst={burst}")

    def buckets(self) -> Dict[str, TokenBucket]:
        """Fresh mutable bucket state for one run of this policy."""
        return {tenant: TokenBucket(rate, burst)
                for tenant, (rate, burst) in (self.rate_limits or {}).items()}
