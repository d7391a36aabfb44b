"""Simulated PIM decode pool: the serving engine's accelerator lease.

The :class:`ServeEngine` computes tokens on the host either way (the LM
math is exact); what a PIM pool changes is the *modeled time* of each
decode tick and — under a fault plan — whether the pool is available at
all.  :class:`PimDecodePool` charges each tick as a ``modeled_launch``
on its :class:`~repro_torch.core.host.PIMSystem`, scaled by the surviving-DPU
fraction (fewer healthy banks means each tick re-runs on a smaller
slice of the weight-parallel layout), and surfaces pool exhaustion or
retry-exhausted launches as :class:`DpuFaultError` so the engine can
fall back to host execution instead of crashing mid-stream."""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.faults.model import DpuFaultError, FaultReport


class PimDecodePool:
    """A lease on a PIM system for LM decode ticks.

    ``tick_seconds`` is the healthy-pool modeled time of one pool-wide
    decode step; a degraded pool stretches it by ``D / healthy`` (the
    surviving banks re-stream the dead banks' weight shards).
    ``min_fraction`` is the availability floor: below it the pool
    refuses to serve (a cluster would reschedule the replica) and every
    :meth:`tick` raises :class:`DpuFaultError`."""

    def __init__(self, system, tick_seconds: float = 1e-4,
                 min_fraction: float = 0.25,
                 ranks: Optional[Sequence[int]] = None):
        if tick_seconds <= 0:
            raise ValueError("tick_seconds must be positive")
        if not 0.0 < min_fraction <= 1.0:
            raise ValueError("min_fraction must be in (0, 1]")
        self.system = system
        self.tick_seconds = tick_seconds
        self.min_fraction = min_fraction
        self.ranks = None if ranks is None else list(ranks)
        self.ticks = 0

    @property
    def healthy_fraction(self) -> float:
        """Surviving fraction of the pool's *own* lanes: a lease on a
        rank subset is priced (and floored) by the health of those
        ranks, not of the whole fleet — deaths elsewhere neither slow
        this pool nor trip its floor."""
        mask = self.system.active_mask
        if self.ranks is None:
            total = mask.size
            healthy = int(mask.sum())
        else:
            topo = self.system.topology
            lanes = [d for r in self.ranks
                     for d in range(*topo.dpu_slice(r).indices(mask.size))]
            total = len(lanes)
            healthy = int(mask[lanes].sum())
        return healthy / total if total else 0.0

    def tick(self, n_active: int = 1) -> float:
        """Charge one pool-wide decode tick; returns the modeled seconds.

        Raises :class:`DpuFaultError` when the pool has degraded below
        ``min_fraction`` (or the underlying launch exhausts its
        retries) — the caller is expected to catch it and decode on the
        host instead."""
        frac = self.healthy_fraction
        if frac < self.min_fraction:
            if getattr(self.system, "tracer", None) is not None:
                self.system.tracer.instant(
                    "pool:floor_tripped", self.system.timeline.total,
                    track="serve",
                    args={"healthy_fraction": frac,
                          "min_fraction": self.min_fraction,
                          "ranks": list(self.ranks or ())})
            raise DpuFaultError(FaultReport(
                kind="pool_degraded", label="decode",
                detail=f"PIM pool at {frac:.0%} healthy DPUs "
                       f"< {self.min_fraction:.0%} floor"))
        seconds = self.tick_seconds / frac
        self.system.modeled_launch("decode", seconds, ranks=self.ranks)
        self.ticks += 1
        return seconds

    def estimate(self, ticks: int = 1) -> float:
        """Modeled seconds ``ticks`` decode steps would cost at the
        pool's *current* health — no charge, no fault draw.  Returns
        ``inf`` below the availability floor (the pool would refuse to
        serve).  The serve engine's deadline shedding budgets with
        this."""
        if ticks < 0:
            raise ValueError("ticks must be non-negative")
        frac = self.healthy_fraction
        if frac < self.min_fraction:
            return float("inf")
        return ticks * self.tick_seconds / frac
