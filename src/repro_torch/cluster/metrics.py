"""SLO metrics for cluster runs: per-tenant and fleet-wide latency
percentiles, queueing delay, rank utilization, and goodput.

Everything here is a pure function of the :class:`JobOutcome` records
and rank-busy accounting the scheduler emits from its own event clock —
never of the :class:`repro_torch.sched` overlapped schedule — so the numbers
are bit-identical across ``mode="inorder"`` / ``mode="async"`` systems
and across repeated same-seed runs (the determinism the acceptance
tests pin).

Definitions:

* **latency** — completion minus arrival, completed jobs only;
* **queueing delay** — first placement minus arrival (a preempted or
  rescheduled job keeps its first placement time);
* **goodput** — ideal (fault-free-priced) service seconds of completed
  jobs over actual seconds spent on *all* jobs, including failed jobs'
  partial work, degraded-rank stretch, retry waste, and
  reschedule re-execution — the cluster-level analogue of
  :meth:`repro_torch.sched.scheduler.Schedule.goodput`;
* **utilization** — a rank's occupied seconds over the run makespan;
* **SLO attainment** — fraction of jobs finishing within their
  ``slo_seconds`` (failed, rejected, and shed jobs count as missed);
* **SLO goodput** — ideal seconds of jobs that completed *within SLO*
  over actual seconds spent on all jobs.  Under overload this is the
  honest score: classic goodput stays high while every completion is
  hopelessly late, SLO goodput collapses with attainment — the metric
  the admission/shedding chaos gate compares.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

#: terminal job states
COMPLETED = "completed"
FAILED = "failed"
REJECTED = "rejected"   # refused at the admission boundary (never queued)
SHED = "shed"           # dropped by deadline shedding (SLO provably lost)


@dataclass(frozen=True)
class JobOutcome:
    """Distilled terminal record of one job."""

    jid: int
    tenant: str
    kind: str
    priority: int
    arrival: float
    slo_seconds: float
    status: str                    # completed | failed | rejected | shed
    t_start: Optional[float]       # first placement (None: never placed)
    t_done: float                  # completion or failure time
    spent: float                   # actual seconds charged to the system
    useful: float                  # ideal price of the delivered work
    n_ranks: int
    ranks: tuple = ()              # final placement
    reschedules: int = 0
    preemptions: int = 0
    reason: str = ""               # terminal detail (fault kind, queue_full,
                                   # rate_limited, deadline, ...)
    hedges: int = 0                # speculative duplicates issued
    hedge_wins: int = 0            # duplicates that finished first

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival

    @property
    def queueing(self) -> float:
        return (self.t_start - self.arrival) if self.t_start is not None \
            else self.t_done - self.arrival

    @property
    def slo_met(self) -> bool:
        return self.status == COMPLETED and self.latency <= self.slo_seconds


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("inf")


@dataclass
class ClusterReport:
    """The scheduler's run summary; all metrics derive from these."""

    policy: str
    outcomes: List[JobOutcome] = field(default_factory=list)
    rank_busy: Dict[int, float] = field(default_factory=dict)
    makespan: float = 0.0
    n_ranks: int = 0
    #: admission order as (jid, time, ranks) — pinned by determinism tests
    admissions: List[tuple] = field(default_factory=list)

    # ---- slicing -----------------------------------------------------------
    def tenants(self) -> List[str]:
        return sorted({o.tenant for o in self.outcomes})

    def _of(self, tenant: Optional[str]) -> List[JobOutcome]:
        return [o for o in self.outcomes
                if tenant is None or o.tenant == tenant]

    # ---- metrics -----------------------------------------------------------
    def goodput(self, tenant: Optional[str] = None) -> float:
        """Ideal seconds delivered / actual seconds spent (1.0 when the
        run was fault-free and nothing was rescheduled; 1.0 for an
        empty selection)."""
        sel = self._of(tenant)
        spent = sum(o.spent for o in sel)
        useful = sum(o.useful for o in sel if o.status == COMPLETED)
        return useful / spent if spent > 0 else 1.0

    def slo_goodput(self, tenant: Optional[str] = None) -> float:
        """Ideal seconds of SLO-meeting completions / actual seconds
        spent on *all* jobs — goodput that refuses credit for late
        work (1.0 for an empty selection)."""
        sel = self._of(tenant)
        spent = sum(o.spent for o in sel)
        useful = sum(o.useful for o in sel if o.slo_met)
        return useful / spent if spent > 0 else 1.0

    def utilization(self, rank: Optional[int] = None) -> float:
        """One rank's busy fraction of the makespan (fleet mean when
        ``rank`` is None)."""
        if self.makespan <= 0 or self.n_ranks == 0:
            return 0.0
        if rank is not None:
            return self.rank_busy.get(rank, 0.0) / self.makespan
        return (sum(self.rank_busy.values())
                / (self.n_ranks * self.makespan))

    def metrics(self, tenant: Optional[str] = None) -> Dict[str, float]:
        """The SLO scorecard for one tenant (fleet-wide when None)."""
        sel = self._of(tenant)
        done = [o for o in sel if o.status == COMPLETED]
        lats = [o.latency for o in done]
        queue = [o.queueing for o in sel]
        out = {
            "jobs": len(sel),
            "completed": len(done),
            "failed": sum(1 for o in sel if o.status == FAILED),
            "rejected": sum(1 for o in sel if o.status == REJECTED),
            "shed": sum(1 for o in sel if o.status == SHED),
            "hedges": sum(o.hedges for o in sel),
            "hedge_wins": sum(o.hedge_wins for o in sel),
            "p50_latency": _pct(lats, 50),
            "p99_latency": _pct(lats, 99),
            "mean_queueing": (float(np.mean(queue)) if queue else 0.0),
            "p99_queueing": _pct(queue, 99),
            "slo_attainment": (sum(o.slo_met for o in sel) / len(sel)
                               if sel else 1.0),
            "goodput": self.goodput(tenant),
            "slo_goodput": self.slo_goodput(tenant),
            "reschedules": sum(o.reschedules for o in sel),
            "preemptions": sum(o.preemptions for o in sel),
        }
        if tenant is None:
            out["utilization"] = self.utilization()
        return out

    def table(self) -> str:
        """Formatted per-tenant + fleet scorecard (benchmark output)."""
        rows = []
        hdr = (f"{'tenant':>12} {'jobs':>5} {'done':>5} {'fail':>5} "
               f"{'rej':>4} {'shed':>4} "
               f"{'p50_ms':>8} {'p99_ms':>8} {'queue_ms':>9} "
               f"{'slo':>6} {'goodput':>8} {'slo_gp':>7}")
        rows.append(hdr)
        for name in self.tenants() + [None]:
            m = self.metrics(name)
            label = name if name is not None else "FLEET"
            rows.append(
                f"{label:>12} {m['jobs']:>5d} {m['completed']:>5d} "
                f"{m['failed']:>5d} {m['rejected']:>4d} {m['shed']:>4d} "
                f"{m['p50_latency'] * 1e3:>8.2f} "
                f"{m['p99_latency'] * 1e3:>8.2f} "
                f"{m['mean_queueing'] * 1e3:>9.2f} "
                f"{m['slo_attainment']:>6.2f} {m['goodput']:>8.4f} "
                f"{m['slo_goodput']:>7.4f}")
        rows.append(f"{'':>12} makespan={self.makespan * 1e3:.2f}ms "
                    f"utilization={self.utilization():.2%} "
                    f"policy={self.policy}")
        return "\n".join(rows)
