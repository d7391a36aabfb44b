"""Overload chaos benchmark on the PyTorch/CUDA port: admission control
under arrival and fault pressure, hedged launches under link
degradation, kill-and-resume (benchmarks/overload.py's experiments and
gates, the same rows, on ``repro_torch``; the shared system lives on the
CUDA card unless ``--device cpu`` asks for the CPU).

Three experiments over one shared 8-rank system:

* ``chaos_table`` — sweep offered load (x the calibrated mix) crossed
  with per-launch permanent-fault rate, scoring a FIFO baseline (admit
  everything, run to drain) against the hardened configuration
  (bounded queue + per-tenant token buckets + deadline shedding).
  Under overload the honest metrics separate: FIFO still *completes*
  jobs (classic goodput looks fine) but hopelessly late — SLO
  attainment and SLO goodput collapse; the hardened cluster converts
  the excess into typed rejections/sheds and keeps the work it accepts
  inside its deadlines.
* ``hedge_rows`` — a degraded-link tail-latency study: with
  ``p_link_degrade`` stretching a fraction of transfers by 6x, hedged
  launches re-issue the straggler on idle ranks and take the faster
  copy; p99 latency must drop vs the same stream unhedged.
* ``smoke`` — crash consistency: run with a journal, kill the process
  (``crash_after``) mid-run, resume on a fresh cluster + system, and
  require the resumed :class:`ClusterReport` to be bit-identical to an
  uninterrupted run — in both ``inorder`` and ``async`` modes.

    python benchmarks/torch_overload.py [--scale 1.0] [--device cpu]
    python benchmarks/torch_overload.py --smoke
    python benchmarks/torch_overload.py --check
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.admission import (AdmissionPolicy, CircuitBreaker,  # noqa: E402
                             HedgePolicy, SimulatedCrash)
from repro_torch.cluster import (PimCluster, TenantSpec, poisson_stream,  # noqa: E402
                           scale_rates)
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.faults.model import FaultPlan  # noqa: E402

N_RANKS = 8
SEED = 11
FAULT_SEED = 3


def _system(mode: str = "async",
            faults: Optional[FaultPlan] = None, device=None) -> PIMSystem:
    return PIMSystem(DPUConfig(n_dpus=4 * N_RANKS, n_ranks=N_RANKS,
                               n_channels=4, mram_bytes=1 << 20),
                     mode=mode, faults=faults, device=device)


def tenant_mix() -> List[TenantSpec]:
    """A 4-tenant mix calibrated to ~80% of the 8-rank fleet at 1x —
    every tenant carries a finite SLO, so overload shows up as missed
    deadlines rather than silent queue growth."""
    return [
        TenantSpec("graph", rate_hz=1000.0, kinds=("BFS",), n_ranks=2,
                   priority=1, slo_seconds=0.03),
        TenantSpec("sort", rate_hz=850.0, kinds=("SSORT", "HST-S"),
                   slo_seconds=0.04),
        TenantSpec("lm", rate_hz=500.0, kinds=("lm_decode",), size=8,
                   n_ranks=2, priority=2, slo_seconds=0.02),
        TenantSpec("hist", rate_hz=700.0, kinds=("HST-S",),
                   slo_seconds=0.03),
    ]


def admission_policy() -> AdmissionPolicy:
    """The hardened arm's contract: queue bounded at 2 jobs/rank, each
    tenant rate-limited to its calibrated 1x rate (with a burst) — the
    1.5x excess is the load admission exists to refuse."""
    return AdmissionPolicy(
        max_queue=2 * N_RANKS,
        rate_limits={t.name: (t.rate_hz, 8.0) for t in tenant_mix()})


def _run(jobs, *, faults: Optional[FaultPlan], hardened: bool,
         mode: str = "async", device=None):
    cluster = PimCluster(
        _system(mode, faults, device), policy="fault_aware",
        admission=admission_policy() if hardened else None,
        shedding=hardened)
    return cluster.run(jobs)


def chaos_table(scale: float = 1.0, overloads=(1.0, 1.5),
                fault_rates=(0.0, 0.02), device=None) -> List[Dict]:
    """Per (overload, fault rate, config) scorecard on the same
    streams: FIFO admit-everything vs admission + shedding."""
    horizon = 0.05 * scale
    rows = []
    for over in overloads:
        jobs = poisson_stream(scale_rates(tenant_mix(), over),
                              horizon=horizon, seed=SEED)
        for rate in fault_rates:
            for name, hardened in (("fifo", False), ("admit+shed", True)):
                faults = FaultPlan(seed=FAULT_SEED,
                                   p_dpu_permanent=rate) \
                    if rate > 0 else None
                rep = _run(jobs, faults=faults, hardened=hardened,
                           device=device)
                m = rep.metrics()
                rows.append({
                    "bench": "overload_chaos", "overload": over,
                    "fault_rate": rate, "config": name,
                    "jobs": m["jobs"], "completed": m["completed"],
                    "rejected": m["rejected"], "shed": m["shed"],
                    "failed": m["failed"],
                    "p50_ms": round(m["p50_latency"] * 1e3, 3),
                    "p99_ms": round(m["p99_latency"] * 1e3, 3),
                    "slo": round(m["slo_attainment"], 4),
                    "goodput": round(m["goodput"], 4),
                    "slo_goodput": round(m["slo_goodput"], 4),
                    "makespan_ms": round(rep.makespan * 1e3, 3),
                })
    return rows


def hedge_rows(scale: float = 1.0, device=None) -> List[Dict]:
    """Tail-latency study: 15% of transfers stretched 6x by link
    degradation, moderate load (idle ranks available), hedging on/off
    on the same stream + fault plan."""
    tenants = [
        TenantSpec("graph", rate_hz=150.0, kinds=("BFS",),
                   slo_seconds=0.05),
        TenantSpec("hist", rate_hz=120.0, kinds=("HST-S",),
                   slo_seconds=0.05),
    ]
    jobs = poisson_stream(tenants, horizon=0.05 * scale, seed=SEED)
    faults = FaultPlan(seed=FAULT_SEED, p_link_degrade=0.25,
                       link_degrade_factor=8.0)
    rows = []
    for name, hedge in (("no-hedge", None),
                        ("hedge", HedgePolicy(factor=2.5))):
        cluster = PimCluster(_system("async", faults, device),
                             policy="fault_aware", hedge=hedge)
        rep = cluster.run(jobs)
        m = rep.metrics()
        rows.append({
            "bench": "overload_hedge", "config": name,
            "jobs": m["jobs"], "completed": m["completed"],
            "hedges": m["hedges"], "hedge_wins": m["hedge_wins"],
            "p50_ms": round(m["p50_latency"] * 1e3, 3),
            "p99_ms": round(m["p99_latency"] * 1e3, 3),
            "slo": round(m["slo_attainment"], 4),
            "goodput": round(m["goodput"], 4),
        })
    return rows


# ---- kill-and-resume smoke --------------------------------------------------
def _report_state(rep) -> tuple:
    """Everything the determinism gate compares, as one hashable blob."""
    return (
        tuple(rep.admissions),
        tuple((o.jid, o.tenant, o.kind, o.status, o.t_start, o.t_done,
               o.spent, o.useful, o.ranks, o.reschedules, o.preemptions,
               o.reason, o.hedges, o.hedge_wins)
              for o in rep.outcomes),
        tuple(sorted(rep.rank_busy.items())),
        rep.makespan,
        tuple(sorted(rep.metrics().items())),
    )


def _smoke_cluster(mode: str, journal: Optional[str] = None,
                   crash_after: Optional[int] = None,
                   device=None) -> PimCluster:
    faults = FaultPlan(seed=FAULT_SEED, p_dpu_permanent=0.01,
                       p_link_degrade=0.1, link_degrade_factor=6.0)
    return PimCluster(
        _system(mode, faults, device), policy="fault_aware",
        admission=AdmissionPolicy(max_queue=6), shedding=True,
        hedge=HedgePolicy(factor=2.5),
        breaker=CircuitBreaker(window=8, trip_rate=0.6, min_samples=4),
        journal=journal, crash_after=crash_after)


def smoke(device=None) -> Dict:
    """CI smoke: with every overload feature on, a run killed mid-way
    (simulated crash after 12 journaled step outcomes) and resumed on a
    fresh cluster + fresh system must produce a ClusterReport
    bit-identical to the uninterrupted run — in both queue modes."""
    tenants = [
        TenantSpec("a", rate_hz=500.0, kinds=("BFS", "HST-S"),
                   priority=1, slo_seconds=0.05),
        TenantSpec("b", rate_hz=300.0, kinds=("lm_decode",), size=4,
                   slo_seconds=0.04),
    ]
    jobs = poisson_stream(tenants, horizon=0.04, seed=SEED)
    out = {"bench": "overload_resume", "jobs": len(jobs)}
    for mode in ("inorder", "async"):
        ref = _smoke_cluster(mode, device=device).run(jobs)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "cluster.journal")
            crashed = _smoke_cluster(mode, journal=path, crash_after=12,
                                     device=device)
            try:
                crashed.run(jobs)
                raise SystemExit("FAIL: crash_after=12 never crashed "
                                 "(stream too short for the smoke)")
            except SimulatedCrash:
                pass
            resumed = _smoke_cluster(mode, journal=path,
                                     device=device).run(jobs)
        if _report_state(ref) != _report_state(resumed):
            raise SystemExit(
                f"FAIL: resumed report diverges from the uninterrupted "
                f"run in mode={mode}")
        m = ref.metrics()
        out[f"{mode}_completed"] = m["completed"]
        out[f"{mode}_slo"] = round(m["slo_attainment"], 4)
    return out


def check(scale: float = 1.0, device=None) -> List[Dict]:
    """CI gates.  (1) chaos: at 1.5x overload + 2% faults the hardened
    config must score strictly higher SLO attainment AND strictly
    higher SLO goodput than FIFO on the same stream.  (2) hedging: under
    link degradation, hedged p99 latency must be strictly lower than
    unhedged (and hedges must actually fire)."""
    rows = chaos_table(scale, overloads=(1.5,), fault_rates=(0.02,),
                       device=device)
    by = {r["config"]: r for r in rows}
    hard, fifo = by["admit+shed"], by["fifo"]
    if not hard["slo"] > fifo["slo"]:
        raise SystemExit(
            f"FAIL: admission+shedding SLO attainment {hard['slo']} must "
            f"strictly beat FIFO {fifo['slo']} at 1.5x overload + 2% "
            "faults")
    if not hard["slo_goodput"] > fifo["slo_goodput"]:
        raise SystemExit(
            f"FAIL: admission+shedding SLO goodput {hard['slo_goodput']} "
            f"must strictly beat FIFO {fifo['slo_goodput']} at 1.5x "
            "overload + 2% faults")
    hrows = hedge_rows(scale, device)
    hby = {r["config"]: r for r in hrows}
    hed, base = hby["hedge"], hby["no-hedge"]
    if not hed["hedges"] > 0:
        raise SystemExit("FAIL: the hedge configuration never hedged")
    if not hed["p99_ms"] < base["p99_ms"]:
        raise SystemExit(
            f"FAIL: hedged p99 {hed['p99_ms']} ms must be strictly below "
            f"unhedged {base['p99_ms']} ms under link degradation")
    return rows + hrows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true",
                    help="kill-and-resume bit-identical, both modes")
    ap.add_argument("--check", action="store_true",
                    help="gates: hardened beats FIFO under chaos; "
                         "hedging cuts p99 under link degradation")
    ap.add_argument("--device", default=None,
                    help="torch device of the shared system (default: the "
                         "CUDA card; cpu asks for the CPU)")
    args = ap.parse_args()

    if args.smoke:
        row = smoke(args.device)
        print(f"overload smoke OK: {row['jobs']} jobs, resume "
              f"bit-identical in both modes "
              f"(async slo={row['async_slo']})")
        return
    if args.check:
        rows = check(args.scale, args.device)
        by = {r["config"]: r for r in rows if "overload" in r}
        print(f"overload check OK: admit+shed slo "
              f"{by['admit+shed']['slo']} > fifo {by['fifo']['slo']}; "
              f"slo_goodput {by['admit+shed']['slo_goodput']} > "
              f"{by['fifo']['slo_goodput']}")
        return

    rows = chaos_table(args.scale, device=args.device)
    print(f"{'over':>5} {'rate':>5} {'config':>11} {'jobs':>5} "
          f"{'done':>5} {'rej':>4} {'shed':>4} {'fail':>4} "
          f"{'p50_ms':>8} {'p99_ms':>8} {'slo':>6} {'goodput':>8} "
          f"{'slo_gp':>7}")
    for r in rows:
        print(f"{r['overload']:>5.2f} {r['fault_rate']:>5.2f} "
              f"{r['config']:>11} {r['jobs']:>5} {r['completed']:>5} "
              f"{r['rejected']:>4} {r['shed']:>4} {r['failed']:>4} "
              f"{r['p50_ms']:>8.2f} {r['p99_ms']:>8.2f} {r['slo']:>6.3f} "
              f"{r['goodput']:>8.4f} {r['slo_goodput']:>7.4f}")
    print()
    hrows = hedge_rows(args.scale, args.device)
    for r in hrows:
        print(f"{r['config']:>11}: p50 {r['p50_ms']:.2f} ms, "
              f"p99 {r['p99_ms']:.2f} ms, hedges {r['hedges']} "
              f"(wins {r['hedge_wins']}), slo {r['slo']:.3f}")
    print("\nUnder 1.5x overload FIFO completes everything late (classic "
          "goodput hides it); admission + shedding keeps accepted work "
          "inside deadline — SLO attainment and SLO goodput carry the "
          "comparison.  Hedging trades duplicate (shed-phase) work for "
          "the tail: p99 drops when a straggling transfer's re-issue "
          "wins the race.")


if __name__ == "__main__":
    main()
