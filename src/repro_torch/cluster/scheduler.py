"""Multi-tenant cluster scheduler: trace-driven admission onto disjoint
rank subsets with pluggable, fault-aware placement.

The cluster turns the per-rank resource model (PR 4: subset launches,
``chan<c>:rank<r>`` link shares) and the fault layer (PR 6:
``active_mask``, retry pricing, degraded pools) into a system model: a
stream of :class:`~repro_torch.cluster.arrivals.JobSpec`\\ s is admitted onto
disjoint rank subsets of ONE shared :class:`~repro_torch.core.host.PIMSystem`,
with priority queues, preemption at kernel-launch boundaries, and a
placement policy that may read the live fault state.

**Execution model.**  Each job is planned as an ordered list of
:class:`JobStep`\\ s — its recorded command stream.  The PrIM job kinds
(BFS, HST-S, SSORT) are planned from a :class:`JobProfile` captured by
running the *real* workload once (:func:`measure_profile` wraps
``Workload.run`` on a reference rank and replays its timeline events);
``lm_decode`` jobs tick a :class:`~repro_torch.serve.pim_pool.PimDecodePool`
leased on the job's ranks.  Every step is submitted to the shared
system — transfers re-priced by the :class:`RankTopology` on the job's
lanes, kernels as ``modeled_launch`` on the job's ranks — so retries,
link degradation, and permanent DPU deaths from the system's
:class:`FaultPlan` land on tenants exactly as the fault runtime prices
them, and disjoint-rank tenants overlap in an async schedule.

**Clock.**  The cluster advances its own event clock from the *modeled
seconds* each submission charges (``timeline.total`` deltas, which are
eager and mode-independent), never from the overlapped
:mod:`repro_torch.sched` schedule — same-seed runs are bit-deterministic
across ``mode="inorder"``/``"async"`` and across repeats.

**Placement policies** (``policy=``):

* ``first_fit``   — lowest-indexed free ranks, blind to health;
* ``best_fit``    — free ranks with the *fewest* surviving DPUs first
  (pack degraded capacity, keep healthy ranks free — the bin-packing
  instinct, exactly wrong under faults);
* ``fault_aware`` — skip ranks degraded below ``health_floor``, prefer
  the healthiest ranks, promote provisioned spares fleet-wide when a
  rank is retired, and reschedule a job (replica restart; ``lm_decode``
  resumes its remaining ticks) when its ranks die or its decode pool
  trips ``min_fraction`` mid-run.

Degraded execution is priced like the PR 6 decode pool: a kernel step on
a subset with ``h`` of ``n`` lanes alive stretches by ``n / h`` (the
survivors re-stream the dead lanes' shards), so parking tenants on sick
ranks costs real goodput.

**Overload robustness** (all default-off; disabled runs are bit-exact
with the pre-admission scheduler):

* ``admission=`` — an :class:`~repro_torch.admission.AdmissionPolicy`: bounded
  queue + per-tenant token buckets; refused arrivals become
  ``status="rejected"`` outcomes instead of unbounded queue growth;
* ``shedding=True`` — deadline-aware load shedding: before placement
  (and at step boundaries) a job whose optimistic remaining-service
  estimate provably misses ``arrival + slo_seconds`` is dropped as
  ``status="shed"`` rather than burning rank-seconds on a dead SLO;
* ``hedge=`` — a :class:`~repro_torch.admission.HedgePolicy`: straggler steps
  (link degrade, retry storms) are speculatively re-issued on idle
  ranks, first completion wins, both sides cancel-priced (duplicate
  submissions land in the timeline ``shed`` phase);
* ``breaker=`` — a :class:`~repro_torch.admission.CircuitBreaker`: ranks
  whose rolling step-fault rate trips are quarantined out of placement
  and probed back in after a cooldown;
* ``journal=`` — JSONL write-ahead log of step outcomes (+ leases); a
  killed run resumed on a fresh cluster/system replays to a
  bit-identical :class:`ClusterReport` (see
  :mod:`repro_torch.admission.journal`).
"""
from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.admission import (AdmissionPolicy, CircuitBreaker, ClusterJournal,
                             HedgePolicy, RankBreakers, SimulatedCrash)
from repro_torch.cluster.arrivals import JobSpec
from repro_torch.cluster.metrics import (COMPLETED, FAILED, REJECTED, SHED,
                                   ClusterReport, JobOutcome)
from repro_torch.faults.model import DpuFaultError, FaultReport
from repro_torch.obs.tracer import PID_CLUSTER, Tracer

POLICIES = ("first_fit", "best_fit", "fault_aware")

# job run states
_QUEUED, _RUNNING, _DONE = "queued", "running", "done"


@dataclass(frozen=True)
class JobStep:
    """One replayable command of a job's plan.

    ``h2d``/``d2h`` steps carry per-DPU bytes (re-priced on the job's
    lanes by the topology); ``kernel``/``inter_dpu`` steps carry the
    profiled healthy-subset seconds; ``tick`` steps are priced by the
    job's :class:`PimDecodePool` lease."""

    phase: str                     # h2d | kernel | inter_dpu | d2h | tick
    seconds: float = 0.0
    bytes_per_dpu: float = 0.0
    nbytes: float = 0.0            # exchange payload (reporting only)
    label: str = ""


@dataclass(frozen=True)
class JobProfile:
    """Recorded command stream of one job kind at ``size = 1``."""

    kind: str
    steps: Tuple[JobStep, ...]

    def plan(self, size: float) -> List[JobStep]:
        """Scale the profile to a job size (work multiplier)."""
        out = []
        for s in self.steps:
            out.append(JobStep(s.phase, s.seconds * size,
                               s.bytes_per_dpu * size, s.nbytes * size,
                               s.label))
        return out


_MEASURED_CACHE: Dict[tuple, JobProfile] = {}


def measure_profile(kind: str, *, n_dpus: int = 4, n_threads: int = 8,
                    scale: float = 0.05, seed: int = 0,
                    mram_bytes: int = 1 << 21, device=None) -> JobProfile:
    """Capture a job kind's command stream by running the real workload
    (``Workload.run`` — kernels, collectives, oracle check and all) on a
    fresh single-rank reference system, then distilling its timeline
    events into replayable steps.  Cached per parameter set: the engine
    runs once per kind, every job replays the recording.  ``device`` is
    the torch device the reference rank runs on: None means the CUDA card
    and raises without one (as ``PIMSystem`` does); the cache keys on it,
    so a profile measured on one device is never served for another."""
    from repro_torch.core.compile_cache import resolve_device
    device = resolve_device(device)
    key = (kind, n_dpus, n_threads, scale, seed, mram_bytes, str(device))
    if key in _MEASURED_CACHE:
        return _MEASURED_CACHE[key]
    import repro_torch.workloads as wl
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    system = PIMSystem(DPUConfig(n_dpus=n_dpus, n_tasklets=n_threads,
                                 mram_bytes=mram_bytes), device=device)
    wl.get(kind).run(system, n_threads=n_threads, scale=scale, seed=seed)
    steps: List[JobStep] = []
    for phase, label, sec, nbytes in system.timeline.events:
        if phase in ("h2d", "d2h"):
            steps.append(JobStep(phase, bytes_per_dpu=nbytes / n_dpus,
                                 label=label))
        elif phase == "kernel":
            steps.append(JobStep("kernel", seconds=sec, label=label))
        elif phase == "inter_dpu":
            steps.append(JobStep("inter_dpu", seconds=sec, nbytes=nbytes,
                                 label=label))
    prof = JobProfile(kind=kind, steps=tuple(steps))
    _MEASURED_CACHE[key] = prof
    return prof


def synthetic_profiles() -> Dict[str, JobProfile]:
    """Engine-free stand-in profiles with each kind's characteristic
    shape (BFS iterates kernel+frontier exchange; HST-S is one
    bucket-count kernel; SSORT alternates sort kernels with splitter /
    bucket alltoall exchanges).  Tests and quick sweeps use these;
    ``profiles="measured"`` records the real workloads instead."""
    mk = JobStep
    return {
        "BFS": JobProfile("BFS", (
            mk("h2d", bytes_per_dpu=16384, label="bfs:stage"),
            mk("kernel", seconds=8e-4, label="bfs:iter0"),
            mk("inter_dpu", seconds=2e-4, nbytes=4096, label="frontier"),
            mk("kernel", seconds=8e-4, label="bfs:iter1"),
            mk("inter_dpu", seconds=2e-4, nbytes=4096, label="frontier"),
            mk("kernel", seconds=8e-4, label="bfs:iter2"),
            mk("d2h", bytes_per_dpu=4096, label="bfs:levels"),
        )),
        "HST-S": JobProfile("HST-S", (
            mk("h2d", bytes_per_dpu=32768, label="hst:stage"),
            mk("kernel", seconds=1.2e-3, label="hst:count"),
            mk("d2h", bytes_per_dpu=1024, label="hst:bins"),
        )),
        "SSORT": JobProfile("SSORT", (
            mk("h2d", bytes_per_dpu=32768, label="ssort:stage"),
            mk("kernel", seconds=9e-4, label="ssort:local"),
            mk("inter_dpu", seconds=3e-4, nbytes=8192, label="splitters"),
            mk("inter_dpu", seconds=5e-4, nbytes=32768, label="buckets"),
            mk("kernel", seconds=1.1e-3, label="ssort:merge"),
            mk("d2h", bytes_per_dpu=32768, label="ssort:runs"),
        )),
    }


def trace_profile(records, kind: str = "") -> JobProfile:
    """Distill a :mod:`repro_torch.trace` recording (a saved path or a loaded
    record list) into a replayable :class:`JobProfile` — replay-driven
    admission: record one *real* run of a workload, then sweep the
    cluster with its exact command stream instead of the hand-written
    :func:`synthetic_profiles` shapes.

    Transfer steps recover the per-DPU byte request from the recorder's
    re-pricing spec (``meta["bytes"]``, scalar or vector — vectors
    collapse to the mean non-zero lane so the cluster can re-shape the
    request onto a job's lanes); kernel and collective steps carry the
    recorded modeled seconds.  Retry-phase records (fault-runtime waste)
    are skipped: the profile is the *ideal* stream, and the cluster's
    own :class:`FaultPlan` re-prices faults at replay time."""
    if isinstance(records, (str, os.PathLike)):
        from repro_torch.trace.record import load
        records = load(records)
    header = next((r for r in records if r.get("type") == "header"), None)
    if header is None:
        raise ValueError("not a repro_torch.trace recording: no header record")
    n_dpus = int(header["cfg"]["n_dpus"])
    steps: List[JobStep] = []
    for rec in records:
        if rec.get("type") != "cmd":
            continue
        phase, label = rec.get("phase"), rec.get("label", "")
        if phase in ("h2d", "d2h"):
            per = (rec.get("meta") or {}).get("bytes")
            if per is None:
                # degraded/faulted transfer recorded without a spec:
                # fall back to total payload spread across all lanes
                per = float(rec.get("nbytes", 0.0)) / n_dpus
            elif isinstance(per, (list, tuple)):
                nz = [float(b) for b in per if b]
                per = sum(nz) / len(nz) if nz else 0.0
            steps.append(JobStep(phase, bytes_per_dpu=float(per),
                                 label=label))
        elif phase == "kernel":
            steps.append(JobStep("kernel", seconds=float(rec["seconds"]),
                                 label=label))
        elif phase == "inter_dpu":
            steps.append(JobStep("inter_dpu",
                                 seconds=float(rec["seconds"]),
                                 nbytes=float(rec.get("nbytes", 0.0)),
                                 label=label))
    if not steps:
        raise ValueError("recording contains no replayable commands")
    return JobProfile(kind=kind or "trace", steps=tuple(steps))


def trace_profiles(recordings: Dict[str, object]) -> Dict[str, JobProfile]:
    """``{kind: recording}`` (paths or record lists) to cluster
    profiles — a drop-in for ``profiles=`` on :class:`PimCluster`."""
    return {k: trace_profile(v, kind=k) for k, v in recordings.items()}


class _Run:
    """Mutable per-job scheduler state."""

    __slots__ = ("spec", "steps", "next_step", "ranks", "lanes", "pool",
                 "t_start", "t_done", "spent", "ideal_acc", "useful",
                 "reschedules", "preemptions", "preempt_flag", "state",
                 "fail_reason", "pending_release", "est_suffix", "hedges",
                 "hedge_wins")

    def __init__(self, spec: JobSpec, steps: List[JobStep]):
        self.spec = spec
        self.steps = steps
        self.next_step = 0
        self.ranks: Optional[Tuple[int, ...]] = None
        self.lanes: List[int] = []
        self.pool = None
        self.t_start: Optional[float] = None
        self.t_done = 0.0
        self.spent = 0.0
        self.ideal_acc = 0.0
        self.useful = 0.0
        self.reschedules = 0
        self.preemptions = 0
        self.preempt_flag = False
        self.state = _QUEUED
        self.fail_reason = ""
        self.pending_release: List[int] = []   # hedge losers to free
        self.est_suffix: Optional[List[float]] = None
        self.hedges = 0
        self.hedge_wins = 0


@dataclass
class ClusterLease:
    """An open-ended rank reservation for a serving tenant: the cluster
    places it like a job and hands back a :class:`PimDecodePool` bound
    to the ranks (see ``examples/serve_lm.py --cluster``)."""

    tenant: str
    ranks: Tuple[int, ...]
    pool: object = None
    active: bool = True


class PimCluster:
    """Admission + placement + SLO accounting over one shared system.

    ``spare_ranks`` reserves the highest-numbered ranks out of normal
    placement; only the ``fault_aware`` policy *promotes* them (into the
    schedulable pool, fleet-wide, when a rank degrades below
    ``health_floor`` and is retired) — under the other policies the
    provisioned spares sit idle, which is exactly the comparison the
    fault-tolerance study wants to price."""

    def __init__(self, system, policy: str = "fault_aware", *,
                 profiles="synthetic", health_floor: float = 0.5,
                 spare_ranks: int = 0, preemption: bool = True,
                 max_reschedules: int = 3, lm_tick_seconds: float = 1e-4,
                 lm_min_fraction: float = 0.25,
                 profile_scale: float = 0.05,
                 tracer: Optional[Tracer] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 shedding: bool = False,
                 hedge: Optional[HedgePolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 journal: Optional[str] = None,
                 crash_after: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown placement policy {policy!r} "
                             f"(want one of {POLICIES})")
        n_ranks = system.topology.n_ranks
        if not 0 <= spare_ranks < n_ranks:
            raise ValueError(f"spare_ranks={spare_ranks} must leave at "
                             f"least one schedulable rank of {n_ranks}")
        if crash_after is not None and journal is None:
            raise ValueError("crash_after requires journal= (the crash "
                             "is defined as losing everything BUT the "
                             "journal)")
        self.system = system
        self.topology = system.topology
        self.policy = policy
        self.health_floor = health_floor
        self.preemption = preemption
        self.max_reschedules = max_reschedules
        self.lm_tick_seconds = lm_tick_seconds
        self.lm_min_fraction = lm_min_fraction
        self.profile_scale = profile_scale
        self._profiles_arg = profiles
        self.schedulable = set(range(n_ranks - spare_ranks))
        self.spares: List[int] = list(range(n_ranks - spare_ranks, n_ranks))
        self.retired: set = set()
        self._owner: Dict[int, object] = {}     # rank -> _Run | ClusterLease
        self.clock = 0.0
        self._seq = 0
        self._events: List[tuple] = []          # (time, seq, tag, jid)
        self._runs: Dict[int, _Run] = {}
        self._queue: List[_Run] = []
        self.report = ClusterReport(policy=policy, n_ranks=n_ranks)
        self._ran = False
        # overload hardening (all default-off; see module docstring)
        self.admission = admission
        self.shedding = bool(shedding)
        self.hedge = hedge
        self.crash_after = crash_after
        self._buckets = admission.buckets() if admission is not None else {}
        self.breakers = (RankBreakers(breaker, n_ranks)
                         if breaker is not None else None)
        self._steps_written = 0
        self._journal: Optional[ClusterJournal] = None
        self._replay: Optional[List[dict]] = None
        self._rpos = 0
        if journal is not None:
            from repro_torch.admission.journal import JOURNAL_VERSION
            recs = ClusterJournal.load(journal)
            if recs:
                head = recs[0]
                if (head.get("type") != "header"
                        or head.get("version") != JOURNAL_VERSION):
                    raise ValueError(f"{journal}: not a cluster journal")
                if (head.get("policy") != policy
                        or head.get("n_ranks") != n_ranks
                        or head.get("spare_ranks") != spare_ranks):
                    raise ValueError(
                        f"{journal}: written by a differently-configured "
                        f"cluster (policy={head.get('policy')}, "
                        f"n_ranks={head.get('n_ranks')}, "
                        f"spare_ranks={head.get('spare_ranks')})")
                self._replay = recs
                self._rpos = 1     # header consumed
                self._journal = ClusterJournal(journal, append=True)
            else:
                self._journal = ClusterJournal(journal)
                self._journal.write({
                    "type": "header", "version": JOURNAL_VERSION,
                    "policy": policy, "n_ranks": n_ranks,
                    "spare_ranks": spare_ranks})
        # observability: explicit tracer, else the shared system's (the
        # cluster view lands in the same export as the schedule spans,
        # on its own event-clock pid)
        self.tracer = tracer if tracer is not None \
            else getattr(system, "tracer", None)

    # ---- observability -----------------------------------------------------
    @property
    def trace(self) -> dict:
        """The run's Chrome-trace-event JSON (Perfetto-ready): cluster
        job spans per tenant lane, per-rank occupancy slices, and
        admission/preemption/fault/spare-promotion instants — plus, when
        the tracer is shared with the system (the default), the
        overlapped schedule's per-resource spans.  Requires tracing to
        be enabled (``tracer=`` here or on the system)."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is disabled: build the cluster (or its system) "
                "with tracer=repro_torch.obs.Tracer() to export a trace")
        return self.tracer.to_chrome_trace()

    def _instant(self, name: str, t: float, **args):
        if self.tracer is not None:
            self.tracer.instant(name, t, track="cluster", pid=PID_CLUSTER,
                                args=args)

    # ---- profiles ----------------------------------------------------------
    def _profile(self, kind: str) -> JobProfile:
        if isinstance(self._profiles_arg, dict):
            return self._profiles_arg[kind]
        if self._profiles_arg == "synthetic":
            self._profiles_arg = synthetic_profiles()
            return self._profiles_arg[kind]
        if self._profiles_arg == "measured":
            self._profiles_arg = {
                k: measure_profile(
                    k, n_dpus=self.topology.dpus_per_rank,
                    scale=self.profile_scale, device=self.system.device)
                for k in ("BFS", "HST-S", "SSORT")}
            return self._profiles_arg[kind]
        raise ValueError(f"profiles must be 'synthetic', 'measured', or a "
                         f"dict, got {self._profiles_arg!r}")

    def _plan(self, spec: JobSpec) -> List[JobStep]:
        if spec.kind == "lm_decode":
            ticks = max(1, int(round(spec.size)))
            return [JobStep("tick", label="decode")] * ticks
        return self._profile(spec.kind).plan(spec.size)

    # ---- health / placement ------------------------------------------------
    def _rank_lanes(self, rank: int) -> List[int]:
        sl = self.topology.dpu_slice(rank)
        return list(range(*sl.indices(self.topology.n_dpus)))

    def _healthy(self, rank: int) -> int:
        return int(self.system.active_mask[self._rank_lanes(rank)].sum())

    def _health_frac(self, rank: int) -> float:
        per = self.topology.dpus_per_rank
        return self._healthy(rank) / per if per else 0.0

    def _refresh_health(self):
        """fault_aware bookkeeping: retire ranks degraded below the
        floor and promote a provisioned spare for each (fleet-wide —
        the spare joins the general pool, not one tenant)."""
        if self.policy != "fault_aware":
            return
        for r in sorted(self.schedulable):
            if self._health_frac(r) < self.health_floor:
                self.schedulable.discard(r)
                self.retired.add(r)
                self._instant("rank:retired", self.clock, rank=r,
                              health=self._health_frac(r))
                while self.spares:
                    s = self.spares.pop(0)
                    if self._health_frac(s) >= self.health_floor:
                        self.schedulable.add(s)
                        self._instant("spare:promoted", self.clock,
                                      rank=s, replacing=r)
                        break
                    self.retired.add(s)

    def _free_ranks(self, extra: Sequence[int] = (),
                    t: Optional[float] = None) -> List[int]:
        free = [r for r in self.schedulable if r not in self._owner]
        if self.breakers is not None:
            tt = self.clock if t is None else t
            free = [r for r in free
                    if not self.breakers.quarantined(r, tt)]
        return sorted(set(free) | set(extra))

    def _place(self, n: int, extra: Sequence[int] = (),
               t: Optional[float] = None) -> Optional[Tuple[int, ...]]:
        """Pick ``n`` free ranks under the policy (None: no placement).
        ``extra`` dry-runs a preemption (the victim's ranks counted as
        free); ``t`` is the decision time for breaker quarantine checks
        (default: the cluster clock)."""
        free = self._free_ranks(extra, t)
        if self.policy == "first_fit":
            pick = free
        elif self.policy == "best_fit":
            pick = sorted(free, key=lambda r: (self._healthy(r), r))
        else:  # fault_aware: healthiest first, floor-filtered
            pick = sorted((r for r in free
                           if self._health_frac(r) >= self.health_floor),
                          key=lambda r: (-self._healthy(r), r))
        if len(pick) < n:
            return None
        return tuple(sorted(pick[:n]))

    def _capacity(self) -> int:
        return len(self.schedulable) + (len(self.spares)
                                        if self.policy == "fault_aware"
                                        else 0)

    # ---- event plumbing ----------------------------------------------------
    def _push(self, t: float, tag: str, jid: int):
        heapq.heappush(self._events, (t, self._seq, tag, jid))
        self._seq += 1

    def _charge(self, ranks: Sequence[int], seconds: float):
        for r in ranks:
            self.report.rank_busy[r] = \
                self.report.rank_busy.get(r, 0.0) + seconds

    # ---- job lifecycle -----------------------------------------------------
    def _admit(self, run: _Run, t: float, ranks: Tuple[int, ...]):
        run.ranks = ranks
        run.lanes = [d for r in ranks for d in self._rank_lanes(r)]
        run.state = _RUNNING
        if run.t_start is None:
            run.t_start = t
        for r in ranks:
            self._owner[r] = run
        if run.spec.kind == "lm_decode":
            from repro_torch.serve.pim_pool import PimDecodePool
            run.pool = PimDecodePool(
                self.system, tick_seconds=self.lm_tick_seconds,
                min_fraction=self.lm_min_fraction, ranks=list(ranks))
        self.report.admissions.append((run.spec.jid, t, ranks))
        self._instant("job:admit", t, jid=run.spec.jid,
                      tenant=run.spec.tenant, kind=run.spec.kind,
                      ranks=list(ranks))
        self._start_step(run, t)

    def _release(self, run: _Run):
        for r in (run.ranks or ()):
            if self._owner.get(r) is run:
                del self._owner[r]
        for r in run.pending_release:
            if self._owner.get(r) is run:
                del self._owner[r]
        run.pending_release = []
        run.ranks = None
        run.lanes = []
        run.pool = None

    def _finalize(self, run: _Run, t: float, status: str, reason: str = ""):
        run.state = _DONE
        run.t_done = t
        run.fail_reason = reason
        if status == COMPLETED:
            run.useful = run.ideal_acc
        ranks = tuple(run.ranks or ())
        self._release(run)
        s = run.spec
        self.report.outcomes.append(JobOutcome(
            jid=s.jid, tenant=s.tenant, kind=s.kind, priority=s.priority,
            arrival=s.arrival, slo_seconds=s.slo_seconds, status=status,
            t_start=run.t_start, t_done=t, spent=run.spent,
            useful=run.useful, n_ranks=s.n_ranks, ranks=ranks,
            reschedules=run.reschedules, preemptions=run.preemptions,
            reason=reason, hedges=run.hedges,
            hedge_wins=run.hedge_wins))
        if self.tracer is not None:
            # whole-job span on the tenant's lane: arrival -> terminal;
            # async (b/e) export so concurrent jobs of one tenant nest
            self.tracer.span(
                f"{s.tenant}/j{s.jid}:{s.kind}", s.arrival, t,
                (f"tenant:{s.tenant}",), pid=PID_CLUSTER,
                async_id=s.jid,
                args={"status": status, "reason": run.fail_reason,
                      "spent_s": run.spent, "ranks": list(ranks),
                      "reschedules": run.reschedules,
                      "preemptions": run.preemptions})
            if status == FAILED:
                self._instant("job:failed", t, jid=s.jid,
                              tenant=s.tenant, reason=run.fail_reason)

    def _submit_step(self, run: _Run, step: JobStep, label: str):
        """Charge one step to the shared system; returns ``(ideal,
        clean)`` — the step's fault-free price and whether this
        submission applied no degradation stretch.  Raises
        :class:`DpuFaultError` when the job's ranks cannot serve it."""
        system = self.system
        if step.phase in ("h2d", "d2h"):
            vec = np.zeros(self.topology.n_dpus)
            vec[run.lanes] = step.bytes_per_dpu
            ideal = self.topology.schedule(vec, step.phase).seconds
            (system.h2d if step.phase == "h2d" else system.d2h)(
                vec, label=f"{label}:{step.label or step.phase}")
            return ideal, True
        if step.phase == "kernel":
            # degraded-subset stretch (the PR 6 decode-pool model): the
            # survivors re-stream dead lanes' shards.  The mask is read
            # before the launch; the launch itself advances permanent
            # deaths and raises when no lane survives.
            h = int(system.active_mask[run.lanes].sum())
            stretch = len(run.lanes) / h if h else 1.0
            system.modeled_launch(f"{label}:{step.label or 'kernel'}",
                                  step.seconds * stretch, ranks=run.ranks)
            return step.seconds, stretch == 1.0
        if step.phase == "inter_dpu":
            system.collective(f"{label}:{step.label or 'exchange'}",
                              step.seconds, step.nbytes, ranks=run.ranks)
            return step.seconds, True
        if step.phase == "tick":
            clean = run.pool.healthy_fraction == 1.0
            run.pool.tick()
            return run.pool.tick_seconds, clean
        raise ValueError(f"unknown step phase {step.phase!r}")

    def _start_step(self, run: _Run, t: float):
        step = run.steps[run.next_step]
        label = f"{run.spec.tenant}/j{run.spec.jid}"
        if self._replay_active():
            # crash recovery: the outcome already happened — apply it
            # from the journal instead of re-submitting, fast-forwarding
            # the system's fault-stream counters so post-resume live
            # steps draw exactly the luck the uninterrupted run would
            rec = self._replay_take(("step", "fault"))
            self._apply_record(run, t, step, label, rec)
            return
        timeline = self.system.timeline
        before = timeline.total
        retry0, nlog0 = timeline.retry, len(self.system.fault_log)
        try:
            with self.system.stream(f"tenant:{run.spec.tenant}"):
                ideal, clean = self._submit_step(run, step, label)
        except DpuFaultError as err:
            delta = timeline.total - before
            self._journal_step({
                "type": "fault", "jid": run.spec.jid,
                "idx": run.next_step, "delta": delta,
                "kind": err.report.kind,
                "li": self.system._launch_idx,
                "xi": self.system._xfer_idx,
                "tl": self._tl_snapshot()})
            run.spent += delta
            self._charge(run.ranks or (), delta)
            self._breaker_record(run.ranks or (), False, t + delta)
            self._fault(run, t + delta, err)
            return
        delta = timeline.total - before
        # a clean step's ideal price IS what it charged — credit the
        # measured delta so a fault-free run's goodput is exactly 1.0
        # (crediting the analytic price would drift by accumulator
        # rounding); any retry waste or logged fault voids the shortcut
        clean = (clean and timeline.retry == retry0
                 and len(self.system.fault_log) == nlog0)
        credit = delta if clean else ideal
        hedge = None
        if (self.hedge is not None
                and step.phase in ("h2d", "d2h", "kernel")
                and delta > self.hedge.trigger(ideal)):
            hedge = self._issue_hedge(run, step, label, t)
        rec = {"type": "step", "jid": run.spec.jid, "idx": run.next_step,
               "delta": delta, "credit": credit, "clean": clean,
               "li": self.system._launch_idx,
               "xi": self.system._xfer_idx,
               "tl": self._tl_snapshot()}
        if hedge is not None:
            rec["hedge"] = hedge
        self._journal_step(rec)
        self._commit_step(run, t, step, label, delta, credit, clean, hedge)

    def _issue_hedge(self, run: _Run, step: JobStep, label: str,
                     t: float) -> Optional[dict]:
        """Speculatively duplicate a straggling step on idle ranks.  The
        duplicate runs in the tenant's stream but lands in the timeline
        ``shed`` phase (marked fully wasted at submit: exactly one of
        the pair is redundant by construction) and draws its own luck
        from the fault stream.  Returns the hedge record for
        :meth:`_commit_step`, or None when no idle placement exists."""
        ranks = self._place(run.spec.n_ranks, t=t)
        if ranks is None:
            return None
        lanes = [d for r in ranks for d in self._rank_lanes(r)]
        system = self.system
        timeline = system.timeline
        before = timeline.total
        retry0, nlog0 = timeline.retry, len(system.fault_log)
        name = f"{label}:{step.label or step.phase}:hedge"
        failed = False
        try:
            with system.stream(f"tenant:{run.spec.tenant}"):
                if step.phase in ("h2d", "d2h"):
                    vec = np.zeros(self.topology.n_dpus)
                    vec[lanes] = step.bytes_per_dpu
                    (system.h2d if step.phase == "h2d" else system.d2h)(
                        vec, label=name, phase="shed")
                else:
                    h = int(system.active_mask[lanes].sum())
                    stretch = len(lanes) / h if h else 1.0
                    system.modeled_launch(name, step.seconds * stretch,
                                          ranks=ranks, phase="shed")
        except DpuFaultError:
            failed = True
        delta = timeline.total - before
        ok = (not failed and timeline.retry == retry0
              and len(system.fault_log) == nlog0)
        return {"ranks": list(ranks), "delta": delta, "ok": ok,
                "failed": failed}

    def _commit_step(self, run: _Run, t: float, step: JobStep, label: str,
                     delta: float, credit: float, clean: bool,
                     hedge: Optional[dict]):
        """Shared live/replay step accounting: charge ranks, resolve the
        hedge race (first completion wins; the loser occupies its ranks
        until the winner's completion event — cancel-priced exactly like
        preemption — never longer than its own duration), feed the
        circuit breakers, credit ideal progress, and schedule the
        completion event."""
        primary = tuple(run.ranks or ())
        if hedge is None:
            eff = delta
            run.spent += delta
            self._charge(primary, delta)
        else:
            run.hedges += 1
            ranks_h = tuple(hedge["ranks"])
            delta_h = hedge["delta"]
            win = (not hedge["failed"]) and delta_h < delta
            eff = delta_h if win else delta
            hedge_busy = min(delta_h, eff)
            run.spent += eff + hedge_busy
            self._charge(primary, eff)
            self._charge(ranks_h, hedge_busy)
            for r in ranks_h:
                self._owner[r] = run
        self._breaker_record(primary, clean, t + eff)
        if hedge is not None:
            self._breaker_record(ranks_h, hedge["ok"], t + eff)
            if win:
                run.hedge_wins += 1
                # the job lives where the winning copy ran: later steps
                # use the hedge ranks' staged data, the old ranks free
                # at this completion event
                run.pending_release.extend(primary)
                run.ranks = ranks_h
                run.lanes = [d for r in ranks_h
                             for d in self._rank_lanes(r)]
            else:
                run.pending_release.extend(ranks_h)
            self._instant("job:hedge", t, jid=run.spec.jid,
                          tenant=run.spec.tenant, step=run.next_step,
                          won=win, ranks=list(ranks_h))
        run.ideal_acc += credit
        if self.tracer is not None and eff > 0.0:
            # rank-occupancy slices on the cluster event clock: every
            # rank the job holds shows this step busy for its duration
            self.tracer.span(
                f"{label}:{step.label or step.phase}", t, t + eff,
                tuple(f"rank{r}" for r in (run.ranks or ())),
                pid=PID_CLUSTER, phase=step.phase,
                args={"tenant": run.spec.tenant, "jid": run.spec.jid,
                      "clean": clean})
        self._push(t + eff, "step", run.spec.jid)

    # ---- journal / replay --------------------------------------------------
    def _replay_active(self) -> bool:
        return self._replay is not None and self._rpos < len(self._replay)

    def _replay_take(self, types: Tuple[str, ...]) -> dict:
        rec = self._replay[self._rpos]
        if rec["type"] not in types:
            raise RuntimeError(
                f"journal divergence: expected one of {types} at record "
                f"{self._rpos}, found {rec['type']!r}")
        self._rpos += 1
        return rec

    def _journal_step(self, rec: dict):
        if self._journal is None or self._replay_active():
            return
        self._journal.write(rec)
        self._steps_written += 1
        if (self.crash_after is not None
                and self._steps_written >= self.crash_after):
            raise SimulatedCrash(
                f"simulated crash after {self._steps_written} journaled "
                "step outcomes (the record is durable; in-memory state "
                "is lost)")

    def _apply_record(self, run: _Run, t: float, step: JobStep,
                      label: str, rec: dict):
        if rec["jid"] != run.spec.jid or rec["idx"] != run.next_step:
            raise RuntimeError(
                f"journal divergence: journal has {rec['type']} for job "
                f"{rec['jid']} step {rec['idx']}, replay reached job "
                f"{run.spec.jid} step {run.next_step} — the resumed "
                "run was given a different job stream or knobs")
        self._ff_faults(rec["li"], rec["xi"])
        if "tl" in rec:
            self._tl_restore(rec["tl"])
        if rec["type"] == "fault":
            delta = rec["delta"]
            run.spent += delta
            self._charge(run.ranks or (), delta)
            self._breaker_record(run.ranks or (), False, t + delta)
            self._fault(run, t + delta, DpuFaultError(FaultReport(
                kind=rec["kind"], label=label)))
            return
        self._commit_step(run, t, step, label, rec["delta"],
                          rec["credit"], rec["clean"], rec.get("hedge"))

    def _tl_snapshot(self) -> List[float]:
        """The system's timeline phase accumulators, in PHASES order —
        journaled absolutely so a resumed run's *live* steps compute
        ``timeline.total - before`` deltas from bit-identical
        accumulator state (replayed steps never re-charge the timeline;
        without the restore, the different absolute offsets round the
        post-resume deltas one ULP apart)."""
        tl = self.system.timeline
        return [tl.h2d, tl.kernel, tl.d2h, tl.inter_dpu, tl.retry,
                tl.shed]

    def _tl_restore(self, vals: Sequence[float]):
        tl = self.system.timeline
        (tl.h2d, tl.kernel, tl.d2h, tl.inter_dpu, tl.retry,
         tl.shed) = [float(v) for v in vals]

    def _ff_faults(self, li: int, xi: int):
        """Fast-forward the system's pure fault stream over replayed
        submissions: apply the permanent deaths every skipped launch
        would have sampled (the mask must match for post-resume live
        steps), then pin the counters."""
        system = self.system
        if system.faults is None:
            return
        for launch in range(system._launch_idx, li):
            dies = system.faults.permanent_faults(launch,
                                                  system.cfg.n_dpus)
            if dies.any():
                system.active_mask &= ~dies
        system._launch_idx = max(system._launch_idx, li)
        system._xfer_idx = max(system._xfer_idx, xi)

    # ---- overload hardening ------------------------------------------------
    def _breaker_record(self, ranks: Sequence[int], ok: bool, t: float):
        if self.breakers is None:
            return
        for r in ranks:
            verdict = self.breakers.record(r, ok, t)
            if verdict in ("tripped", "reopened"):
                self._instant(f"breaker:{verdict}", t, rank=r)
                # wake the admission loop when the cooldown expires —
                # otherwise a quarantine-stalled queue waits forever
                self._push(self.breakers.cooldown_until(r), "probe", -1)
            elif verdict == "restored":
                self._instant("breaker:restored", t, rank=r)

    def _admission_check(self, spec: JobSpec, t: float) -> str:
        """Admission verdict for one arrival: empty string admits,
        otherwise the rejection reason."""
        pol = self.admission
        if pol is None:
            return ""
        if pol.max_queue is not None and len(self._queue) >= pol.max_queue:
            return "queue_full"
        bucket = self._buckets.get(spec.tenant)
        if bucket is not None and not bucket.try_take(t):
            return "rate_limited"
        return ""

    def _est_remaining(self, run: _Run) -> float:
        """Optimistic (fault-free, no-queueing, full-health) seconds to
        finish the job's remaining steps — the lower bound deadline
        shedding compares against the SLO budget: when even this bound
        misses the deadline, the job is provably dead."""
        if run.est_suffix is None:
            run.est_suffix = self._estimate_suffix(run)
        return run.est_suffix[min(run.next_step, len(run.steps))]

    def _estimate_suffix(self, run: _Run) -> List[float]:
        spec = run.spec
        ranks = tuple(range(min(spec.n_ranks, self.topology.n_ranks)))
        lanes = [d for r in ranks for d in self._rank_lanes(r)]
        costs = []
        for s in run.steps:
            if s.phase == "tick":
                costs.append(self.lm_tick_seconds)
            elif s.phase in ("h2d", "d2h"):
                vec = np.zeros(self.topology.n_dpus)
                vec[lanes] = s.bytes_per_dpu
                costs.append(self.topology.schedule(vec, s.phase).seconds)
            else:
                costs.append(s.seconds)
        suffix = [0.0] * (len(costs) + 1)
        for i in range(len(costs) - 1, -1, -1):
            suffix[i] = suffix[i + 1] + costs[i]
        return suffix

    def _shed(self, run: _Run, t: float, where: str):
        self._instant("job:shed", t, jid=run.spec.jid,
                      tenant=run.spec.tenant, where=where)
        self._finalize(run, t, SHED, reason="deadline")

    def _doomed(self, run: _Run, t: float) -> bool:
        slo = run.spec.slo_seconds
        return (np.isfinite(slo)
                and t + self._est_remaining(run)
                > run.spec.arrival + slo)

    def backpressure(self) -> Dict[str, object]:
        """Live admission snapshot for load-shaping callers: queue depth
        vs bound, currently-quarantined ranks, per-tenant token levels
        (refilled to the current clock)."""
        for b in self._buckets.values():
            b._refill(self.clock)
        return {
            "queue_depth": len(self._queue),
            "max_queue": (self.admission.max_queue
                          if self.admission is not None else None),
            "quarantined": (self.breakers.quarantined_ranks(self.clock)
                            if self.breakers is not None else []),
            "tokens": {tn: b.tokens
                       for tn, b in sorted(self._buckets.items())},
        }

    def _fault(self, run: _Run, t: float, err: DpuFaultError):
        """A step could not be served (dead ranks, tripped pool floor,
        exhausted retries).  fault_aware reschedules the replica —
        ``lm_decode`` resumes its remaining ticks on fresh ranks, the
        PrIM kinds restart (their staged data died with the ranks) —
        everyone else fails the job and eats the wasted work."""
        self.clock = max(self.clock, t)
        self._instant("job:fault", t, jid=run.spec.jid,
                      tenant=run.spec.tenant, kind=err.report.kind)
        self._release(run)
        self._refresh_health()
        if (self.policy == "fault_aware"
                and run.reschedules < self.max_reschedules):
            run.reschedules += 1
            if run.spec.kind != "lm_decode":
                run.next_step = 0
                run.ideal_acc = 0.0
            run.state = _QUEUED
            self._queue.append(run)
        else:
            self._finalize(run, t, FAILED, reason=err.report.kind)
        self._try_admit(t)

    def _step_done(self, run: _Run, t: float):
        if run.pending_release:
            # hedge losers cancel at this completion event: free every
            # pending rank the job is not still running on
            freed = [r for r in run.pending_release
                     if r not in (run.ranks or ())]
            run.pending_release = []
            for r in freed:
                if self._owner.get(r) is run:
                    del self._owner[r]
            if freed:
                self._try_admit(t)
        run.next_step += 1
        if run.next_step >= len(run.steps):
            self._finalize(run, t, COMPLETED)
            self._try_admit(t)
            return
        if self.shedding and self._doomed(run, t):
            # mid-run shed: even a fault-free remainder misses the SLO —
            # stop burning rank-seconds on a provably dead deadline
            self._shed(run, t, where="running")
            self._try_admit(t)
            return
        if run.preempt_flag:
            # kernel-launch-boundary preemption: yield the ranks to the
            # armed higher-priority job and requeue with progress kept
            run.preempt_flag = False
            run.preemptions += 1
            self._instant("job:preempted", t, jid=run.spec.jid,
                          tenant=run.spec.tenant,
                          ranks=list(run.ranks or ()))
            self._release(run)
            run.state = _QUEUED
            self._queue.append(run)
            self._try_admit(t)
            return
        self._start_step(run, t)

    # ---- admission ---------------------------------------------------------
    def _try_admit(self, t: float):
        self._refresh_health()
        if self.shedding:
            # queue shedding: drop waiting jobs whose deadline is
            # already provably lost before they consume any capacity
            for run in list(self._queue):
                if self._doomed(run, t):
                    self._queue.remove(run)
                    self._shed(run, t, where="queue")
        # strict priority, FIFO within a class, backfill past stuck heads
        self._queue.sort(key=lambda r: (-r.spec.priority, r.spec.arrival,
                                        r.spec.jid))
        admitted = True
        while admitted:
            admitted = False
            for run in list(self._queue):
                if run.spec.n_ranks > self._capacity():
                    self._queue.remove(run)
                    self._finalize(run, t, FAILED, reason="unplaceable")
                    admitted = True
                    break
                ranks = self._place(run.spec.n_ranks, t=t)
                if ranks is not None:
                    self._queue.remove(run)
                    self._admit(run, t, ranks)
                    admitted = True
                    break
        if self.preemption and self._queue:
            head = self._queue[0]
            victims = [r for r in self._runs.values()
                       if r.state == _RUNNING and not r.preempt_flag
                       and r.spec.priority < head.spec.priority]
            # lowest-priority, youngest victim whose ranks would make
            # the head job placeable (exact dry-run, so preemption is
            # never armed in vain)
            for v in sorted(victims, key=lambda r: (r.spec.priority,
                                                    -r.spec.jid)):
                if self._place(head.spec.n_ranks, extra=v.ranks or (),
                               t=t):
                    v.preempt_flag = True
                    break

    # ---- run ---------------------------------------------------------------
    def run(self, jobs: Sequence[JobSpec]) -> ClusterReport:
        """Simulate the whole stream; one call per cluster instance."""
        if self._ran:
            raise RuntimeError("PimCluster.run is single-shot: build a "
                               "fresh cluster (and system) per run")
        self._ran = True
        ordered = sorted(jobs, key=lambda s: (s.arrival, s.jid))
        if self._replay_active():
            rec = self._replay_take(("run",))
            if rec["n_jobs"] != len(ordered):
                raise RuntimeError(
                    f"journal divergence: journaled run had "
                    f"{rec['n_jobs']} jobs, resume was given "
                    f"{len(ordered)}")
        elif self._journal is not None:
            self._journal.write({"type": "run", "n_jobs": len(ordered)})
        for spec in ordered:
            run = _Run(spec, self._plan(spec))
            self._runs[spec.jid] = run
            self._push(spec.arrival, "arrive", spec.jid)
        while self._events:
            t, _, tag, jid = heapq.heappop(self._events)
            if tag == "probe":
                # breaker cooldown expired: retry admission without
                # advancing the clock (an idle probe must not stretch
                # the makespan; any admitted work advances it itself)
                self._try_admit(t)
                continue
            self.clock = max(self.clock, t)
            run = self._runs[jid]
            if tag == "arrive":
                reason = self._admission_check(run.spec, t)
                if reason:
                    self._instant("job:rejected", t, jid=jid,
                                  tenant=run.spec.tenant, reason=reason)
                    self._finalize(run, t, REJECTED, reason=reason)
                    continue
                self._queue.append(run)
                self._try_admit(t)
            elif run.state == _RUNNING:
                self._step_done(run, t)
        # capacity died under the queue: nothing running, no events left
        for run in list(self._queue):
            self._queue.remove(run)
            self._finalize(run, self.clock, FAILED, reason="no_capacity")
        self.report.makespan = self.clock
        self.report.outcomes.sort(key=lambda o: o.jid)
        return self.report

    # ---- serving leases ----------------------------------------------------
    def lease(self, tenant: str, n_ranks: int = 1, *,
              tick_seconds: Optional[float] = None,
              min_fraction: Optional[float] = None) -> ClusterLease:
        """Admit an open-ended serving tenant NOW: place ``n_ranks``
        under the policy and return a lease whose ``pool`` is a
        :class:`PimDecodePool` bound to those ranks.  Raises
        :class:`DpuFaultError` (kind ``no_capacity``) when placement
        fails — serving replicas are not queued."""
        from repro_torch.serve.pim_pool import PimDecodePool
        if (self._replay_active()
                and self._replay[self._rpos]["type"] == "lease"):
            rec = self._replay_take(("lease",))
            if rec["tenant"] != tenant or rec["n_ranks"] != n_ranks:
                raise RuntimeError(
                    f"journal divergence: journaled lease was "
                    f"({rec['tenant']!r}, {rec['n_ranks']}), resume "
                    f"asked for ({tenant!r}, {n_ranks})")
            ranks = tuple(rec["ranks"])
        else:
            self._refresh_health()
            ranks = self._place(n_ranks)
            if ranks is None:
                raise DpuFaultError(FaultReport(
                    kind="no_capacity", label=tenant,
                    detail=f"no {n_ranks}-rank placement available "
                           f"(policy={self.policy})"))
            if self._journal is not None:
                self._journal.write({"type": "lease", "tenant": tenant,
                                     "n_ranks": n_ranks,
                                     "ranks": list(ranks)})
        lease = ClusterLease(tenant=tenant, ranks=ranks)
        lease.pool = PimDecodePool(
            self.system,
            tick_seconds=(tick_seconds if tick_seconds is not None
                          else self.lm_tick_seconds),
            min_fraction=(min_fraction if min_fraction is not None
                          else self.lm_min_fraction),
            ranks=list(ranks))
        for r in ranks:
            self._owner[r] = lease
        self.report.admissions.append((f"lease:{tenant}", self.clock, ranks))
        self._instant("lease:placed", self.clock, tenant=tenant,
                      ranks=list(ranks))
        return lease

    def release(self, lease: ClusterLease):
        """Give a lease's ranks back (idempotent: releasing twice, or a
        lease outliving a resumed run, is a no-op for ranks already
        owned by someone else)."""
        if (self._replay_active()
                and self._replay[self._rpos]["type"] == "release"):
            self._replay_take(("release",))
        elif self._journal is not None and not self._replay_active():
            self._journal.write({"type": "release",
                                 "tenant": lease.tenant,
                                 "ranks": list(lease.ranks)})
        for r in lease.ranks:
            if self._owner.get(r) is lease:
                del self._owner[r]
        lease.active = False

    def relocate(self, lease: ClusterLease) -> ClusterLease:
        """Reschedule a serving replica whose pool tripped its floor:
        release the degraded ranks and lease fresh ones (fault_aware
        placement naturally lands on healthy ranks)."""
        tick = lease.pool.tick_seconds if lease.pool is not None else None
        frac = lease.pool.min_fraction if lease.pool is not None else None
        self.release(lease)
        return self.lease(lease.tenant, len(lease.ranks),
                          tick_seconds=tick, min_fraction=frac)
