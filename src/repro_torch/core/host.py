"""Host-side runtime: the analogue of UPMEM's host API
(``dpu_alloc`` / ``dpu_load`` / ``dpu_push_xfer`` / ``dpu_launch``).

All host<->DPU transfers are scheduled through the ``repro_torch.comm``
interconnect model (channels x ranks x DPUs): parallel across DPUs
within a rank, serialized between ranks sharing a channel, overlapped
across channels, asymmetric AVX write/read paths (Table I) — the
behaviour behind Fig. 10's strong-scaling communication bars.
Inter-DPU communication goes through the system's fabric backend:
host-bounce (paper §II-B) or a hypothetical direct PIM-PIM fabric
(pathfinding case study).

Every phase is routed through the ``repro_torch.sched`` command-queue runtime:
data moves eagerly (payloads and kernels execute at submit time, in
program order), while the modeled seconds are recorded as typed commands
on the current stream.  ``mode="inorder"`` (default) chains everything
on one queue — the fully synchronous PR 2 behaviour, bit-exact.
``mode="async"`` honors :meth:`PIMSystem.stream` contexts so the list
scheduler can overlap transfers with kernels; resolve with
:meth:`PIMSystem.sync`, which stamps ``timeline.elapsed``.

The simulated DPUs run on a torch device: ``PIMSystem(cfg, device=None)``
means the CUDA card and raises when there is none; ``device="cpu"`` asks
for the CPU explicitly.  The device is passed down to every
:mod:`repro_torch.core.compile_cache` launch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.fabric import Fabric, make_fabric
from repro_torch.comm.topology import RankTopology, TransferEvent
from repro_torch.core import backend as backends
from repro_torch.core import engine, stats
from repro_torch.core.asm import ARG_BYTES, CACHE_DATA_BASE, Program
from repro_torch.core.config import DPUConfig
from repro_torch.core.isa import Binary
from repro_torch.faults.model import DpuFaultError, FaultPlan, FaultReport
from repro_torch.faults.retry import DEFAULT_POLICY, RetryPolicy
from repro_torch.obs import get_default_tracer
from repro_torch.obs.tracer import PID_HOST, Tracer
from repro_torch.sched import queue as sq
from repro_torch.sched import scheduler as ssched

PHASES = ("h2d", "kernel", "d2h", "inter_dpu", "retry", "shed")


def _xfer_spec(direction: str, bytes_per_dpu) -> Dict:
    """Recorder metadata for one host transfer: the per-DPU byte request
    (scalar or vector) a replay feeds back through a — possibly different
    — ``RankTopology.schedule`` to re-price it."""
    if np.ndim(bytes_per_dpu) == 0:
        spec = float(bytes_per_dpu)
    else:
        spec = [float(b) for b in np.asarray(bytes_per_dpu).ravel()]
    return {"price": "xfer", "dir": direction, "bytes": spec}


@dataclass
class Timeline:
    """Accumulated end-to-end execution phases (seconds).

    The per-phase fields and ``total`` are *busy* sums — the serialized
    reference, independent of any overlap.  ``elapsed`` is the overlapped
    makespan stamped by :meth:`PIMSystem.sync` (``None`` until then);
    ``end_to_end`` is the modeled wall time either way."""

    h2d: float = 0.0
    kernel: float = 0.0
    d2h: float = 0.0
    inter_dpu: float = 0.0  # inter-DPU exchanges between kernels
    retry: float = 0.0      # wasted attempts + backoff (fault recovery)
    shed: float = 0.0       # speculative duplicates (hedged launches)
    #: per-event attribution: (phase, label, seconds, bytes)
    events: List[Tuple[str, str, float, float]] = field(default_factory=list)
    #: overlapped makespan from the repro_torch.sched scheduler (None = not synced)
    elapsed: Optional[float] = None
    #: (phase, label) -> seconds, maintained by add() so by_label() is
    #: O(distinct labels) instead of rescanning every event per call
    _label_sums: Dict[Tuple[str, str], float] = field(
        default_factory=dict, repr=False)

    def add(self, phase: str, seconds: float, label: str = "",
            nbytes: float = 0.0):
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        setattr(self, phase, getattr(self, phase) + seconds)
        lbl = label or phase
        self.events.append((phase, lbl, seconds, nbytes))
        key = (phase, lbl)
        self._label_sums[key] = self._label_sums.get(key, 0.0) + seconds

    @property
    def total(self) -> float:
        return (self.h2d + self.kernel + self.d2h + self.inter_dpu
                + self.retry + self.shed)

    @property
    def goodput(self) -> float:
        """Useful fraction of the serialized busy time: 1 − (retry +
        shed)/total (1.0 when nothing was wasted, or nothing ran) —
        hedged duplicates are speculation overhead, like retries."""
        return 1.0 if self.total <= 0.0 \
            else 1.0 - (self.retry + self.shed) / self.total

    @property
    def end_to_end(self) -> float:
        """Overlapped makespan when scheduled, serialized sum otherwise."""
        return self.total if self.elapsed is None else self.elapsed

    @property
    def overlap_saved(self) -> float:
        """Seconds the async schedule hid under other phases."""
        return 0.0 if self.elapsed is None else max(
            0.0, self.total - self.elapsed)

    def breakdown(self) -> Dict[str, float]:
        t = max(self.total, 1e-30)
        return {"kernel": self.kernel / t, "h2d": self.h2d / t,
                "d2h": self.d2h / t, "inter_dpu": self.inter_dpu / t,
                "retry": self.retry / t, "shed": self.shed / t}

    def by_label(self, phase: Optional[str] = None) -> Dict[str, float]:
        """Seconds per event label within one phase (e.g. per-collective),
        or — with ``phase=None`` — aggregated across *all* phases (a
        label charged in several phases sums once per label).  Served
        from the ``add()``-time index, not an event rescan."""
        out: Dict[str, float] = {}
        for (ph, label), sec in self._label_sums.items():
            if phase is None or ph == phase:
                out[label] = out.get(label, 0.0) + sec
        return out


class PIMSystem:
    """Channels x ranks x DPUs + the host runtime.

    ``faults`` installs a :class:`~repro_torch.faults.model.FaultPlan`; without
    one every fault-handling branch is skipped and timelines/results are
    bit-exact with pre-fault builds (pay-for-what-you-use).  ``retry``
    sets the :class:`~repro_torch.faults.retry.RetryPolicy` for transient
    kernel faults and link timeouts (default: 3 attempts, exponential
    backoff).  ``recovery`` is the launch-failure policy workloads
    consult: ``"remap"`` re-executes lost shards on survivors,
    ``"raise"`` is fail-stop.  ``ckpt_dir`` enables checkpointed
    re-execution (``repro_torch.ckpt.store``) of remapped shards.

    ``tracer`` installs a :class:`repro_torch.obs.Tracer`: :meth:`sync` feeds
    it the overlapped schedule's spans, and fault/retry occurrences are
    emitted as instant events on the eager clock.  The default (None,
    unless a process-wide tracer was installed via
    ``repro_torch.obs.set_default_tracer``) is zero-cost: every emission site
    is guarded, and an enabled tracer never feeds back into the
    simulation — timelines and results stay bit-exact either way."""

    def __init__(self, cfg: DPUConfig, fabric: Optional[Fabric] = None,
                 mode: str = "inorder", faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 recovery: str = "remap", ckpt_dir: Optional[str] = None,
                 tracer: Optional[Tracer] = None, device=None):
        from repro_torch.core import compile_cache
        if recovery not in ("remap", "raise"):
            raise ValueError(f"unknown recovery policy {recovery!r} "
                             "(want remap|raise)")
        self.cfg = cfg
        #: torch device the engine runs on (None = the CUDA card)
        self.device = compile_cache.resolve_device(device)
        #: optional repro_torch.trace.TraceRecorder (attach via trace.record());
        #: None = zero-cost, every emission site is guarded
        self.recorder = None
        self.tracer = tracer if tracer is not None else get_default_tracer()
        if self.tracer is not None:
            self.tracer.attach_system(self)
        self.topology = RankTopology.from_config(cfg)
        self.fabric = fabric or make_fabric(cfg, self.topology)
        self.timeline = Timeline()
        self.reports = []
        self.runtime = sq.QueueRuntime(mode)
        self.last_schedule: Optional[ssched.Schedule] = None
        # ---- fault state (inert when faults is None) ----
        self.faults = faults
        self.retry = retry or (DEFAULT_POLICY if faults is not None else None)
        self.recovery = recovery
        self.ckpt_dir = ckpt_dir
        self.active_mask = np.ones(cfg.n_dpus, bool)
        self.fault_log: List[FaultReport] = []
        self.last_launch_faults: Optional[Dict] = None
        self._launch_idx = 0     # kernel launches seen (FaultPlan key)
        self._xfer_idx = 0       # host transfers seen (FaultPlan key)

    # ---- fault state ---------------------------------------------------------
    @property
    def active_dpus(self) -> List[int]:
        """Sorted ids of currently healthy DPUs."""
        return [int(d) for d in np.flatnonzero(self.active_mask)]

    def _log_fault(self, report: FaultReport):
        """Record one fault occurrence: append to ``fault_log`` and —
        with a tracer installed — emit an instant event stamped on the
        eager serialized clock (``timeline.total``)."""
        self.fault_log.append(report)
        if self.tracer is not None:
            self.tracer.instant(
                f"fault:{report.kind}", self.timeline.total,
                track="faults", pid=PID_HOST,
                args={"label": report.label, "launch": report.launch,
                      "attempt": report.attempt,
                      "dpus": list(report.dpus), "detail": report.detail})

    def disable_dpus(self, dpus: Sequence[int], label: str = "manual"):
        """Administratively mark DPUs dead (fused-off lanes, tests)."""
        dead = sorted({int(d) for d in dpus})
        self.topology.ranks_of(dead)  # validates the range
        self.active_mask[dead] = False
        self._log_fault(FaultReport(
            kind="permanent", label=label, dpus=tuple(dead),
            detail="disabled by host"))

    def _advance_permanents(self, label: str, launch_idx: int) -> np.ndarray:
        """Sample permanent deaths at this launch; returns the bool mask
        of lanes that died *now* (previously-dead lanes excluded)."""
        dies = self.faults.permanent_faults(launch_idx, self.cfg.n_dpus)
        newly = dies & self.active_mask
        if newly.any():
            self.active_mask &= ~dies
            self._log_fault(FaultReport(
                kind="permanent", label=label, launch=launch_idx,
                dpus=tuple(int(d) for d in np.flatnonzero(newly))))
        return newly

    # ---- command-queue plumbing ---------------------------------------------
    def _submit(self, kind: str, phase: str, label: str, seconds: float,
                nbytes: float, resources: Dict[str, float],
                attempt: int = 0, meta: Optional[Dict] = None
                ) -> "sq.Command":
        """Charge the timeline (eager, serialized-order sums) and queue the
        command for the overlapped schedule.  ``meta`` is the re-pricing
        spec a :class:`repro_torch.trace.TraceRecorder` stores with the command
        (how its seconds were derived) — never read by the simulation.
        ``phase="shed"`` submissions (hedged duplicates) are marked fully
        wasted: exactly one of the two copies is redundant by
        construction, and the duplicate is the designated one, so
        :meth:`Schedule.wasted` prices speculation like retries."""
        self._invalidate_schedule()
        self.timeline.add(phase, seconds, label, nbytes)
        cmd = self.runtime.submit(kind, label or phase, seconds,
                                  phase=phase, nbytes=nbytes,
                                  resources=resources, attempt=attempt,
                                  wasted=seconds if phase == "shed" else 0.0)
        if self.recorder is not None:
            self.recorder.on_command(cmd, meta)
        return cmd

    def _charge_retry(self, kind: str, label: str, seconds: float,
                      resources: Dict[str, float], attempt: int,
                      nbytes: float = 0.0) -> "sq.Command":
        """Queue a fully-wasted command (failed attempt or backoff hold)
        on the current stream: it occupies real time and resources but
        lands in the timeline's ``retry`` phase and counts against
        goodput."""
        self._invalidate_schedule()
        self.timeline.add("retry", seconds, label, nbytes)
        cmd = self.runtime.submit(kind, label, seconds, phase="retry",
                                  nbytes=nbytes, resources=resources,
                                  wasted=seconds, attempt=attempt)
        if self.recorder is not None:
            self.recorder.on_command(cmd, None)
        return cmd

    def _invalidate_schedule(self):
        # a schedule resolved by sync() no longer covers newly submitted
        # work; drop it so end_to_end falls back to the serialized sum
        # until the next sync() instead of silently under-reporting
        self.timeline.elapsed = None
        self.last_schedule = None

    def _chan_resources(self, ev: TransferEvent) -> Dict[str, float]:
        # per-rank link shares: a transfer holds `chan<c>:rank<r>` for
        # every rank it touches, for that channel's busy time — so two
        # transfers on the same rank serialize exactly like PR 3 while
        # disjoint rank sets overlap (optionally stretched by the
        # scheduler's contention factor)
        topo = self.topology
        return {f"chan{topo.channel_of_rank(r)}:rank{r}": busy
                for r, busy in enumerate(ev.rank_busy) if busy > 0.0}

    def _ranks_or_all(self, ranks: Optional[Sequence[int]]):
        if ranks is None:
            return range(self.topology.n_ranks)
        ranks = sorted({int(r) for r in ranks})
        if not ranks or ranks[0] < 0 or ranks[-1] >= self.topology.n_ranks:
            raise ValueError(f"ranks {ranks} outside "
                             f"[0, {self.topology.n_ranks})")
        return ranks

    def _fabric_resources(self, seconds: float,
                          ranks: Optional[Sequence[int]] = None
                          ) -> Dict[str, float]:
        ranks = self._ranks_or_all(ranks)
        if self.fabric.name in ("direct", "hier"):
            return {f"fabric:rank{r}": seconds for r in ranks}
        # host bounce drives the AVX copy loops over the involved ranks'
        # channel shares
        topo = self.topology
        return {f"chan{topo.channel_of_rank(r)}:rank{r}": seconds
                for r in ranks}

    def stream(self, name: str):
        """Submission context: with ``mode="async"`` commands issued inside
        land on queue ``name`` (in-order mode keeps the single chain)."""
        return self.runtime.stream(name)

    def record_event(self, label: str = "") -> "sq.Event":
        """Completion marker for everything submitted so far on the
        current stream."""
        self._invalidate_schedule()
        ev = self.runtime.record_event(label)
        if self.recorder is not None:
            self.recorder.on_event_record(ev)
        return ev

    def wait_event(self, ev: "sq.Event") -> "sq.Command":
        """Block the current stream until ``ev``'s recorder finishes."""
        self._invalidate_schedule()
        cmd = self.runtime.wait_event(ev)
        if self.recorder is not None:
            self.recorder.on_command(cmd, None)
        return cmd

    def sync(self) -> "ssched.Schedule":
        """Resolve all queued commands into the overlapped schedule and
        stamp ``timeline.elapsed`` with its makespan.  The configured
        ``channel_contention`` prices concurrent operations sharing a
        physical channel (or the fabric) on disjoint rank shares."""
        sched = ssched.schedule(self.runtime.queues,
                                contention=self.cfg.channel_contention)
        self.timeline.elapsed = sched.makespan
        self.last_schedule = sched
        if self.recorder is not None:
            self.recorder.on_sync()
        if self.tracer is not None:
            # re-ingest under this system's key: sync() re-resolves the
            # whole submission history, so replacement keeps the trace
            # covering every command exactly once
            self.tracer.ingest_schedule(sched, key=id(self),
                                        pid=self.tracer.pid_of(self))
        return sched

    # ---- transfer accounting -------------------------------------------------
    def h2d(self, bytes_per_dpu, label: str = "h2d",
            phase: str = "h2d") -> "sq.Command":
        """Host write; scalar or (D,) per-DPU byte vector.  ``phase``
        overrides the timeline bucket (``"shed"`` for a hedged
        duplicate); the transfer is priced and fault-streamed the same
        either way."""
        ev = self.topology.schedule(bytes_per_dpu, "h2d")
        return self._transfer(sq.H2D, phase, label, ev,
                              spec=_xfer_spec("h2d", bytes_per_dpu))

    def d2h(self, bytes_per_dpu, label: str = "d2h",
            phase: str = "d2h") -> "sq.Command":
        """Host read; scalar or (D,) per-DPU byte vector (``phase`` as
        in :meth:`h2d`)."""
        ev = self.topology.schedule(bytes_per_dpu, "d2h")
        return self._transfer(sq.D2H, phase, label, ev,
                              spec=_xfer_spec("d2h", bytes_per_dpu))

    def _transfer(self, kind: str, phase: str, label: str,
                  ev: TransferEvent,
                  spec: Optional[Dict] = None) -> "sq.Command":
        """Submit one host transfer, retrying link timeouts and pricing
        link degradation when a fault plan is installed.  ``spec`` is the
        recorder's re-pricing metadata; fault-degraded attempts drop it
        (their seconds carry a sampled factor a replay cannot re-derive,
        so they replay as recorded)."""
        res = self._chan_resources(ev)
        if self.faults is None:
            return self._submit(kind, phase, label, ev.seconds,
                                ev.total_bytes, res, meta=spec)
        xfer = self._xfer_idx
        self._xfer_idx += 1
        policy = self.retry or DEFAULT_POLICY
        for attempt in range(policy.max_attempts):
            out = self.faults.link_outcome(xfer, attempt)
            secs = ev.seconds * out.factor
            timed_out = out.timeout or (policy.timeout_seconds is not None
                                        and secs > policy.timeout_seconds)
            if not timed_out:
                if out.factor > 1.0:
                    self._log_fault(FaultReport(
                        kind="link", label=label, launch=xfer,
                        attempt=attempt,
                        detail=f"degraded x{out.factor:g}"))
                scaled = {r: b * out.factor for r, b in res.items()}
                return self._submit(kind, phase, label, secs,
                                    ev.total_bytes, scaled, attempt=attempt)
            # hung attempt: the host notices at the timeout (or, with no
            # timeout configured, after the full degraded duration)
            waste = secs if policy.timeout_seconds is None \
                else min(secs, policy.timeout_seconds)
            self._log_fault(FaultReport(
                kind="link", label=label, launch=xfer, attempt=attempt,
                detail="timeout", wasted_seconds=waste))
            self._charge_retry(kind, label,
                               waste, {r: min(b * out.factor, waste)
                                       for r, b in res.items()},
                               attempt, nbytes=ev.total_bytes)
            backoff = policy.backoff_after(attempt)
            if backoff > 0.0:
                self._charge_retry(kind, f"{label}:backoff", backoff, {},
                                   attempt)
        raise DpuFaultError(FaultReport(
            kind="retry_exhausted", label=label, launch=xfer,
            attempt=policy.max_attempts,
            detail=f"transfer timed out on all {policy.max_attempts} "
                   "attempts"))

    def collective(self, kind: str, seconds: float, nbytes: float,
                   ranks: Optional[Sequence[int]] = None,
                   price: Optional[Dict] = None) -> "sq.Command":
        """Charge one inter-DPU collective exchange (called by
        ``repro_torch.comm.collectives`` after it moved the payload).
        ``ranks`` restricts the held link/fabric shares to the
        participating ranks (default: all), letting collectives on
        disjoint rank sets overlap in an async schedule.  ``price`` is
        the fabric-call spec (method name + args + DPU subset) a trace
        replay uses to re-price this exchange under another fabric."""
        meta = dict(price, price="collective") if price else None
        return self._submit(sq.COLLECTIVE, "inter_dpu", kind, seconds, nbytes,
                            self._fabric_resources(seconds, ranks),
                            meta=meta)

    def inter_dpu(self, bytes_per_dpu: float):
        """Legacy host bounce: ``bytes_per_dpu`` is the worst-case per-DPU
        payload, scheduled on every DPU (so time scales with ranks per
        channel). Prefer the ``repro_torch.comm`` collectives, which account
        exact per-DPU vectors."""
        self.collective("bounce", self.fabric.bounce(bytes_per_dpu),
                        bytes_per_dpu,
                        price={"method": "bounce",
                               "args": [float(bytes_per_dpu)],
                               "dpus": None})

    def _charge_kernel(self, name: str, seconds: float,
                       ranks: Optional[Sequence[int]] = None,
                       phase: str = "kernel") -> "sq.Command":
        """Charge one successful kernel: hold the involved ranks' compute
        slots (no fault handling — the caller already resolved that)."""
        meta = {"price": "kernel", "freq_mhz": self.cfg.freq_mhz,
                "ranks": None if ranks is None
                else [int(r) for r in self._ranks_or_all(ranks)]}
        return self._submit(
            sq.LAUNCH, phase, name, seconds, 0.0,
            {f"rank{r}": seconds for r in self._ranks_or_all(ranks)},
            meta=meta)

    def modeled_launch(self, name: str, seconds: float,
                       ranks: Optional[Sequence[int]] = None,
                       phase: str = "kernel") -> "sq.Command":
        """Charge a kernel of known duration without running the engine —
        for what-if schedule studies and tests.  Holds the compute slots
        of ``ranks`` (default: every rank), exactly like a real
        :meth:`launch` of the corresponding DPU subset.

        With a fault plan installed the modeled kernel participates in
        the fault stream: permanent deaths advance at each launch, a
        launch whose ranks hold no live DPU raises
        :class:`DpuFaultError`, and transient faults are retried under
        the system's policy with the wasted attempts priced into the
        ``retry`` phase.  ``phase="shed"`` books a hedged duplicate:
        same pricing, same fault stream, but the charge lands in the
        timeline's speculation bucket."""
        if self.faults is None:
            return self._charge_kernel(name, seconds, ranks, phase=phase)
        launch_idx = self._launch_idx
        self._launch_idx += 1
        self._advance_permanents(name, launch_idx)
        rlist = list(self._ranks_or_all(ranks))
        lanes = [d for r in rlist
                 for d in range(*self.topology.dpu_slice(r).indices(
                     self.cfg.n_dpus))]
        alive = [d for d in lanes if self.active_mask[d]]
        if not alive:
            raise DpuFaultError(FaultReport(
                kind="no_active_dpus", label=name, launch=launch_idx,
                dpus=tuple(lanes), detail="no live DPU on the launch ranks"))
        policy = self.retry or DEFAULT_POLICY
        rank_res = {f"rank{r}": seconds for r in rlist}
        for attempt in range(policy.max_attempts):
            t_mask = self.faults.transient_faults(launch_idx, attempt,
                                                  self.cfg.n_dpus)
            faulted = [d for d in alive if t_mask[d]]
            if not faulted:
                return self._submit(sq.LAUNCH, phase, name, seconds, 0.0,
                                    rank_res, attempt=attempt)
            self._log_fault(FaultReport(
                kind="transient", label=name, launch=launch_idx,
                attempt=attempt, dpus=tuple(faulted),
                wasted_seconds=seconds))
            self._charge_retry(sq.LAUNCH, name, seconds, rank_res, attempt)
            backoff = policy.backoff_after(attempt)
            if backoff > 0.0:
                self._charge_retry(sq.LAUNCH, f"{name}:backoff", backoff,
                                   {}, attempt)
        raise DpuFaultError(FaultReport(
            kind="retry_exhausted", label=name, launch=launch_idx,
            attempt=policy.max_attempts,
            detail=f"kernel faulted on all {policy.max_attempts} attempts"))

    # ---- kernel launch ---------------------------------------------------------
    def prewarm(self, binary: Binary, n_threads: Optional[int] = None,
                mram_words: Optional[int] = None,
                dpus: Optional[Sequence[int]] = None):
        """Compile the engine executable a later :meth:`launch` will use
        (cold XLA compile off the measured path).  With ``dpus`` the
        subset's DPU bucket is warmed instead — any other subset size in
        the same power-of-two bucket shares the executable.  Returns the
        compile-cache key."""
        from repro_torch.core import compile_cache
        cfg = self.cfg
        if dpus is not None:
            cfg = cfg.replace(n_dpus=len({int(d) for d in dpus}))
        return compile_cache.prewarm(cfg, binary, mram_words=mram_words,
                                     n_threads=n_threads, device=self.device)

    def launch(self, name: str, binary: Binary, args: np.ndarray,
               mram: np.ndarray, n_threads: Optional[int] = None,
               wram_extra: Optional[np.ndarray] = None,
               dpus: Optional[Sequence[int]] = None,
               degraded: bool = False, ndpus_reg: Optional[int] = None):
        """Run one kernel on all DPUs (or on the ``dpus`` subset).

        args: (D, n_args) int32 scalars (host-written WRAM arg area).
        mram: (D, mram_words) int32 per-DPU bank images.
        Returns (final_state, KernelReport).

        With ``dpus`` the kernel runs on that subset only and holds only
        the involved ranks' compute slots, so another rank can stage or
        compute concurrently in an async schedule.  ``args``/``mram``
        still carry all D rows; the subset is deduplicated and sliced
        out in **ascending DPU order** (row i of the returned state is
        the i-th smallest DPU id, regardless of the order passed), and
        the engine renumbers it 0..len(dpus)-1 (a kernel's
        ``DPU_ID``/``N_DPUS`` registers see the subset).
        ``ndpus_reg`` overrides what the ``N_DPUS`` register reports —
        remapped recovery launches keep the pre-fault logical width.

        Under a fault plan, a launch that targets dead DPUs (or loses
        lanes mid-kernel) raises :class:`DpuFaultError` unless
        ``degraded=True``, in which case it runs on the survivors only
        and the returned state carries the input image for dead rows
        (``last_launch_faults`` says which) — the contract is structured
        fault reports, never silently wrong data.

        Every launch goes through ``repro_torch.core.compile_cache``: the DPU
        axis is padded to a power-of-two bucket, so subsets of any size
        within one bucket (and relaunches of any same-shaped kernel)
        reuse a warm XLA executable instead of recompiling."""
        D = self.cfg.n_dpus
        T = n_threads or self.cfg.n_tasklets
        if args.shape[0] != D or mram.shape[0] != D:
            raise ValueError(
                f"{name}: args/mram must carry one row per DPU "
                f"(want {D}, got {args.shape[0]}/{mram.shape[0]}); subset "
                "launches select rows via dpus=, not by passing fewer rows")
        sel = None
        if dpus is not None:
            sel = sorted({int(d) for d in dpus})
            if not sel:
                raise ValueError("dpus subset must not be empty")
            self.topology.ranks_of(sel)  # validates the range
        if self.faults is None:
            st, rep, ranks = self._launch_engine(
                name, binary, args, mram, T, wram_extra, sel,
                ndpus_reg=ndpus_reg)
            self._charge_kernel(name, rep.kernel_seconds, ranks=ranks)
            self.reports.append(rep)
            return st, rep
        return self._launch_faulty(name, binary, args, mram, T, wram_extra,
                                   sel, degraded, ndpus_reg)

    def _launch_engine(self, name: str, binary: Binary, args, mram, T: int,
                       wram_extra, sel: Optional[List[int]],
                       ndpus_reg: Optional[int] = None):
        """Slice the (optional) subset, build the WRAM image, and run the
        engine; returns (state, report, ranks) without charging time."""
        cfg = self.cfg
        D = cfg.n_dpus
        ranks = None
        if sel is not None:
            ranks = self.topology.ranks_of(sel)
            args, mram = args[sel], mram[sel]
            if wram_extra is not None:
                wram_extra = wram_extra[sel]
            cfg = cfg.replace(n_dpus=len(sel))
            D = len(sel)
        wram = np.zeros((D, max(ARG_BYTES // 4, args.shape[1])), np.int32)
        wram[:, :args.shape[1]] = args
        if wram_extra is not None:
            # cache-centric relink: data sits above the static allocations
            base = CACHE_DATA_BASE // 4
            full = np.zeros((D, base + wram_extra.shape[1]), np.int32)
            full[:, :wram.shape[1]] = wram
            full[:, base:] = wram_extra
            wram = full
        # one backend-neutral entry: the registered ExecBackend resolved
        # from cfg (explicit cfg.backend, else the simt_width default)
        # simulates the kernel and aggregates its own report
        be = backends.get(backends.resolve_backend(cfg))
        from repro_torch.core import compile_cache
        st = compile_cache.run(cfg, binary, wram, mram, n_threads=T,
                               ndpus_reg=ndpus_reg, device=self.device)
        if (st["status"] != engine.DONE).any():
            raise RuntimeError(
                f"{name}: kernel hit max_cycles={cfg.max_cycles} "
                f"(status={np.unique(st['status'])})")
        rep = be.report(name, cfg, st, T)
        return st, rep, ranks

    def _launch_faulty(self, name: str, binary: Binary, args, mram, T: int,
                       wram_extra, sel: Optional[List[int]], degraded: bool,
                       ndpus_reg: Optional[int]):
        """Fault-plan launch path: permanent deaths, bit flips + ECC,
        transient retries — then one engine run on the survivors."""
        cfg = self.cfg
        launch_idx = self._launch_idx
        self._launch_idx += 1
        requested = sel if sel is not None else list(range(cfg.n_dpus))
        dead_before = [d for d in requested if not self.active_mask[d]]
        lost_mask = self._advance_permanents(name, launch_idx)
        lost = [d for d in requested if lost_mask[d]]
        if (dead_before or lost) and not degraded:
            raise DpuFaultError(FaultReport(
                kind="permanent", label=name, launch=launch_idx,
                dpus=tuple(sorted(dead_before + lost)),
                detail="launch targets faulted DPUs; retry with "
                       "degraded=True (or remap) to run on survivors"))
        alive = [d for d in requested if self.active_mask[d]]
        if not alive:
            raise DpuFaultError(FaultReport(
                kind="no_active_dpus", label=name, launch=launch_idx,
                dpus=tuple(requested),
                detail="no surviving DPU in launch subset"))

        # resolve the fault outcome of each attempt before paying for the
        # engine: the winning attempt's (possibly silently corrupted)
        # image is the one actually simulated
        policy = self.retry or DEFAULT_POLICY
        freq_hz = cfg.freq_mhz * 1e6
        alive_set = set(alive)
        success_attempt = None
        wasted_attempts: List[Tuple[int, Tuple[int, ...]]] = []
        ecc_seconds = 0.0
        mram_run = mram
        for attempt in range(policy.max_attempts):
            flips = [f for f in self.faults.bitflips(
                         launch_idx, attempt, cfg.n_dpus, mram.shape[1])
                     if f[0] in alive_set]
            outcomes = self.faults.ecc_outcomes(launch_idx, attempt,
                                                len(flips))
            att_ecc, detect_lanes, silent = 0.0, set(), []
            for (d, w, b), oc in zip(flips, outcomes):
                if oc == "correct":
                    att_ecc += self.faults.ecc.correct_cycles / freq_hz
                elif oc == "detect":
                    att_ecc += self.faults.ecc.detect_cycles / freq_hz
                    detect_lanes.add(d)
                else:
                    silent.append((d, w, b))
                self._log_fault(FaultReport(
                    kind="bitflip", label=name, launch=launch_idx,
                    attempt=attempt, dpus=(d,),
                    detail=f"word {w} bit {b}: "
                           f"{oc if self.faults.ecc else 'no ECC'}"))
            t_mask = self.faults.transient_faults(launch_idx, attempt,
                                                  cfg.n_dpus)
            faulted = sorted(detect_lanes | {d for d in alive if t_mask[d]})
            if not faulted:
                success_attempt = attempt
                ecc_seconds = att_ecc
                if silent:
                    mram_run = np.array(mram)  # corrupt a copy, not input
                    for d, w, b in silent:
                        mram_run[d, w] ^= np.int32(1 << b) \
                            if b < 31 else np.int32(-2147483648)
                break
            wasted_attempts.append((attempt, tuple(faulted)))
            if attempt < policy.max_attempts - 1:
                self._log_fault(FaultReport(
                    kind="transient", label=name, launch=launch_idx,
                    attempt=attempt, dpus=tuple(faulted)))

        # one engine run prices the attempts (every attempt executes the
        # same kernel) and, when an attempt succeeded, is the result
        alive_sel = alive if (sel is not None
                              or len(alive) != cfg.n_dpus) else None
        st_sub, rep, ranks = self._launch_engine(
            name, binary, args, mram_run, T, wram_extra, alive_sel,
            ndpus_reg=ndpus_reg)
        rank_res_ranks = ranks if ranks is not None \
            else tuple(range(self.topology.n_ranks))
        for attempt, faulted in wasted_attempts:
            self._charge_retry(
                sq.LAUNCH, name, rep.kernel_seconds,
                {f"rank{r}": rep.kernel_seconds for r in rank_res_ranks},
                attempt)
            backoff = policy.backoff_after(attempt)
            if backoff > 0.0:
                self._charge_retry(sq.LAUNCH, f"{name}:backoff", backoff,
                                   {}, attempt)
        if success_attempt is None:
            raise DpuFaultError(FaultReport(
                kind="retry_exhausted", label=name, launch=launch_idx,
                attempt=policy.max_attempts,
                dpus=wasted_attempts[-1][1],
                detail=f"kernel faulted on all {policy.max_attempts} "
                       "attempts"))
        self._charge_kernel(name, rep.kernel_seconds + ecc_seconds,
                            ranks=ranks)
        self.reports.append(rep)

        # expand the survivor rows back to the requested shape: dead rows
        # carry the untouched input image and DONE status, and
        # last_launch_faults names them — degraded data is labeled, not
        # silently wrong
        if len(alive) != len(requested):
            pos = {d: i for i, d in enumerate(requested)}
            st = {}
            for k, v in st_sub.items():
                full = np.zeros((len(requested),) + v.shape[1:], v.dtype)
                for i, d in enumerate(alive):
                    full[pos[d]] = v[i]
                st[k] = full
            for d in requested:
                if d not in alive_set:
                    st["mram"][pos[d]] = mram[d, :st["mram"].shape[1]]
                    st["status"][pos[d]] = engine.DONE
        else:
            st = st_sub
        self.last_launch_faults = {
            "launch": launch_idx, "requested": tuple(requested),
            "executed": tuple(alive), "lost": tuple(lost),
            "dead_before": tuple(sorted(dead_before)),
            "attempts": len(wasted_attempts) + 1,
        }
        return st, rep


def merge_reports(name: str, reps) -> "stats.KernelReport":
    """Sum multi-kernel reports (BFS/NW iterate kernels)."""
    import copy
    out = copy.deepcopy(reps[0])
    out.name = name
    for r in reps[1:]:
        out.cycles += r.cycles
        out.issued += r.issued
        out.active_cycles += r.active_cycles
        out.idle_mem += r.idle_mem
        out.idle_rev += r.idle_rev
        out.idle_rf += r.idle_rf
        for k in out.cls_counts:
            out.cls_counts[k] += r.cls_counts[k]
        out.hist = out.hist + r.hist
        out.dma_rd_bytes += r.dma_rd_bytes
        out.dma_wr_bytes += r.dma_wr_bytes
        out.row_hit += r.row_hit
        out.row_miss += r.row_miss
        out.tlb_hit += r.tlb_hit
        out.tlb_miss += r.tlb_miss
        out.dc_hit += r.dc_hit
        out.dc_miss += r.dc_miss
        out.acq_retry += r.acq_retry
    return out
