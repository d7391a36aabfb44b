"""Cross-layer tracer: spans and instant events on the modeled clocks.

The simulator's layers each know *when* things happen in modeled time —
the :mod:`repro_torch.sched` list scheduler resolves overlapped start/finish
times per command, the fault runtime knows when faults fire on the eager
serialized clock, and the cluster scheduler advances its own event
clock.  The :class:`Tracer` is the one sink they all emit into, and its
export is the Chrome-trace-event JSON that ``ui.perfetto.dev`` (or
``chrome://tracing``) renders directly.

Event schema — a stable contract (tests pin it):

* **Span** — one timed slice.  ``name`` is the command/step label,
  ``start``/``end`` are modeled seconds, ``tracks`` lists every
  per-resource lane the slice occupies (``chan<c>:rank<r>`` link
  shares, ``rank<r>`` compute slots, ``fabric:rank<r>`` interconnect
  shares, the ``retry`` lane for resourceless backoff holds, cluster
  ``rank<r>`` occupancy lanes, ``tenant:<name>`` job lanes), ``phase``
  is the timeline phase (``h2d``/``kernel``/``d2h``/``inter_dpu``/
  ``retry``/``shed``), and ``seconds`` is the *modeled busy duration* the
  submitting layer charged — under a ``channel_contention`` stretch the
  scheduled wall slice ``end - start`` may exceed ``seconds``, and
  per-phase accounting always sums ``seconds`` (that is what matches
  :class:`~repro_torch.core.host.Timeline` busy totals bit-for-bit).
  A span with ``async_id`` is exported as a Chrome async ``b``/``e``
  pair (cluster job spans, which may overlap within one tenant lane).
* **Instant** — a point event: fault injections, retries, preemptions,
  admissions, spare promotions.  Stamped on the emitting layer's clock
  (the eager serialized clock for the fault runtime, the cluster event
  clock for cluster events) and carried on its own ``pid`` so Perfetto
  never mixes timebases within one process group.

Every quantity is derived from modeled seconds — never wall clock — so
the same seed produces the same trace, byte for byte, in either queue
mode.  Chrome timestamps are microseconds; seconds are scaled by 1e6 on
export only, accounting stays in seconds.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

#: process-group labels (Chrome trace ``pid``) for the emitting layers
PID_SYSTEM = "system"     # overlapped repro_torch.sched schedule spans
PID_HOST = "host"         # eager-clock instants (fault runtime, retries)
PID_CLUSTER = "cluster"   # cluster event-clock spans/instants


@dataclass(frozen=True)
class Span:
    """One timed slice of the run (see module docstring for the schema)."""

    name: str
    start: float                       # modeled seconds
    end: float
    tracks: Tuple[str, ...]            # per-resource lanes this occupies
    pid: str = PID_SYSTEM
    phase: Optional[str] = None        # timeline phase, when applicable
    seconds: float = -1.0              # modeled busy duration (< 0: end-start)
    wasted: float = 0.0                # seconds that produced nothing
    nbytes: float = 0.0
    attempt: int = 0
    async_id: Optional[int] = None     # exported as async b/e when set
    args: Tuple[Tuple[str, Any], ...] = ()

    @property
    def busy(self) -> float:
        """Modeled busy seconds (falls back to the wall slice)."""
        return self.seconds if self.seconds >= 0.0 else self.end - self.start


@dataclass(frozen=True)
class Instant:
    """A point event on one layer's clock."""

    name: str
    ts: float                          # modeled seconds
    track: str = "events"
    pid: str = PID_HOST
    args: Tuple[Tuple[str, Any], ...] = ()


class Tracer:
    """Collects spans + instants from every layer; exports Chrome JSON.

    Systems built while a tracer is installed attach themselves
    (:meth:`attach_system`); :meth:`finalize` then resolves any system
    with still-unscheduled commands via ``sync()`` so the export always
    covers the full run.  Ingesting a system's schedule twice replaces
    its previous spans (``sync()`` re-resolves the whole history), so
    repeated syncs stay idempotent.

    The tracer never feeds back into the simulation: with a tracer
    attached, every timeline, schedule, result, and report is bit-exact
    with ``tracer=None`` (tests pin this).
    """

    def __init__(self):
        self._spans: List[Span] = []               # manual (cluster) spans
        self._instants: List[Instant] = []
        self._sched_spans: Dict[Any, List[Span]] = {}  # per ingestion key
        self._systems: List[Any] = []              # attach order = pid order
        self._pid_of: Dict[int, str] = {}          # id(system) -> pid label

    # ---- attachment --------------------------------------------------------
    def attach_system(self, system) -> str:
        """Register a :class:`PIMSystem`; returns its stable pid label
        (``system``, ``system1``, ... in attach order)."""
        key = id(system)
        if key in self._pid_of:
            return self._pid_of[key]
        n = len(self._systems)
        pid = PID_SYSTEM if n == 0 else f"{PID_SYSTEM}{n}"
        self._systems.append(system)
        self._pid_of[key] = pid
        return pid

    def pid_of(self, system) -> str:
        """The pid label a system's schedule spans are exported under."""
        return self._pid_of.get(id(system), PID_SYSTEM)

    @property
    def systems(self) -> Tuple[Any, ...]:
        """Attached systems, in attach (= pid) order."""
        return tuple(self._systems)

    def finalize(self):
        """Resolve every attached system that still has unscheduled work
        (its ``timeline.elapsed`` was invalidated by submissions after
        the last ``sync()``), so the export covers the whole run."""
        for system in self._systems:
            if (system.timeline.elapsed is None
                    and any(len(q) for q in system.runtime.queues)):
                system.sync()

    # ---- emission ----------------------------------------------------------
    def span(self, name: str, start: float, end: float,
             tracks: Sequence[str], *, pid: str = PID_SYSTEM,
             phase: Optional[str] = None, seconds: float = -1.0,
             wasted: float = 0.0, nbytes: float = 0.0, attempt: int = 0,
             async_id: Optional[int] = None,
             args: Optional[Mapping[str, Any]] = None) -> Span:
        sp = Span(name=name, start=start, end=end, tracks=tuple(tracks),
                  pid=pid, phase=phase, seconds=seconds, wasted=wasted,
                  nbytes=nbytes, attempt=attempt, async_id=async_id,
                  args=tuple(sorted((args or {}).items())))
        self._spans.append(sp)
        return sp

    def instant(self, name: str, ts: float, *, track: str = "events",
                pid: str = PID_HOST,
                args: Optional[Mapping[str, Any]] = None) -> Instant:
        ev = Instant(name=name, ts=ts, track=track, pid=pid,
                     args=tuple(sorted((args or {}).items())))
        self._instants.append(ev)
        return ev

    def ingest_schedule(self, schedule, key: Any = None,
                        pid: str = PID_SYSTEM):
        """Convert one resolved :class:`~repro_torch.sched.scheduler.Schedule`
        into spans — one logical span per scheduled command, carrying
        every resource lane the command holds.  Re-ingesting under the
        same ``key`` replaces the previous spans (idempotent syncs)."""
        spans: List[Span] = []
        for it in schedule.items:
            cmd = it.cmd
            if cmd.seconds <= 0.0 and not cmd.resources:
                continue  # zero-cost EVENT_RECORD / EVENT_WAIT markers
            tracks = tuple(sorted(cmd.resources)) or (
                ("retry",) if cmd.phase == "retry" else (cmd.queue,))
            spans.append(Span(
                name=cmd.label, start=it.start, end=it.finish,
                tracks=tracks, pid=pid, phase=cmd.phase,
                seconds=cmd.seconds, wasted=cmd.wasted, nbytes=cmd.nbytes,
                attempt=cmd.attempt,
                args=(("kind", cmd.kind), ("queue", cmd.queue))))
        self._sched_spans[key if key is not None else id(schedule)] = spans

    def ingest_system(self, system):
        """Ingest a system's last resolved schedule under its pid."""
        if system.last_schedule is None:
            system.sync()
        self.ingest_schedule(system.last_schedule, key=id(system),
                             pid=self.pid_of(system))

    # ---- views -------------------------------------------------------------
    def spans(self, pid: Optional[str] = None) -> List[Span]:
        out = [s for ss in self._sched_spans.values() for s in ss]
        out += self._spans
        if pid is not None:
            out = [s for s in out if s.pid == pid]
        return out

    def instants(self, pid: Optional[str] = None) -> List[Instant]:
        if pid is None:
            return list(self._instants)
        return [i for i in self._instants if i.pid == pid]

    def phase_sums(self, pid: Optional[str] = None) -> Dict[str, float]:
        """Modeled busy seconds per timeline phase, summed over spans
        (each command counted once, however many lanes it occupies)."""
        out: Dict[str, float] = {}
        for s in self.spans(pid):
            if s.phase:
                out[s.phase] = out.get(s.phase, 0.0) + s.busy
        return out

    def makespan(self, pid: Optional[str] = None) -> float:
        return max((s.end for s in self.spans(pid)), default=0.0)

    # ---- consistency -------------------------------------------------------
    def validate(self, atol: float = 1e-9) -> List[str]:
        """Trace/timeline agreement over every attached system: each
        timeline phase's busy total must equal the same phase's span
        sum (each submitted command traced exactly once).  Returns a
        list of mismatch descriptions (empty = consistent)."""
        errors: List[str] = []
        for system in self._systems:
            pid = self.pid_of(system)
            if id(system) not in self._sched_spans:
                if any(len(q) for q in system.runtime.queues):
                    errors.append(f"{pid}: submitted commands were never "
                                  "ingested (missing sync/finalize)")
                continue
            sums = self.phase_sums(pid)
            tl = system.timeline
            for phase in ("h2d", "kernel", "d2h", "inter_dpu", "retry",
                          "shed"):
                want = getattr(tl, phase)
                got = sums.get(phase, 0.0)
                if abs(want - got) > atol:
                    errors.append(
                        f"{pid}: phase {phase!r} trace sum {got!r} != "
                        f"timeline busy {want!r}")
        return errors

    # ---- export ------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """The run as a Chrome-trace-event JSON object (Perfetto-ready):
        ``X`` complete events per occupied lane, ``b``/``e`` async pairs
        for ``async_id`` spans, ``i`` instants, plus process/thread name
        metadata.  Deterministic: events are emitted in sorted order and
        pids/tids are assigned by sorted label."""
        spans = self.spans()
        instants = self.instants()
        pids = sorted({s.pid for s in spans} | {i.pid for i in instants})
        pid_no = {p: n + 1 for n, p in enumerate(pids)}
        tids: Dict[Tuple[str, str], int] = {}
        labels = sorted({(s.pid, t) for s in spans for t in s.tracks}
                        | {(i.pid, i.track) for i in instants})
        for pid, track in labels:
            tids[(pid, track)] = len([1 for (p, _) in tids if p == pid]) + 1
        events: List[Dict[str, Any]] = []
        for pid, track in labels:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid_no[pid], "tid": tids[(pid, track)],
                           "args": {"name": track}})
        for p in pids:
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid_no[p], "args": {"name": p}})
        us = 1e6
        body: List[Dict[str, Any]] = []
        for s in spans:
            args = dict(s.args)
            args["busy_s"] = s.busy
            if s.phase:
                args["phase"] = s.phase
            if s.wasted:
                args["wasted_s"] = s.wasted
            if s.nbytes:
                args["nbytes"] = s.nbytes
            if s.attempt:
                args["attempt"] = s.attempt
            if s.async_id is not None:
                tid = tids[(s.pid, s.tracks[0])]
                common = {"cat": "job", "name": s.name, "pid": pid_no[s.pid],
                          "tid": tid, "id": s.async_id}
                body.append({**common, "ph": "b", "ts": s.start * us,
                             "args": args})
                body.append({**common, "ph": "e", "ts": s.end * us})
                continue
            for track in s.tracks:
                body.append({"ph": "X", "name": s.name,
                             "cat": s.phase or "span",
                             "pid": pid_no[s.pid], "tid": tids[(s.pid, track)],
                             "ts": s.start * us,
                             "dur": (s.end - s.start) * us, "args": args})
        for i in instants:
            body.append({"ph": "i", "name": i.name, "s": "t", "cat": "event",
                         "pid": pid_no[i.pid], "tid": tids[(i.pid, i.track)],
                         "ts": i.ts * us, "args": dict(i.args)})
        body.sort(key=lambda e: (e["ts"], e["pid"], e["tid"],
                                 e["ph"], e["name"]))
        events.extend(body)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write the Chrome-trace JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path
