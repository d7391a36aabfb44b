"""Deterministic list scheduler: command DAG -> overlapped timeline.

Resolves the queues' dependency structure (in-queue program order +
cross-queue event waits) against the machine's resources into per-command
start/finish times:

* ``chan<c>:rank<r>`` — rank *r*'s share of memory-channel link *c*.
  H2D/D2H commands (and host-bounced collectives) hold the shares of the
  ranks they actually touch, as charged by the
  :class:`~repro_torch.comm.topology.RankTopology`; two transfers touching the
  same rank serialize, transfers on disjoint rank sets overlap — even on
  one physical channel — and every transfer overlaps kernels, which is
  the whole point of the subsystem.
* ``rank<r>`` — one compute slot per rank; a LAUNCH holds the ranks it
  runs on (all of them by default, only its subset's ranks for a
  ``launch(dpus=...)``), so kernels serialize with each other per rank
  but not with transfers.
* ``fabric:rank<r>`` — rank *r*'s attachment to the direct/hierarchical
  PIM-PIM interconnect (when configured).

Resource names before the ``:`` form a **physical group** (the channel
or the fabric).  When ``contention > 1`` and a command starts while
another rank's share of the same group is still busy, the command's
duration and holds stretch by the contention factor — the causal
approximation that the later arrival pays for sharing the physical
link.  ``contention = 1`` (the default) models fully independent
per-rank shares and leaves every PR 3 timeline bit-exact.

The policy is a classic list scheduler: repeatedly pick, among the head
commands of all queues whose event waits are satisfied, the one with the
earliest feasible start (ties broken by global submission order), and
commit it.  The result is deterministic for a given submission sequence.

With a single queue the schedule degenerates to back-to-back execution —
start(k+1) = finish(k) — because a command's resource holds never outlast
the command itself; this is what makes the in-order mode reproduce the
PR 2 serialized timeline exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.sched.queue import Command, CommandQueue


def resource_group(resource: str) -> str:
    """Physical group of a resource name: ``chan0:rank1`` -> ``chan0``
    (rank 1's share of channel 0); ungrouped names are their own group."""
    return resource.split(":", 1)[0]


@dataclass(frozen=True)
class ScheduledCommand:
    cmd: Command
    start: float
    finish: float


@dataclass
class Schedule:
    """The resolved timeline: commands with start/finish times."""

    items: List[ScheduledCommand] = field(default_factory=list)
    makespan: float = 0.0
    #: total busy seconds per resource (link shares, rank slots, fabric)
    resource_busy: Dict[str, float] = field(default_factory=dict)

    def span(self, cmd: Command) -> Tuple[float, float]:
        """(start, finish) of one submitted command."""
        for it in self.items:
            if it.cmd is cmd:
                return it.start, it.finish
        raise KeyError(f"{cmd!r} is not part of this schedule")

    def by_queue(self, name: str) -> List[ScheduledCommand]:
        return [it for it in self.items if it.cmd.queue == name]

    def phase_busy(self) -> Dict[str, float]:
        """Serialized busy seconds per timeline phase (the sum of the
        submitted command durations — double counts wall time once
        same-phase commands overlap; use :meth:`covered` for the
        overlap-aware wall-clock share)."""
        out: Dict[str, float] = {}
        for it in self.items:
            if it.cmd.phase:
                out[it.cmd.phase] = out.get(it.cmd.phase, 0.0) + it.cmd.seconds
        return out

    def utilization(self, resource: str) -> float:
        """Busy fraction of one resource over the makespan."""
        if self.makespan <= 0:
            return 0.0
        return self.resource_busy.get(resource, 0.0) / self.makespan

    def covered(self, phase: str) -> float:
        """Wall-clock seconds during which at least one ``phase`` command
        is in flight (interval union — two per-rank kernels running
        concurrently cover their union, not their sum)."""
        spans = sorted((it.start, it.finish) for it in self.items
                       if it.cmd.phase == phase and it.finish > it.start)
        total = 0.0
        cur_s: Optional[float] = None
        cur_f = 0.0
        for s, f in spans:
            if cur_s is None or s > cur_f:
                if cur_s is not None:
                    total += cur_f - cur_s
                cur_s, cur_f = s, f
            elif f > cur_f:
                cur_f = f
        if cur_s is not None:
            total += cur_f - cur_s
        return total

    def wasted(self) -> float:
        """Scheduled seconds that produced nothing: failed attempts and
        backoff holds re-enqueued by the fault runtime, plus hedged
        duplicates (``phase="shed"`` speculation — exactly one of a
        hedge pair is redundant, and the duplicate is marked fully
        wasted at submit time).  Each command's waste is its scheduled
        duration scaled by its own wasted fraction, so contention
        stretch inflates waste the same way it inflates useful time."""
        total = 0.0
        for it in self.items:
            if it.cmd.wasted > 0.0 and it.cmd.seconds > 0.0:
                total += ((it.finish - it.start)
                          * (it.cmd.wasted / it.cmd.seconds))
        return total

    def goodput(self) -> float:
        """Useful fraction of the scheduled work: 1 − wasted/total
        scheduled seconds (1.0 for a fault-free schedule, and for an
        empty one)."""
        total = sum(it.finish - it.start for it in self.items)
        if total <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.wasted() / total)

    def exposed(self, phase: str) -> float:
        """Makespan share NOT covered by ``phase``: e.g.
        ``exposed("kernel")`` is the end-to-end time the host spends
        outside kernel execution — transfer time the overlap failed to
        hide (0 when the kernels are the critical path).  Uses interval
        merging, so overlapping same-phase commands (per-rank subset
        launches) are counted once, not summed."""
        return max(0.0, self.makespan - self.covered(phase))

    def to_chrome_trace(self) -> dict:
        """This schedule as a Chrome-trace-event JSON object: one ``X``
        slice per command per occupied resource lane (``chan<c>:rank<r>``
        link shares, ``rank<r>`` compute slots, ``fabric:rank<r>``,
        the ``retry`` lane for resourceless backoff holds), ready for
        ``ui.perfetto.dev``.  ``json.dump`` the result, or go through
        :class:`repro_torch.obs.Tracer` to combine several layers' events in
        one trace."""
        from repro_torch.obs.tracer import Tracer
        t = Tracer()
        t.ingest_schedule(self)
        return t.to_chrome_trace()


def schedule(queues: Sequence[CommandQueue],
             contention: float = 1.0) -> Schedule:
    """Run the list scheduler over ``queues``; raises on deadlock (a wait
    on an event that is never recorded, or whose recorder transitively
    waits on the waiter).

    ``contention >= 1`` stretches a command that starts while another
    share of one of its physical resource groups is still busy (see
    module docstring); 1.0 models independent shares."""
    if contention < 1.0:
        raise ValueError(f"contention factor must be >= 1, got {contention}")
    names = [q.name for q in queues]
    if len(set(names)) != len(names):
        # two same-named queues would silently share a head cursor and
        # interleave their command chains into a corrupt timeline
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate queue names {dupes}: every queue "
                         "passed to schedule() must be distinct")
    heads = {id(q): 0 for q in queues}        # keyed by queue identity
    ready = {id(q): 0.0 for q in queues}      # in-queue ready time
    avail: Dict[str, float] = {}              # resource -> free-at time
    # finish times keyed by command identity, NOT seq: a foreign event
    # (recorded on another runtime) must dangle into deadlock, never
    # resolve against an unrelated local command with the same seq
    finished: Dict[int, float] = {}           # id(cmd) -> finish time
    sched = Schedule()
    remaining = sum(len(q) for q in queues)

    while remaining:
        best: Optional[Tuple[float, int, CommandQueue, Command]] = None
        for q in queues:
            i = heads[id(q)]
            if i >= len(q.commands):
                continue
            cmd = q.commands[i]
            if any(w.recorder is None or id(w.recorder) not in finished
                   for w in cmd.waits):
                continue  # event dependency not resolved yet
            start = ready[id(q)]
            for w in cmd.waits:
                start = max(start, finished[id(w.recorder)])
            for r in cmd.resources:
                start = max(start, avail.get(r, 0.0))
            if best is None or (start, cmd.seq) < (best[0], best[1]):
                best = (start, cmd.seq, q, cmd)
        if best is None:
            stuck = [q.commands[heads[id(q)]] for q in queues
                     if heads[id(q)] < len(q.commands)]
            raise RuntimeError(
                "scheduler deadlock: no queue head is runnable — a command "
                f"waits on an event that is never recorded ({stuck})")
        start, _, q, cmd = best
        stretch = 1.0
        if contention > 1.0 and cmd.resources:
            mine = set(cmd.resources)
            groups = {resource_group(r) for r in mine}
            if any(r2 not in mine and resource_group(r2) in groups
                   and free_at > start
                   for r2, free_at in avail.items()):
                stretch = contention  # sharing a physical link: pay up
        finish = start + cmd.seconds * stretch
        for r, busy in cmd.resources.items():
            avail[r] = start + busy * stretch
            sched.resource_busy[r] = \
                sched.resource_busy.get(r, 0.0) + busy * stretch
        ready[id(q)] = finish
        heads[id(q)] += 1
        finished[id(cmd)] = finish
        sched.items.append(ScheduledCommand(cmd, start, finish))
        sched.makespan = max(sched.makespan, finish)
        remaining -= 1
    return sched
