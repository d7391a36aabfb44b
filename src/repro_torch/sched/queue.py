"""Command queues: the submission side of the async runtime.

The host expresses work as typed :class:`Command`\\ s appended to
:class:`CommandQueue`\\ s ("streams" in GPU terminology).  Commands in one
queue execute in submission order; commands in different queues are
unordered unless tied together with :class:`Event`\\ s (EVENT_RECORD in
the producing queue, EVENT_WAIT in the consuming one) or until they
collide on a hardware resource (a memory-channel link, a rank's DPUs)
in :mod:`repro_torch.sched.scheduler`.

Execution in the simulator is *eager for data, lazy for time*: payloads
move and kernels run at submit time (so oracles see program order), and
each submitted command carries the modeled seconds it will occupy; the
scheduler later resolves the dependency DAG into an overlapped timeline.
"""
from __future__ import annotations

import itertools
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

# ---- command kinds ---------------------------------------------------------
H2D = "H2D"                    # host write to DPU MRAM
D2H = "D2H"                    # host read from DPU MRAM
LAUNCH = "LAUNCH"              # kernel on a DPU/rank subset (default: all)
COLLECTIVE = "COLLECTIVE"      # inter-DPU exchange through the fabric
EVENT_WAIT = "EVENT_WAIT"      # block this queue until an event completes
EVENT_RECORD = "EVENT_RECORD"  # mark "everything before me in this queue"

KINDS = (H2D, D2H, LAUNCH, COLLECTIVE, EVENT_WAIT, EVENT_RECORD)

_event_ids = itertools.count()


@dataclass(eq=False)
class Event:
    """Cross-queue synchronization point (CUDA-event style).

    Recorded by an EVENT_RECORD command; any command that lists it in
    ``waits`` cannot start before the recording command finishes."""

    label: str = ""
    eid: int = field(default_factory=lambda: next(_event_ids))
    #: the EVENT_RECORD command that completes this event (set on record)
    recorder: Optional["Command"] = None

    @property
    def recorded(self) -> bool:
        return self.recorder is not None

    def __repr__(self):
        return f"Event({self.eid}, {self.label!r})"


@dataclass(eq=False)
class Command:
    """One unit of queued work plus its modeled cost.

    ``seconds`` is the command's elapsed time; ``resources`` maps a
    hardware resource name (``chan<c>:rank<r>`` link share, ``rank<r>``
    compute slot, ``fabric:rank<r>`` interconnect share) to the busy
    seconds this command holds it — each entry must be <= ``seconds``
    (a command cannot occupy a resource after it finished).

    ``wasted`` marks the part of ``seconds`` that produced nothing — the
    fault runtime re-enqueues failed attempts and backoff holds as
    fully-wasted commands (``phase="retry"``) so schedules can report
    goodput.  ``attempt`` records which retry attempt this command was."""

    kind: str
    label: str
    seconds: float
    seq: int                       # global submission order (determinism)
    queue: str
    phase: Optional[str] = None    # timeline phase (h2d/kernel/.../retry)
    nbytes: float = 0.0
    resources: Mapping[str, float] = field(default_factory=dict)
    waits: Tuple[Event, ...] = ()
    wasted: float = 0.0            # seconds of this command producing nothing
    attempt: int = 0               # retry attempt index (0 = first try)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown command kind {self.kind!r}")
        if self.seconds < 0:
            raise ValueError("command seconds must be >= 0")
        if not 0.0 <= self.wasted <= self.seconds:
            raise ValueError("command wasted must be in [0, seconds]")
        for r, busy in self.resources.items():
            if busy > self.seconds:
                raise ValueError(
                    f"{self.kind} holds {r} for {busy}s > its own "
                    f"{self.seconds}s elapsed")

    def __repr__(self):
        return (f"Command({self.kind}, {self.label!r}, q={self.queue!r}, "
                f"{self.seconds:.3e}s)")


@dataclass
class CommandQueue:
    """In-order stream of commands."""

    name: str
    commands: List[Command] = field(default_factory=list)

    def submit(self, cmd: Command) -> Command:
        self.commands.append(cmd)
        return cmd

    def __len__(self):
        return len(self.commands)


class QueueRuntime:
    """Owns the system's queues and the current submission stream.

    ``mode="inorder"`` (default): every command lands on the single
    ``main`` queue regardless of any :meth:`stream` context — one serial
    chain, reproducing the fully-synchronous PR 2 execution exactly.
    ``mode="async"``: ``stream(name)`` routes submissions to a per-name
    queue so independent work can overlap.
    """

    MODES = ("inorder", "async")

    def __init__(self, mode: str = "inorder"):
        if mode not in self.MODES:
            raise ValueError(f"unknown queue mode {mode!r} "
                             f"(want {'|'.join(self.MODES)})")
        self.mode = mode
        self._queues: Dict[str, CommandQueue] = {}
        self._stack: List[str] = ["main"]
        self._seq = 0
        self._owned: set = set()  # id() of every command submitted here

    # ---- streams -----------------------------------------------------------
    def queue(self, name: str) -> CommandQueue:
        return self._queues.setdefault(name, CommandQueue(name))

    @property
    def queues(self) -> List[CommandQueue]:
        return list(self._queues.values())

    @property
    def current(self) -> CommandQueue:
        name = self._stack[-1] if self.mode == "async" else "main"
        return self.queue(name)

    @contextmanager
    def stream(self, name: str):
        self._stack.append(name)
        try:
            yield self.current
        finally:
            self._stack.pop()

    # ---- submission --------------------------------------------------------
    def submit(self, kind: str, label: str, seconds: float, *,
               phase: Optional[str] = None, nbytes: float = 0.0,
               resources: Optional[Mapping[str, float]] = None,
               waits: Tuple[Event, ...] = (), wasted: float = 0.0,
               attempt: int = 0) -> Command:
        cmd = Command(kind=kind, label=label, seconds=seconds,
                      seq=self._seq, queue=self.current.name, phase=phase,
                      nbytes=nbytes, resources=dict(resources or {}),
                      waits=tuple(waits), wasted=wasted, attempt=attempt)
        self._seq += 1
        self._owned.add(id(cmd))
        return self.current.submit(cmd)

    def record_event(self, label: str = "") -> Event:
        ev = Event(label=label)
        ev.recorder = self.submit(EVENT_RECORD, label or "record", 0.0)
        return ev

    def wait_event(self, ev: Event) -> Command:
        if ev.recorder is not None and id(ev.recorder) not in self._owned:
            raise ValueError(
                f"{ev!r} was recorded on a different QueueRuntime; events "
                f"only synchronize streams of the same system")
        return self.submit(EVENT_WAIT, ev.label or "wait", 0.0,
                           waits=(ev,))
