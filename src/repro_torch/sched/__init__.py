"""``repro_torch.sched`` — asynchronous command-queue runtime.

Layered between the host API (:class:`~repro_torch.core.host.PIMSystem`) and
the engine / :mod:`repro_torch.comm` models:

* :mod:`repro_torch.sched.queue` — typed commands (H2D / D2H / LAUNCH /
  COLLECTIVE / EVENT_WAIT / EVENT_RECORD) on per-stream
  :class:`CommandQueue`\\ s with explicit :class:`Event` dependencies;
  ``QueueRuntime`` owns the streams and the in-order vs async policy.
* :mod:`repro_torch.sched.scheduler` — a deterministic list scheduler that
  resolves the command DAG over the machine's resources (per-rank link
  shares ``chan<c>:rank<r>`` from
  :class:`~repro_torch.comm.topology.RankTopology`, per-rank DPU compute
  slots, per-rank fabric shares) into an overlapped :class:`Schedule`;
  transfers on one rank run under kernels holding another rank's
  compute slots, operations on disjoint rank sets overlap even on a
  shared physical channel, and a configurable contention factor prices
  that sharing.
* :mod:`repro_torch.sched.pipeline` — ``run_pipelined``: the double-buffered
  batch executor that stages batch *k+1*'s h2d and drains batch *k-1*'s
  d2h under batch *k*'s kernel.

``PIMSystem`` routes every phase through this layer.  The default
``mode="inorder"`` keeps a single serial queue and reproduces the fully
synchronous timelines bit-exact; ``mode="async"`` honors streams and
lets the scheduler overlap.  ``PIMSystem.sync()`` resolves the schedule
and stamps ``timeline.elapsed`` (see ``Timeline.end_to_end``).
"""
from repro_torch.sched.pipeline import run_pipelined
from repro_torch.sched.queue import (COLLECTIVE, D2H, EVENT_RECORD, EVENT_WAIT,
                               H2D, KINDS, LAUNCH, Command, CommandQueue,
                               Event, QueueRuntime)
from repro_torch.sched.scheduler import (Schedule, ScheduledCommand,
                                   resource_group, schedule)

__all__ = [
    "Command", "CommandQueue", "Event", "QueueRuntime",
    "H2D", "D2H", "LAUNCH", "COLLECTIVE", "EVENT_WAIT", "EVENT_RECORD",
    "KINDS", "Schedule", "ScheduledCommand", "schedule", "resource_group",
    "run_pipelined",
]
