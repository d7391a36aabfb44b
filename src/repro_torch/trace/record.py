"""Command-stream trace recording at the ``PIMSystem._submit`` seam.

A :class:`TraceRecorder` attached to a live system (via :func:`record`)
serializes every submitted :class:`repro_torch.sched.queue.Command` in global
submission order, together with the *re-pricing spec* (``meta``) the
host attached — how the command's seconds were derived:

* ``{"price": "xfer", "dir", "bytes"}`` — a host transfer, re-priceable
  through ``RankTopology.schedule``;
* ``{"price": "collective", "method", "args", "dpus"}`` — the exact
  fabric call :mod:`repro_torch.comm.collectives` made, re-priceable through
  any other fabric;
* ``{"price": "kernel", "freq_mhz", "ranks"}`` — a charged kernel,
  re-scaled by clock ratio (the cycle count is frequency-invariant).

Commands without a spec (retry wastage, fault-degraded transfers whose
seconds carry sampled factors) replay exactly as recorded.  The trace is
JSON-lines: a ``header`` record (config snapshot + queue mode), then
``cmd`` records, with ``sync`` markers where the host resolved the
overlapped schedule.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.sched import queue as sq

TRACE_VERSION = 1


class TraceRecorder:
    """Accumulates one system's command stream (attach via :func:`record`)."""

    def __init__(self, system):
        self.records: List[Dict] = [{
            "type": "header",
            "version": TRACE_VERSION,
            "mode": system.runtime.mode,
            "cfg": dataclasses.asdict(system.cfg),
        }]

    # ---- PIMSystem hooks ----------------------------------------------------
    def on_command(self, cmd: "sq.Command", meta: Optional[Dict]) -> None:
        rec = {
            "type": "cmd",
            "kind": cmd.kind,
            "label": cmd.label,
            "seconds": cmd.seconds,
            "queue": cmd.queue,
            "phase": cmd.phase,
            "nbytes": cmd.nbytes,
            "resources": dict(cmd.resources),
            "wasted": cmd.wasted,
            "attempt": cmd.attempt,
            "waits": [ev.eid for ev in cmd.waits],
        }
        if meta is not None:
            rec["meta"] = meta
        self.records.append(rec)

    def on_event_record(self, ev: "sq.Event") -> None:
        # the EVENT_RECORD command arrives here (not via on_command) so the
        # event id it completes can ride along for replay's waits rewiring
        cmd = ev.recorder
        self.on_command(cmd, None)
        self.records[-1]["eid"] = ev.eid

    def on_sync(self) -> None:
        self.records.append({"type": "sync"})

    # ---- persistence --------------------------------------------------------
    def save(self, path) -> int:
        """Write JSON-lines; returns the number of records written."""
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")
        return len(self.records)


def record(system) -> TraceRecorder:
    """Attach a fresh recorder to ``system`` and return it.

    Everything the system submits from this call on is captured; detach
    with ``system.recorder = None``."""
    rec = TraceRecorder(system)
    system.recorder = rec
    return rec


def load(path) -> List[Dict]:
    """Read a JSONL trace back into its record list."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
