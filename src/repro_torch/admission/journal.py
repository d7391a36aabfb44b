"""Crash-consistent cluster journal: JSONL write-ahead log + replay.

The cluster simulator is deterministic: given the same job stream,
system seed, and knobs, every decision (placement, preemption, breaker
trips, admission order) re-derives identically.  The only thing a crash
loses is *which step outcomes already happened* — so that is all the
journal records.  Each ``step``/``fault`` line carries the measured
delta, the credited ideal seconds, the clean flag, the optional hedge
result, the system's fault-stream counters (``li``/``xi``, the
launch/transfer indices of the pure :class:`FaultPlan`), and the
absolute timeline phase accumulators (``tl`` — restored on replay so
post-resume live steps difference the accumulators from bit-identical
state; summing deltas back would drift by one ULP).  On resume a
fresh cluster replays the event loop; journaled steps are applied from
the log (fast-forwarding the fault counters instead of re-submitting),
and execution goes live at the first un-journaled step — producing a
bit-identical :class:`ClusterReport` to the uninterrupted run.

Lines are flushed as written, so a killed process loses at most the
line being written; :func:`ClusterJournal.load` drops a torn tail.
:class:`SimulatedCrash` is the test/benchmark hook — the cluster raises
it after ``crash_after`` journal writes, leaving the file exactly as a
real kill would.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

JOURNAL_VERSION = 1


class SimulatedCrash(RuntimeError):
    """Raised by ``PimCluster(crash_after=K)`` right after the K-th
    step/fault journal write — the deterministic stand-in for kill -9
    the kill-and-resume tests use."""


class ClusterJournal:
    """Append-only JSONL writer (the read side is :meth:`load`)."""

    def __init__(self, path: str, append: bool = False):
        self.path = str(path)
        self._f = open(self.path, "a" if append else "w")
        self.writes = 0

    def write(self, rec: Dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.writes += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    @staticmethod
    def load(path: str) -> List[Dict]:
        """Read a journal back, tolerating a torn final line (the write
        a crash interrupted): any trailing record that fails to parse
        is dropped — it was never acknowledged."""
        if not os.path.exists(path):
            return []
        records: List[Dict] = []
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn tail: drop and resume from the prefix
                raise ValueError(
                    f"{path}:{i + 1}: corrupt journal record (not the "
                    "final line, so this is not a torn tail)")
        return records
