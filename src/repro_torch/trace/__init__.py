"""Record/replay trace frontend (the pathfinding methodology's fast lane).

:mod:`repro_torch.trace.record` captures the typed command stream a live
simulation submits (every transfer, kernel, collective, event and sync,
with the *pricing spec* that derived each command's seconds);
:mod:`repro_torch.trace.replay` re-prices that stream under a different
fabric/topology/frequency config and re-resolves the overlapped
schedule — **without re-simulating any DPU cycles**, which is what makes
wide architecture sweeps cheap (one live run, many replays).

Replaying under the unchanged config reproduces the live ``Timeline``
bit-exactly (deterministic pricing + exact JSONL float round-trip);
``tests/test_trace.py`` pins that.
"""
from repro_torch.trace.record import TRACE_VERSION, TraceRecorder, load, record
from repro_torch.trace.replay import ReplayResult, replay

__all__ = ["TRACE_VERSION", "TraceRecorder", "ReplayResult", "load",
           "record", "replay"]
