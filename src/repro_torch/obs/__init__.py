"""``repro_torch.obs`` — unified observability for the PIM stack.

One tracer, every layer: :class:`~repro_torch.core.host.PIMSystem` transfers/
kernels/retries (overlapped spans from the resolved
:class:`~repro_torch.sched.scheduler.Schedule`), fault injections and remap
rounds from :mod:`repro_torch.faults`, and
:class:`~repro_torch.cluster.scheduler.PimCluster` job/step spans with
preemptions and spare promotions as instant events.  Exports load
directly in ``ui.perfetto.dev``; :class:`RunProfile` aggregates run
counters into JSON / Prometheus snapshots; ``python -m
repro_torch.obs.report`` renders both for humans.

Tracing is strictly opt-in and zero-cost when off: every emission site
is guarded by ``tracer is not None``, ``tracer=None`` is the default
everywhere, and an enabled tracer never feeds back into the simulation
(bit-exact timelines either way — tests pin it).

Install a tracer either per system (``PIMSystem(cfg, tracer=t)``) or
process-wide for code you don't construct systems in yourself
(``benchmarks/run.py --trace`` does this)::

    from repro_torch import obs
    t = obs.Tracer()
    with obs.default_tracer(t):      # systems built here attach to t
        run_benchmark()
    t.finalize()                     # sync any un-synced system
    t.save("run.trace.json")         # open in ui.perfetto.dev
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from repro_torch.obs.profile import RunProfile
from repro_torch.obs.tracer import (PID_CLUSTER, PID_HOST, PID_SYSTEM, Instant,
                              Span, Tracer)

__all__ = ["Tracer", "Span", "Instant", "RunProfile",
           "PID_SYSTEM", "PID_HOST", "PID_CLUSTER",
           "get_default_tracer", "set_default_tracer", "default_tracer"]

_DEFAULT: Optional[Tracer] = None


def get_default_tracer() -> Optional[Tracer]:
    """The process-wide tracer new systems adopt when built with
    ``tracer=None`` (None unless one was installed)."""
    return _DEFAULT


def set_default_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with None, remove) the process-wide default tracer;
    returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = tracer
    return prev


@contextmanager
def default_tracer(tracer: Tracer):
    """Scoped install: systems constructed inside the block attach to
    ``tracer``; the previous default is restored on exit."""
    prev = set_default_tracer(tracer)
    try:
        yield tracer
    finally:
        set_default_tracer(prev)
