"""Double-buffered batch executor over the command-queue runtime.

``run_pipelined`` runs ``n_batches`` independent instances of a workload,
each on its own stream, so that batch *k+1*'s host->DPU staging and batch
*k-1*'s readback proceed on the memory-channel links while batch *k*'s
kernel holds the rank compute slots — the classic software pipeline that
Gomez-Luna et al. (arXiv:2105.03814) use to hide UPMEM's transfer cost.
``buffers`` bounds the prefetch depth: batch *k* may not start staging
until batch *k - buffers* has fully drained (its MRAM buffers are free
again); ``buffers=2`` is double buffering.

Data correctness is untouched: each batch executes eagerly through the
normal ``Workload.run`` path (numpy oracles and all); only the modeled
time is deferred to the scheduler.  On an in-order system the same call
degenerates to the fully serialized PR 2 execution, which makes it its
own baseline: run it once with ``mode="inorder"`` and once with
``mode="async"`` and compare ``timeline.end_to_end``.
"""
from __future__ import annotations

from typing import Tuple


def run_pipelined(workload, system, n_threads: int, *, n_batches: int = 4,
                  scale: float = 1.0, seed: int = 0, buffers: int = 2,
                  cache_mode: bool = False) -> Tuple[object, object, object]:
    """Pipeline ``n_batches`` runs of ``workload``; returns
    ``(last_state, merged_report, schedule)``."""
    from repro_torch.core.host import merge_reports

    if n_batches < 1:
        raise ValueError("n_batches must be >= 1")
    if buffers < 1:
        raise ValueError("buffers must be >= 1 (need at least one MRAM "
                         "buffer in flight)")
    done = []   # per-batch completion events, for buffer-reuse gating
    reps = []
    st = None
    for k in range(n_batches):
        with system.stream(f"{workload.name}.b{k}"):
            if k >= buffers:
                # batch k reuses batch (k - buffers)'s MRAM buffers; its
                # h2d may not start before they drain
                system.wait_event(done[k - buffers])
            st, rep = workload.run(system, n_threads, scale=scale,
                                   seed=seed + k, cache_mode=cache_mode)
            done.append(system.record_event(f"{workload.name}.b{k}.done"))
            reps.append(rep)
    sched = system.sync()
    name = f"{workload.name}[x{n_batches}]"
    return st, merge_reports(name, reps), sched
