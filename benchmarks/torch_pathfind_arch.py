"""Architecture pathfinding: MIMD (UPMEM-style) vs HBM-PIM all-bank, on the
PyTorch/CUDA port (benchmarks/pathfind_arch.py's benches, the same rows,
on ``repro_torch``; every system simulates on the CUDA card unless
``device="cpu"`` asks for the CPU: the scalar DPU through the
``cycle_step`` kernel, the SIMT DPU and the all-bank target through
``simt_step``).

Two benches:

* :func:`compare` — the same workloads (streaming GEMVS, BFS) on three
  execution backends through the unchanged ``Workload`` API: the scalar
  MIMD baseline, the SIMT vector DPU, and the HBM-PIM all-bank target.
  One row per (arch, workload) with cycles / kernel seconds / IPC /
  end-to-end — the paper's "which PIM style wins where" table.

* :func:`replay_sweep` — the record/replay methodology: simulate BFS
  *once* on the baseline, record its command stream, then sweep the
  interconnect design space (fabric x channel count) by re-pricing the
  trace with :func:`repro_torch.trace.replay` — no DPU cycles re-simulated.
  Rows carry the live-vs-replay wall-clock speedup alongside each sweep
  point's modeled times.

    python -m benchmarks.torch_run --suite pathfind [--device cpu]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import trace  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.workloads import get  # noqa: E402

ARCHS = (
    ("mimd-scalar", {}),
    ("mimd-simt", {"simt_width": 4}),
    ("hbmpim", {"backend": "hbmpim"}),
)


def compare(scale: float = 0.05, n_threads: int = 8, device=None):
    rows = []
    for arch, kw in ARCHS:
        for wl_name in ("GEMVS", "BFS"):
            cfg = DPUConfig(n_dpus=8, n_ranks=2, n_channels=2, **kw)
            system = PIMSystem(cfg, device=device)
            _, rep = get(wl_name).run(system, n_threads, scale=scale, seed=0)
            rows.append({
                "arch": arch, "workload": wl_name,
                "cycles": rep.cycles, "ipc": round(rep.ipc, 4),
                "kernel_s": rep.kernel_seconds,
                "end_to_end_s": system.timeline.end_to_end,
            })
    return rows


def replay_sweep(scale: float = 0.05, n_threads: int = 8, device=None):
    base = DPUConfig(n_dpus=8, n_ranks=4, n_channels=2)
    # one run beforehand so t_live measures steady-state simulation, not
    # the kernels' build
    get("BFS").run(PIMSystem(base, device=device), n_threads, scale=scale,
                   seed=0)

    t0 = time.perf_counter()
    system = PIMSystem(base, device=device)
    rec = trace.record(system)
    get("BFS").run(system, n_threads, scale=scale, seed=0)
    system.sync()
    t_live = time.perf_counter() - t0

    rows = []
    for fabric in ("host", "direct", "hier"):
        for channels in (1, 2, 4):
            cfg = base.replace(fabric=fabric, n_channels=channels)
            t0 = time.perf_counter()
            res = trace.replay(rec.records, cfg=cfg)
            t_replay = time.perf_counter() - t0
            rows.append({
                "fabric": fabric, "channels": channels,
                "end_to_end_s": res.end_to_end,
                "inter_dpu_s": res.timeline.inter_dpu,
                "h2d_s": res.timeline.h2d,
                "replay_speedup": round(t_live / max(t_replay, 1e-9), 1),
            })
    return rows
