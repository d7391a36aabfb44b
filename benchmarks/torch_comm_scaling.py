"""Fig. 10-style multi-rank strong scaling with the repro_torch.comm subsystem
on the PyTorch/CUDA port (benchmarks/comm_scaling.py's sweeps, the same
rows, on ``repro_torch``; every system simulates on the CUDA card unless
``device="cpu"`` asks for the CPU).

Two sweeps:

* ``comm_strong_scaling`` — fixed total work spread over 1..N ranks
  (4 DPUs per rank here, CI-sized), kernel/h2d/d2h/inter-DPU breakdown,
  run once per fabric backend (host-bounce vs hypothetical direct
  PIM-PIM) to quantify the pathfinding speedup.
* ``collective_microbench`` — pure collective times (no kernels) per
  backend, the comm analogue of a bandwidth microbenchmark.

    python -m benchmarks.torch_run --suite comm [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.comm as comm  # noqa: E402
import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402

DPUS_PER_RANK = 4


def _cfg(ranks: int, fabric: str) -> DPUConfig:
    return DPUConfig(n_dpus=ranks * DPUS_PER_RANK, n_ranks=ranks,
                     n_channels=min(ranks, 2), n_tasklets=16,
                     mram_bytes=1 << 21, fabric=fabric)


def _split_scale(scale: float, n_dpus: int, max_dpus: int,
                 base_n: int) -> float:
    """Per-DPU scale for an exactly fixed total: Workload.n_elems rounds
    to 48-element multiples with a 96 floor, so pick a total element
    count divisible by 48*max_dpus and split it — every sweep point then
    runs the identical total work. ``base_n`` is the workload's
    ``default_n``; the +0.5 keeps int(base_n * scale) exact for any
    base, not just powers of two."""
    unit = 48 * max_dpus
    total = max(round(base_n * scale / unit), 2) * unit
    return (total / n_dpus + 0.5) / base_n


def comm_strong_scaling(scale: float, workloads=("BFS", "HST-L"),
                        ranks=(1, 2, 4), device=None) -> List[Dict]:
    rows = []
    max_dpus = max(ranks) * DPUS_PER_RANK
    for name in workloads:
        base_total = None
        for r in ranks:
            inter = {}
            for fabric in ("host", "direct"):
                cfg = _cfg(r, fabric)
                sys_ = PIMSystem(cfg, device=device)
                # BFS's graph is a fixed total; per-DPU workloads split it
                s = (scale if name == "BFS"
                     else _split_scale(scale, cfg.n_dpus, max_dpus,
                                       wl.get(name).default_n))
                wl.get(name).run(sys_, n_threads=16, scale=s)
                t = sys_.timeline
                inter[fabric] = t.inter_dpu
                if fabric == "host" and base_total is None:
                    base_total = t.total
                rows.append({
                    "bench": "comm_scaling", "workload": name,
                    "ranks": r, "dpus": cfg.n_dpus, "fabric": fabric,
                    "total_us": round(t.total * 1e6, 2),
                    "speedup": round(base_total / t.total, 2),
                    "kernel_frac": round(t.breakdown()["kernel"], 3),
                    "h2d_frac": round(t.breakdown()["h2d"], 3),
                    "d2h_frac": round(t.breakdown()["d2h"], 3),
                    "inter_dpu_frac": round(t.breakdown()["inter_dpu"], 3),
                })
            if inter["host"] > 0:
                rows.append({
                    "bench": "comm_scaling", "workload": name, "ranks": r,
                    "fabric": "direct_vs_host",
                    "inter_dpu_speedup": round(
                        inter["host"] / max(inter["direct"], 1e-30), 2)})
    return rows


def collective_microbench(scale: float, ranks=(1, 2, 4),
                          device=None) -> List[Dict]:
    """Pure collective exchange times (no kernel), both backends.

    ``kib`` is the broadcast/allreduce payload; gather and alltoall work
    on per-DPU shards of ``shard_kib`` (``kib`` rounded down to a
    DPU-divisible shard), so compare their columns against that."""
    rows = []
    for r in ranks:
        D = r * DPUS_PER_RANK
        words = max(int(65_536 * scale) // D, 64) * D  # divisible shards
        shard = words // D
        for fabric in ("host", "direct"):
            sys_ = PIMSystem(_cfg(r, fabric), device=device)
            img = np.zeros((D, 2 * words), np.int32)  # alltoall dst tops out at 2*words
            comm.broadcast(sys_, img, 0, words)
            comm.allreduce(sys_, img, 0, words)
            comm.gather(sys_, img, 0, words, shard)
            comm.alltoall(sys_, img, 0, D * shard, shard)
            by = sys_.timeline.by_label("inter_dpu")
            rows.append({"bench": "comm_micro", "ranks": r, "dpus": D,
                         "fabric": fabric, "kib": round(words * 4 / 1024, 1),
                         "shard_kib": round(shard * 4 / 1024, 2),
                         **{k: round(v * 1e6, 3) for k, v in by.items()}})
    return rows
