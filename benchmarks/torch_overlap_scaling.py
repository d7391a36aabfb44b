"""Transfer/compute overlap scaling: the async analogue of Fig. 10, on the
PyTorch/CUDA port (benchmarks/overlap_scaling.py's sweeps, the same rows,
on ``repro_torch``; every system simulates on the CUDA card unless
``--device cpu`` asks for the CPU).

The paper's end-to-end breakdowns (§V, Fig. 10) show host<->DPU transfer
time rivaling kernel time; real UPMEM deployments hide much of it with
asynchronous per-rank transfers (Gomez-Luna et al., arXiv:2105.03814).
This sweep quantifies what the ``repro_torch.sched`` command-queue runtime
buys: each (workload, ranks) point pipelines ``n_batches`` batches twice
— once on an in-order system (fully serialized, the PR 2 baseline) and
once on an async system (double-buffered streams) — and reports the
end-to-end speedup plus the *exposed* transfer time (makespan minus
kernel busy), which sinks toward zero once staging/readback hide under
neighbouring batches' kernels.

    python benchmarks/torch_overlap_scaling.py [--scale 0.02] [--device cpu]
    python -m benchmarks.torch_run --suite overlap
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402

DPUS_PER_RANK = 4


def _cfg(ranks: int) -> DPUConfig:
    return DPUConfig(n_dpus=ranks * DPUS_PER_RANK, n_ranks=ranks,
                     n_channels=min(ranks, 2), n_tasklets=16,
                     mram_bytes=1 << 21)


def _pipeline(ranks: int, name: str, mode: str, scale: float,
              n_batches: int, buffers: int, device=None):
    sys_ = PIMSystem(_cfg(ranks), mode=mode, device=device)
    _, _, sched = wl.get(name).run_pipelined(sys_, n_threads=16,
                                             n_batches=n_batches,
                                             scale=scale, buffers=buffers)
    return sys_.timeline, sched


def overlap_strong_scaling(scale: float, workloads=("VA", "HST-L"),
                           ranks=(1, 2, 4), n_batches: int = 4,
                           buffers: int = 2, device=None) -> List[Dict]:
    rows = []
    for name in workloads:
        for r in ranks:
            ser, _ = _pipeline(r, name, "inorder", scale, n_batches, buffers,
                               device)
            pipe, sched = _pipeline(r, name, "async", scale, n_batches,
                                    buffers, device)
            xfer = pipe.h2d + pipe.d2h + pipe.inter_dpu
            rows.append({
                "bench": "overlap_scaling", "workload": name, "ranks": r,
                "dpus": r * DPUS_PER_RANK, "batches": n_batches,
                "serialized_us": round(ser.end_to_end * 1e6, 2),
                "pipelined_us": round(pipe.end_to_end * 1e6, 2),
                "speedup": round(ser.end_to_end / pipe.end_to_end, 3),
                "kernel_us": round(pipe.kernel * 1e6, 2),
                "xfer_us": round(xfer * 1e6, 2),
                # non-kernel makespan: transfer time the overlap failed to
                # hide, plus any pipeline stall gaps (so this is an upper
                # bound on exposed transfer, and hidden_frac a lower bound
                # on the hidden share — clamped at 0 when stalls dominate)
                "exposed_xfer_us": round(sched.exposed("kernel") * 1e6, 2),
                "hidden_frac": round(max(0.0, 1 - sched.exposed("kernel")
                                         / max(xfer, 1e-30)), 3),
            })
    return rows


def overlap_depth_sweep(scale: float, name: str = "VA", ranks: int = 2,
                        depths=(1, 2, 3, 4), n_batches: int = 4,
                        device=None) -> List[Dict]:
    """How much prefetch depth (buffer count) matters: ``buffers=1``
    forbids overlap between consecutive batches; 2 is double buffering."""
    rows = []
    base = None
    for b in depths:
        pipe, sched = _pipeline(ranks, name, "async", scale, n_batches, b,
                                device)
        if base is None:
            base = pipe.end_to_end
        rows.append({
            "bench": "overlap_depth", "workload": name, "ranks": ranks,
            "buffers": b, "batches": n_batches,
            "pipelined_us": round(pipe.end_to_end * 1e6, 2),
            "vs_single_buffer": round(base / pipe.end_to_end, 3),
            "exposed_xfer_us": round(sched.exposed("kernel") * 1e6, 2),
        })
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--workloads", nargs="+", default=["VA", "HST-L"])
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)

    rows = overlap_strong_scaling(args.scale, tuple(args.workloads),
                                  tuple(args.ranks), args.batches,
                                  device=args.device)
    hdr = (f"{'workload':>9} {'ranks':>5} {'dpus':>4} {'serial_us':>10} "
           f"{'pipe_us':>10} {'speedup':>7} {'kernel_us':>10} "
           f"{'xfer_us':>9} {'exposed':>8} {'hidden%':>7}")
    print("== double-buffered pipeline vs serialized execution "
          f"(scale={args.scale}, {args.batches} batches) ==")
    print(hdr)
    ok = True
    for row in rows:
        print(f"{row['workload']:>9} {row['ranks']:>5} {row['dpus']:>4} "
              f"{row['serialized_us']:>10.1f} {row['pipelined_us']:>10.1f} "
              f"{row['speedup']:>7.2f} {row['kernel_us']:>10.1f} "
              f"{row['xfer_us']:>9.1f} {row['exposed_xfer_us']:>8.1f} "
              f"{100 * row['hidden_frac']:>6.1f}%")
        if row["ranks"] >= 2 and row["pipelined_us"] >= row["serialized_us"]:
            ok = False
    if not ok:
        raise SystemExit("FAIL: pipelined execution did not beat the "
                         "serialized baseline on a >=2-rank config")
    print("\nAll >=2-rank configurations: pipelined end-to-end time is "
          "strictly below the serialized baseline — host transfers hide "
          "under neighbouring batches' kernels (async analogue of the "
          "paper's Fig. 10 pathfinding study).")


if __name__ == "__main__":
    main()
