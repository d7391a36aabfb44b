"""Datacenter-scale PIM pathfinding (the paper's §V at fleet scale), on
the PyTorch/CUDA port (examples/pim_design_sweep.py on ``repro_torch``):
each unit's DPU simulates on the CUDA card, through the ``cycle_step``
kernel, unless ``--device cpu`` asks for the CPU.

The paper sweeps one design point at a time on one machine; here the
(design x workload) grid is over-decomposed into work units and scheduled
onto a simulated worker fleet with the straggler-aware
:class:`WorkRebalancer` — the same structure a 1000-chip sweep uses, with
each TPU chip simulating a slice of the grid (DESIGN.md §3).

    python examples/torch_pim_design_sweep.py [--device cpu]
"""
import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

import repro_torch.workloads as wl
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem
from repro_torch.runtime.coordinator import StepMonitor, WorkRebalancer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)

    designs = {
        "base": {},
        "ilp(D+R)": dict(forwarding=True, unified_rf=True),
        "ilp(D+R+S)": dict(forwarding=True, unified_rf=True, superscalar=2),
        "ilp+700MHz": dict(forwarding=True, unified_rf=True, superscalar=2,
                           freq_mhz=700),
        "bw_x2": dict(mram_bw_scale=2.0),
        "ilp+bw_x2": dict(forwarding=True, unified_rf=True, superscalar=2,
                          mram_bw_scale=2.0),
    }
    workloads = ["VA", "RED", "BS", "TS", "GEMV", "HST-S"]
    units = list(itertools.product(designs, workloads))

    # --- schedule the grid onto the fleet (LPT with observed rates) ---
    est_cost = np.array([2.0 if w in ("TS", "GEMV") else 1.0
                         for _, w in units])
    rates = np.ones(args.workers)
    rates[-1] = 0.5  # one deliberately slow worker (straggler)
    rb = WorkRebalancer(args.workers)
    assignment = rb.assign(est_cost, rates)
    print(f"{len(units)} work units over {args.workers} workers; "
          f"makespan(model) = {rb.makespan(assignment, est_cost, rates):.1f} "
          f"(naive contiguous = "
          f"{rb.makespan([list(range(i, len(units), args.workers)) for i in range(args.workers)], est_cost, rates):.1f})")

    # --- execute (serially here; each unit is one fleet work item) ---
    mon = StepMonitor()
    results = {}
    for w, unit_list in enumerate(assignment):
        for u in unit_list:
            dname, wname = units[u]
            cfg = DPUConfig(n_dpus=1, n_tasklets=16, mram_bytes=1 << 21,
                            **designs[dname])
            t0 = time.time()
            _, rep = wl.get(wname).run(PIMSystem(cfg, device=args.device),
                                    16, scale=args.scale)
            mon.observe(time.time() - t0)
            results[(dname, wname)] = rep.kernel_seconds

    print(f"\n{'design':14s} " + " ".join(f"{w:>7s}" for w in workloads)
          + "   geomean speedup")
    base = np.array([results[("base", w)] for w in workloads])
    for d in designs:
        t = np.array([results[(d, w)] for w in workloads])
        sp = base / t
        print(f"{d:14s} " + " ".join(f"{s:7.2f}" for s in sp)
              + f"   {float(np.exp(np.mean(np.log(sp)))):.2f}x")
    best = max(designs, key=lambda d: np.exp(np.mean(np.log(
        base / np.array([results[(d, w)] for w in workloads])))))
    print(f"\npathfinding verdict: '{best}' wins at iso-workload "
          f"(paper §V-B: ILP features unlock compute-bound PIM workloads)")


if __name__ == "__main__":
    main()
