"""Pathfinding demo: compare PIM architectures, then sweep the design
space from one recorded trace.

1. **MIMD vs all-bank** — run the streaming GEMVS workload unchanged on
   three execution backends (UPMEM-style scalar, SIMT vector DPU,
   HBM-PIM all-bank) just by setting ``DPUConfig(backend=...)``, and
   print a per-architecture comparison table.
2. **Record once, replay the sweep** — simulate BFS once, record its
   command stream at the submit seam, then re-price it under every
   (fabric, channel-count) combination with ``repro_torch.trace.replay`` —
   no DPU cycles are re-simulated, so each sweep point costs
   milliseconds instead of a full engine run.

On the PyTorch/CUDA port (examples/pim_arch_compare.py's demo on
``repro_torch``): every system simulates on the CUDA card unless
``--device cpu`` asks for the CPU; the scalar DPU through the
``cycle_step`` kernel, the SIMT DPU and the all-bank target through
``simt_step``.

    python examples/torch_pim_arch_compare.py [--scale 0.05] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import trace
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem
from repro_torch.workloads import get


def arch_compare(scale: float, device=None):
    print("== 1. one workload, three architectures (GEMVS, unchanged) ==")
    print(f"{'arch':<14} {'cycles':>9} {'ipc':>7} {'kernel':>12} "
          f"{'end_to_end':>12}")
    for arch, kw in (("mimd-scalar", {}),
                     ("mimd-simt", {"simt_width": 4}),
                     ("hbmpim", {"backend": "hbmpim"})):
        cfg = DPUConfig(n_dpus=8, n_ranks=2, n_channels=2, **kw)
        system = PIMSystem(cfg, device=device)
        _, rep = get("GEMVS").run(system, 8, scale=scale, seed=0)
        print(f"{arch:<14} {rep.cycles:>9d} {rep.ipc:>7.3f} "
              f"{rep.kernel_seconds * 1e3:>10.4f}ms "
              f"{system.timeline.end_to_end * 1e3:>10.4f}ms")


def replay_sweep(scale: float, device=None):
    print("\n== 2. record BFS once, sweep the interconnect via replay ==")
    base = DPUConfig(n_dpus=8, n_ranks=4, n_channels=2)
    t0 = time.perf_counter()
    system = PIMSystem(base, device=device)
    rec = trace.record(system)
    get("BFS").run(system, 8, scale=scale, seed=0)
    system.sync()
    t_live = time.perf_counter() - t0
    print(f"live run: {rec.records and len(rec.records) - 1} records, "
          f"{t_live:.2f}s wall")
    print(f"{'fabric':<8} {'chans':>5} {'inter_dpu':>12} {'end_to_end':>12}")
    for fabric in ("host", "direct", "hier"):
        for channels in (1, 2, 4):
            res = trace.replay(
                rec.records, cfg=base.replace(fabric=fabric,
                                              n_channels=channels))
            print(f"{fabric:<8} {channels:>5d} "
                  f"{res.timeline.inter_dpu * 1e3:>10.4f}ms "
                  f"{res.end_to_end * 1e3:>10.4f}ms")
    # the unchanged config reproduces the live timeline bit-exactly
    res = trace.replay(rec.records)
    assert res.timeline.events == system.timeline.events
    assert res.timeline.elapsed == system.timeline.elapsed
    print("unchanged-config replay: bit-exact vs live timeline")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    arch_compare(args.scale, args.device)
    replay_sweep(args.scale, args.device)


if __name__ == "__main__":
    main()
