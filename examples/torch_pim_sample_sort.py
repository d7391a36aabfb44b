"""Distributed sample sort across the three inter-DPU fabrics.

Runs the SSORT workload (local sort kernel -> splitter gather/broadcast
-> alltoall bucket exchange -> merge kernel) on the same keys under

* ``host``   — today's UPMEM path: every exchanged byte bounces
  DPU -> CPU -> DPU over the asymmetric host links (paper §II-B);
* ``direct`` — the paper's pathfinding hypothesis: a PIM-PIM
  interconnect with per-DPU links;
* ``hier``   — rank-locality pathfinding: a fast intra-rank stage plus
  a cross-rank stage among rank leaders.

The sorted output is validated against ``np.sort`` inside the workload
for every backend (the collectives move identical bytes; only the
charged time differs), and the exchange-time gap quantifies how much an
alltoall-bound workload gains from a real inter-DPU interconnect.  On the
PyTorch/CUDA port (examples/pim_sample_sort.py's study on
``repro_torch``): every system simulates on the CUDA card, through the
``cycle_step`` kernel, unless ``--device cpu`` asks for the CPU.

    python examples/torch_pim_sample_sort.py [--scale 0.05] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--dpus", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--tasklets", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)

    rows = {}
    for fabric in ("host", "direct", "hier"):
        cfg = DPUConfig(n_dpus=args.dpus, n_ranks=args.ranks,
                        n_channels=min(args.ranks, 2),
                        n_tasklets=args.tasklets, mram_bytes=1 << 21,
                        fabric=fabric)
        system = PIMSystem(cfg, device=args.device)
        _, rep = wl.get("SSORT").run(system, n_threads=args.tasklets,
                                     scale=args.scale)
        rows[fabric] = (system.timeline, system.timeline.by_label(
            "inter_dpu"))

    print(f"== SSORT, {args.dpus} DPUs x {args.ranks} ranks "
          f"(scale={args.scale}; oracle-checked on every backend) ==")
    print(f"{'fabric':>7} {'end_to_end_us':>13} {'exchange_us':>12} "
          f"{'alltoall_us':>12} {'gather_us':>10} {'bcast_us':>9}")
    for fabric, (t, by) in rows.items():
        print(f"{fabric:>7} {t.end_to_end * 1e6:>13.1f} "
              f"{t.inter_dpu * 1e6:>12.2f} "
              f"{by.get('alltoall', 0) * 1e6:>12.2f} "
              f"{by.get('gather', 0) * 1e6:>10.2f} "
              f"{by.get('broadcast', 0) * 1e6:>9.2f}")

    host_x = rows["host"][0].inter_dpu
    bad = [f for f in ("direct", "hier") if rows[f][0].inter_dpu >= host_x]
    if bad:
        raise SystemExit(f"FAIL: {bad} did not beat the host bounce on "
                         "the alltoall exchange")
    print("\nBoth pathfinding fabrics beat the host bounce on the "
          "alltoall-bound exchange phase; the hierarchical design "
          "additionally keeps the intra-rank share of the transpose on "
          "fast local links "
          f"(host {host_x * 1e6:.1f} us -> direct "
          f"{rows['direct'][0].inter_dpu * 1e6:.2f} us, hier "
          f"{rows['hier'][0].inter_dpu * 1e6:.2f} us).")


if __name__ == "__main__":
    main()
