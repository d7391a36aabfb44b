"""Reproduce the paper's single-DPU characterization for one workload:
Fig. 5 (utilization), Fig. 6 (latency breakdown), Fig. 7/8 (TLP in space
and time) and Fig. 9 (instruction mix) from ONE simulation per thread
count — the exact methodology of paper §IV.  On the PyTorch/CUDA port
(examples/pim_characterize.py's report on ``repro_torch``): the DPU
simulates on the CUDA card, through the ``cycle_step`` kernel, unless
``--device cpu`` asks for the CPU.

    python examples/torch_pim_characterize.py --workload BS [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

import repro_torch.workloads as wl
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="BS")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)

    W = wl.get(args.workload)
    print(f"== {W.name} (paper Table II workload, scaled x{args.scale}) ==")
    for nt in (1, 2, 4, 8, 16):
        cfg = DPUConfig(n_dpus=1, n_tasklets=16, mram_bytes=1 << 21)
        sys_ = PIMSystem(cfg, device=args.device)
        _, rep = W.run(sys_, n_threads=nt, scale=args.scale)
        b = rep.breakdown
        print(f"threads={nt:2d} cycles={rep.cycles:9,d} "
              f"IPC={rep.ipc:.3f} mramBW={rep.mram_read_bw_util:.3f} | "
              f"active={b['active']:.2f} mem={b['idle_memory']:.2f} "
              f"rev={b['idle_revolver']:.2f} rf={b['idle_rf']:.2f}")
    print("\ninstruction mix (16 threads):")
    for k, v in rep.instr_mix.items():
        print(f"  {k:10s} {v:6.1%}")
    h = rep.hist / max(rep.hist.sum(), 1)
    print(f"\nTLP: avg issuable={rep.avg_issuable:.2f}  "
          f"P(issuable=0)={h[0]:.2%}")
    ts = [t for t in rep.ts[0] if t > 0][:16]
    print("TLP time series (per-window avg):",
          " ".join(f"{t:.1f}" for t in ts))


if __name__ == "__main__":
    main()
