"""Pathfinding case study: what would a direct PIM-PIM fabric buy?

Reproduces the paper's Fig. 10-style strong-scaling experiment on the
repro_torch.comm interconnect model: a fixed BFS problem spread over 1 -> N
ranks, with the end-to-end time broken into kernel / h2d / d2h /
inter-DPU phases. Each configuration runs twice — once with today's
host-bounce path (§II-B) and once with a hypothetical direct PIM-PIM
fabric — moving the exact same bytes, so the inter-DPU columns isolate
the fabric's effect.  On the PyTorch/CUDA port
(examples/pim_comm_pathfind.py's study on ``repro_torch``): every system
simulates on the CUDA card, through the ``cycle_step`` kernel, unless
``--device cpu`` asks for the CPU.

    python examples/torch_pim_comm_pathfind.py [--ranks 1 2 4] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.workloads as wl
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem

DPUS_PER_RANK = 4


def run_one(ranks: int, fabric: str, scale: float, link_gbps: float,
            device=None):
    cfg = DPUConfig(n_dpus=ranks * DPUS_PER_RANK, n_ranks=ranks,
                    n_channels=min(ranks, 2), n_tasklets=16,
                    mram_bytes=1 << 21, fabric=fabric,
                    pim_link_gbps=link_gbps)
    sys_ = PIMSystem(cfg, device=device)
    wl.get("BFS").run(sys_, n_threads=16, scale=scale)
    return sys_.timeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--link-gbps", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)

    print("== BFS strong scaling, fixed graph, 4 DPUs/rank "
          f"(scale={args.scale}, direct link {args.link_gbps} GB/s) ==")
    hdr = (f"{'ranks':>5} {'dpus':>4} {'fabric':>6} {'total_us':>9} "
           f"{'kernel%':>8} {'h2d%':>6} {'d2h%':>6} {'inter%':>7} "
           f"{'inter_us':>9} {'speedup':>8}")
    print(hdr)
    base_total = None
    ok = True
    for r in args.ranks:
        inter = {}
        for fabric in ("host", "direct"):
            t = run_one(r, fabric, args.scale, args.link_gbps, args.device)
            inter[fabric] = t.inter_dpu
            if base_total is None:
                base_total = t.total
            b = t.breakdown()
            print(f"{r:>5} {r * DPUS_PER_RANK:>4} {fabric:>6} "
                  f"{t.total * 1e6:>9.1f} {100 * b['kernel']:>7.1f}% "
                  f"{100 * b['h2d']:>5.1f}% {100 * b['d2h']:>5.1f}% "
                  f"{100 * b['inter_dpu']:>6.1f}% {t.inter_dpu * 1e6:>9.1f} "
                  f"{base_total / t.total:>8.2f}")
        if inter["direct"] >= inter["host"]:
            ok = False
        print(f"      -> direct fabric cuts inter-DPU time "
              f"{inter['host'] * 1e6:.1f}us -> {inter['direct'] * 1e6:.1f}us "
              f"({inter['host'] / max(inter['direct'], 1e-30):.1f}x) "
              f"at equal data volume")
    if not ok:
        raise SystemExit("FAIL: direct fabric did not beat host-bounce")
    print("\nAll configurations: direct PIM-PIM fabric strictly reduces "
          "inter-DPU time vs the host-bounce path (paper's pathfinding "
          "argument for inter-PIM communication support).")


if __name__ == "__main__":
    main()
