"""PIM offload planner: should a memory-bound LM op run on PIM?

Reproduces the paper's motivating scenario (the Facebook quote on
embedding-dominated inference): for GEMV/embedding-gather shapes from the
assigned LM architectures, compare
  * simulated UPMEM-PIM latency (cycle-level, our engine) against
  * a TPU-v5e roofline estimate (bytes / 819 GB/s HBM),
and emit an offload decision per op.

On the PyTorch/CUDA port (examples/pim_offload_planner.py's study on
``repro_torch``): the GEMV systems simulate on the CUDA card, through the
``cycle_step`` kernel, unless ``--device cpu`` asks for the CPU.  The
"TPU(est)" column is the reference's analytic estimate from the TPU
constants that ``repro_torch.launch.roofline`` keeps under their names
(``HBM_BW``, ``PEAK_FLOPS``), so the printed lines are the reference's;
it is no measurement of any device.

    python examples/torch_pim_offload_planner.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.carry import resolve_device  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS  # noqa: E402


def tpu_time(bytes_moved, flops):
    return max(bytes_moved / HBM_BW, flops / PEAK_FLOPS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the GEMV systems (default: the "
                         "CUDA card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # decode-time GEMV: (d_model x d_model) weight, batch-1 activations —
    # the memory-bound primitive PIM targets
    print(f"{'op':34s} {'TPU(est)':>10s} {'PIM(sim)':>10s} "
          f"{'PIM DPUs':>8s} verdict")
    rows = [
        ("gemv d=2048 (qwen3 proj)", 2048),
        ("gemv d=4096 (llama3 proj)", 4096),
    ]
    for name, d in rows:
        # TPU: weight read dominates
        t_tpu = tpu_time(d * d * 2, 2 * d * d)
        # PIM: R=d rows split over DPUs; C=64-wide panels per GEMV kernel
        n_dpus = 16
        cfg = DPUConfig(n_dpus=n_dpus, n_tasklets=16, mram_bytes=1 << 22)
        sys_ = PIMSystem(cfg, device=device)
        _, rep = wl.get("GEMV").run(sys_, 16, scale=d / 2048 / n_dpus)
        panels = d // 64  # GEMV workload uses 64-wide panels
        t_pim = rep.kernel_seconds * panels
        verdict = "PIM" if t_pim < t_tpu else "TPU"
        print(f"{name:34s} {t_tpu*1e6:9.1f}u {t_pim*1e6:9.1f}u "
              f"{n_dpus:8d} {verdict}")

    # embedding gather: tiny compute, pure bandwidth -> per-row DMA on PIM
    for tbl_rows, d in ((1 << 20, 128), (1 << 22, 256)):
        batch = 256
        t_tpu = tpu_time(batch * d * 4, 0)
        # PIM: each lookup = one row DMA (d*4 bytes) on its owning DPU;
        # with B lookups spread over 2560 DPUs, ~1 DMA per DPU
        cfg = DPUConfig()
        dma = cfg.row_miss_overhead + int(np.ceil(d * 4 / cfg.effective_mram_bw))
        t_pim = dma / (cfg.freq_mhz * 1e6)  # parallel across DPUs
        d2h = batch * d * 4 / (cfg.d2h_gbps_per_dpu * 1e9 * 64)
        t_pim_total = t_pim + d2h
        verdict = "PIM" if t_pim_total < t_tpu else "TPU (CPU<->DPU link-bound)"
        print(f"{'embed gather %dx%d b=%d' % (tbl_rows, d, batch):34s} "
              f"{t_tpu*1e6:9.1f}u {t_pim_total*1e6:9.1f}u {'2560':>8s} "
              f"{verdict}")
    print("\nfinding (matches paper §IV-C): PIM kernels win on bandwidth, "
          "but the asymmetric CPU<->DPU link dominates end-to-end — the "
          "paper's case for better host-PIM interconnects.")


if __name__ == "__main__":
    main()
