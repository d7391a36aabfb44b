"""Async command-queue runtime demo: hiding host transfers under kernels.

Two parts:

1. **Raw queue/event API** — submit H2D / LAUNCH / D2H commands on
   explicit streams with event dependencies, then ``sync()`` and print
   the resolved schedule as a small gantt, showing a transfer on the
   channel links running concurrently with a kernel holding the rank
   compute slots.
2. **Double-buffered pipeline** — ``Workload.run_pipelined`` on an
   in-order system (serialized, the PR 2 baseline) vs an async system:
   batch k+1's staging and batch k-1's readback hide under batch k's
   kernel, and the exposed transfer time sinks below kernel time.

On the PyTorch/CUDA port (examples/pim_async_pipeline.py's demo on
``repro_torch``): the systems live on the CUDA card unless ``--device
cpu`` asks for the CPU; part 1 runs no kernel, part 2 simulates VA
through the ``cycle_step`` kernel.

    python examples/torch_pim_async_pipeline.py [--scale 0.02] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.workloads as wl
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem


def queue_api_demo(device=None):
    print("== 1. raw queues + events (2 ranks x 2 channels) ==")
    cfg = DPUConfig(n_dpus=8, n_ranks=2, n_channels=2, mram_bytes=1 << 21)
    sys_ = PIMSystem(cfg, mode="async", device=device)
    MB = 1 << 20

    # stream "xfer": stage the next batch while "compute" runs this one
    with sys_.stream("compute"):
        sys_.h2d(MB, label="stage batch0")
        staged0 = sys_.record_event("batch0 staged")
    with sys_.stream("xfer"):
        sys_.h2d(MB, label="stage batch1")     # overlaps batch0's kernel
    with sys_.stream("compute"):
        sys_.wait_event(staged0)
        # a LAUNCH normally comes from system.launch(); modeled_launch
        # charges a known-duration kernel to keep the demo engine-free
        sys_.modeled_launch("kernel batch0", 0.02)
        kernel0 = sys_.record_event("batch0 kernel done")
    with sys_.stream("xfer"):
        sys_.wait_event(kernel0)
        sys_.d2h(MB, label="drain batch0")

    sched = sys_.sync()
    t = sys_.timeline
    print(f"{'command':>14} {'queue':>8} {'start_ms':>9} {'finish_ms':>10}")
    for it in sorted(sched.items, key=lambda s: (s.start, s.cmd.seq)):
        if it.cmd.seconds == 0:
            continue
        print(f"{it.cmd.label:>14} {it.cmd.queue:>8} "
              f"{it.start * 1e3:>9.2f} {it.finish * 1e3:>10.2f}")
    print(f"serialized sum {t.total * 1e3:.2f} ms vs overlapped makespan "
          f"{t.end_to_end * 1e3:.2f} ms (saved {t.overlap_saved * 1e3:.2f})\n")
    if t.end_to_end >= t.total:
        raise SystemExit("FAIL: async schedule did not overlap anything")


def pipeline_demo(scale: float, n_batches: int, device=None):
    print(f"== 2. double-buffered pipeline, VA x {n_batches} batches "
          f"(scale={scale}) ==")
    rows = []
    for ranks in (1, 2):
        cfg = DPUConfig(n_dpus=4 * ranks, n_ranks=ranks,
                        n_channels=min(ranks, 2), n_tasklets=16,
                        mram_bytes=1 << 21)
        ser = PIMSystem(cfg, device=device)
        wl.get("VA").run_pipelined(ser, 16, n_batches=n_batches, scale=scale)
        pipe = PIMSystem(cfg, mode="async", device=device)
        _, _, sched = wl.get("VA").run_pipelined(pipe, 16,
                                                 n_batches=n_batches,
                                                 scale=scale)
        xfer = pipe.timeline.h2d + pipe.timeline.d2h
        exposed = sched.exposed("kernel")
        rows.append((ranks, ser.timeline.end_to_end, pipe.timeline.end_to_end,
                     pipe.timeline.kernel, xfer, exposed))
    print(f"{'ranks':>5} {'serial_us':>10} {'pipe_us':>9} {'speedup':>8} "
          f"{'kernel_us':>10} {'xfer_us':>8} {'exposed_us':>11}")
    for r, s, p, k, x, e in rows:
        print(f"{r:>5} {s * 1e6:>10.1f} {p * 1e6:>9.1f} {s / p:>8.2f} "
              f"{k * 1e6:>10.1f} {x * 1e6:>8.1f} {e * 1e6:>11.1f}")
    bad = [r for r, s, p, *_ in rows if r >= 2 and p >= s]
    if bad:
        raise SystemExit(f"FAIL: no pipeline speedup at ranks={bad}")
    print("\nPipelined end-to-end beats the serialized baseline; the "
          "exposed (un-hidden) transfer time is far below the raw "
          "transfer total once double-buffered.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    queue_api_demo(args.device)
    pipeline_demo(args.scale, args.batches, args.device)


if __name__ == "__main__":
    main()
