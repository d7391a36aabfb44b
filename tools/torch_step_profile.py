#!/usr/bin/env python3
"""Where a simulated cycle's time goes on the card (PyTorch/CUDA port).

Runs VA on the full-width system (one rank of 64 DPUs, 16 tasklets,
2 MiB MRAM each, as chip_smoke.py) through ``PIMSystem`` on the card and
records the arguments its launch hands to ``compile_cache.run``.  The
same launch is then set up again with ``compile_cache.prepare``, so the
fused cycle-step kernel and its state are the driver's own, and a window
of K-step blocks is driven as the driver drives it (one launch and one
predicate read a block) twice: once bare (wall µs per simulated step),
once under ``torch.profiler`` tracing the device only.  From that trace
alone it takes the union of the device's kernel and copy intervals over
the span from its first to its last device event: that is the device's
busy share, and the rest, the host's launch and predicate read between
blocks, its idle share.  Prints one JSON line.

    python3 tools/torch_step_profile.py [--blocks 100] [--scale 0.2]

History: before the fused kernel the card replayed each step as
CUDA-graph segments around one ALU launch per issue slot: 0.51-0.575 ms
a step at 64 DPUs, 388 device kernels a step (PERF.md, the findings of
the first three slices of the port).

Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def busy_us(events, lo: float, hi: float) -> float:
    """Length of the union of ``[start, end)`` intervals clipped to
    ``[lo, hi)`` (microseconds)."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in events
                   if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=100,
                    help="K-step blocks in each timed window")
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--dpus", type=int, default=64)
    ap.add_argument("--tasklets", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.kernels.cycle_step.cycle_step import DPUS_PER_BLOCK

    cfg = DPUConfig(n_dpus=args.dpus, n_tasklets=args.tasklets,
                    mram_bytes=1 << 21)
    calls = []
    run = compile_cache.run

    def recording_run(*a, **kw):
        calls.append((a, kw))
        return run(*a, **kw)

    compile_cache.run = recording_run
    try:
        wl.get("VA").run(PIMSystem(cfg, device="cuda"), args.tasklets,
                         scale=args.scale, seed=0)
    finally:
        compile_cache.run = run
    if len(calls) != 1:
        print(f"torch_step_profile: VA made {len(calls)} launches, "
              "expected 1", file=sys.stderr)
        return 1
    a, kw = calls[0]
    prep = compile_cache.prepare(*a, **kw)
    K = compile_cache.STEPS_PER_CHECK

    def blocks(n):
        for _ in range(n):
            prep.advance(K)
            prep.running()          # the driver's one host sync a block

    blocks(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks(args.blocks)
    wall_us = (time.perf_counter() - t0) * 1e6 / (args.blocks * K)

    # device activity only: tracing the host's ops would slow the host
    # that feeds the card, and so stretch the window being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        blocks(args.blocks)
        prof_wall_us = (time.perf_counter() - t0) * 1e6 / (args.blocks * K)

    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        print("torch_step_profile: the trace holds no device event",
              file=sys.stderr)
        return 1
    steps = args.blocks * K
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    span_us = (hi - lo) / steps
    busy = busy_us(spans, lo, hi) / steps

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0]
    top = sorted(kernels, key=dev_us, reverse=True)[:4]
    res = {
        "config": f"VA {cfg.n_dpus} DPUs x {args.tasklets} tasklets "
                  f"scale {args.scale}",
        "dpus_per_block": DPUS_PER_BLOCK,
        "steps_per_block": K, "blocks": args.blocks,
        "wall_us_per_step": wall_us, "steps_per_s": 1e6 / wall_us,
        "profiled_wall_us_per_step": prof_wall_us,
        "device_window_us_per_step": span_us,
        "device_busy_us_per_step": busy,
        "device_events_per_block": len(spans) / args.blocks,
        "device_busy_share": busy / span_us,
        "host_share_per_block": 1 - busy / span_us,
        "top_kernels_us_per_step": {
            e.key[:60]: dev_us(e) / steps for e in top},
        "still_running": prep.running(),
    }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
