#!/usr/bin/env python3
"""Where a simulated cycle's time goes on the card (PyTorch/CUDA port).

Runs VA on the full-width system (one rank of 64 DPUs, 16 tasklets,
2 MiB MRAM each, as chip_smoke.py) through ``PIMSystem`` on the card and
records the arguments its launch hands to ``compile_cache.run``.  The
same launch is then set up again with ``compile_cache.prepare``, so the
step, its CUDA graph and its state are the driver's own, and a window of
steps is timed twice: once bare (wall ms per step), once under
``torch.profiler`` tracing the device only.  From that trace alone it
takes the union of the device's kernel and copy intervals over the span
from its first to its last device event: that is the device's busy
share, and the rest its idle share.  Prints one JSON line.

    python3 tools/torch_step_profile.py [--steps 200] [--scale 0.02]

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
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.02)
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
    if prep.graph is None:
        print("torch_step_profile: the launch ended in its first step",
              file=sys.stderr)
        return 1
    for _ in range(50):
        prep.step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        prep.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # device activity only: tracing the host's ops would slow the host
    # that feeds the card, and so stretch the window being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            prep.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # the window: from the first device event to the last one
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        print("torch_step_profile: the trace holds no device event",
              file=sys.stderr)
        return 1
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    span_ms = (hi - lo) / 1e3 / args.steps
    busy_ms = busy_us(spans, lo, hi) / 1e3 / args.steps

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0]
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    res = {
        "config": f"VA {cfg.n_dpus} DPUs x {args.tasklets} tasklets "
                  f"scale {args.scale}",
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_window_ms_per_step": span_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_kernel_sum_ms_per_step":
            sum(dev_us(e) for e in kernels) / 1e3 / args.steps,
        "device_events_per_step": len(spans) / args.steps,
        "device_busy_share": busy_ms / span_ms,
        "device_idle_share": 1 - busy_ms / span_ms,
        "top_kernels_ms_per_step": {
            e.key[:60]: dev_us(e) / 1e3 / args.steps for e in top},
        "still_running": prep.running(),
    }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
