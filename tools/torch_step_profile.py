#!/usr/bin/env python3
"""Where a simulated cycle's time goes on the card (PyTorch/CUDA port).

Runs VA on the full-width system (one rank of 64 DPUs, 16 tasklets,
2 MiB MRAM each, as chip_smoke.py) through ``PIMSystem`` on the card and
records the arguments its launch hands to ``compile_cache.run``.  The
same launch is then set up again with ``compile_cache.prepare`` once for
each resident route of the fused cycle-step kernel (``resident``: WRAM in
device memory; ``resident_smem``: WRAM in shared memory; its driver
re-made on that route by ``StepDriver.like``), so the kernel and its
state are the driver's own, and a window of K-step blocks is
driven on each, in turns (old, new, new, old):

* as the driver drives it: each launch queued before the last one's flag
  is read (``StepDriver.drive``): wall µs per simulated step;
* with the flag read before each launch (the loop before the pipelined
  one): wall µs per simulated step;
* the pipelined window again under ``torch.profiler`` tracing the device
  only: from that trace alone the union of the device's kernel and copy
  intervals over the span from its first to its last device event, the
  device's busy share; the rest, the host's work between blocks, its idle
  share.

``--sections`` instead builds each step kernel with ``-DSTEP_SECTIONS``
(``kernels/step_common.cuh``: each DPU's lane 0 sums ``clock64()`` deltas
per section of a step) and prints the SM cycles a DPU-step of each
section, and a launch's cycles outside the steps (loading the state,
waiting at the launch's vote, storing it back, the rest): ``cycle_step`` on both
resident routes at VA's launch and on ``resident_carry`` at VA's launch
on a full 2,560-DPU system (``--carry-scale``; padded to 4,096, two DPUs
a warp: its swaps are the ``park`` section), ``simt_step`` on both of its
routes at Fig. 11 SIMT+AC's launch (GEMV), and ``crf_step`` on both of
its routes at GEMVS's first full-width command stream (its sections:
fetch and decode, operand reads, compute and writeback, control flow and
counters; the global route's tail launch is not counted).  The build the
step driver and chip_smoke.py use never has the define.  Prints one JSON
line.

    python3 tools/torch_step_profile.py [--blocks 100] [--scale 1.0]
    python3 tools/torch_step_profile.py --sections [--blocks 100]
                                        [--carry-scale 0.05]

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

#: cycle_step's resident routes, old then new
STEP_ROUTES = ("resident", "resident_smem")
#: simt_step's routes, old then new
SIMT_ROUTES = ("global", "resident_smem")
#: crf_step's routes, old then new
CRF_ROUTES = ("global", "resident_smem")
#: crf_step's names for the step sections it marks (step_common.cuh's
#: enum Section, which names a cycle step's)
CRF_SECTIONS = {"plan": "fetch", "dram": "read", "issue": "write",
                "classify": "control"}
#: DPUs of a full UPMEM system (the resident_carry route's profile)
FULL_SYSTEM_DPUS = 2560


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


def record_launch(cfg, workload: str, tasklets: int, scale: float,
                  first: bool = False):
    """The arguments ``workload``'s one launch on a card system of
    ``cfg`` hands to ``compile_cache.run`` (``first``: of its first
    launch, where it makes several)."""
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    from repro_torch.core.host import PIMSystem
    calls = []
    run = compile_cache.run

    def recording_run(*a, **kw):
        calls.append((a, kw))
        return run(*a, **kw)

    compile_cache.run = recording_run
    try:
        wl.get(workload).run(PIMSystem(cfg, device="cuda"), tasklets,
                             scale=scale, seed=0)
    finally:
        compile_cache.run = run
    if len(calls) != 1 and not (first and calls):
        raise SystemExit(f"torch_step_profile: {workload} made {len(calls)} "
                         "launches, expected 1")
    return calls[0]


def profile_route(prep, K: int, blocks: int) -> dict:
    """Wall µs a step of ``blocks`` K-step blocks of ``prep``'s kernel,
    pipelined and flag-first, and the device's busy share of a pipelined
    window (``torch.profiler``, device activity only: tracing the host's
    ops would slow the host that feeds the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kern = prep.kernel

    def pipelined():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = kern.drive(K, limit=blocks)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / (n * K)

    def flag_first():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(blocks):
            kern.launch(K)
            kern.predicate()        # the host waits for each block
        return (time.perf_counter() - t0) * 1e6 / (blocks * K)

    kern.drive(K, limit=5)          # warm
    res = {"pipelined_wall_us_per_step": pipelined(),
           "flag_first_wall_us_per_step": flag_first()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res["profiled_wall_us_per_step"] = pipelined()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        raise SystemExit("torch_step_profile: the trace holds no device "
                         "event")
    steps = blocks * K
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    busy = busy_us(spans, lo, hi) / steps
    res.update(device_window_us_per_step=(hi - lo) / steps,
               device_busy_us_per_step=busy,
               device_events_per_block=len(spans) / blocks,
               device_busy_share=busy * steps / (hi - lo),
               still_running=kern.predicate())
    return res


def sections_of(make_kernel, routes, K: int, blocks: int,
                names=None) -> dict:
    """SM cycles a DPU-step of each section, and a DPU-launch's cycles
    outside its steps, for each route: ``make_kernel(route, buf)`` sets a
    launch up on the profiling build, adding into ``buf``; warm blocks
    first, then ``blocks`` K-step launches counted.  ``names``: the
    kernel's own names of some step sections."""
    import torch
    from repro_torch.kernels.step_driver import SECTIONS
    names = names or {}
    out = {}
    for r in routes:
        buf = torch.zeros(len(SECTIONS), dtype=torch.int64, device="cuda")
        kern = make_kernel(r, buf)
        for _ in range(3):
            kern.run(K)
        torch.cuda.synchronize()
        buf.zero_()
        for _ in range(blocks):
            kern.run(K)
        torch.cuda.synchronize()
        if not kern.predicate():
            raise SystemExit(f"torch_step_profile: the launch ended inside "
                             f"{r}'s window: run a larger --scale")
        acc = {names.get(k, k): v for k, v in zip(SECTIONS, buf.tolist())}
        D = int(kern.st["status"].shape[0])
        # a launch's parts are counted once a warp: a DPU, or on
        # resident_carry the warps that carry DPUs
        leads = D
        if kern.route == "resident_carry":
            from repro_torch.kernels.cycle_step.ops import carry_map
            leads = carry_map(D, kern.args.carry)[0]
        steps, launch = acc.pop("steps"), acc.pop("launch")
        parts = {s: acc.pop(s) for s in ("load", "vote", "store")}
        per_step = {s: v / steps for s, v in acc.items()}
        per_launch = {s: v / (leads * blocks) for s, v in parts.items()}
        per_launch["other"] = (launch - sum(acc.values())
                               - sum(parts.values())) / (leads * blocks)
        out[r] = {"cycles_per_dpu_step": per_step,
                  "step_cycles": sum(per_step.values()),
                  "cycles_per_warp_launch_outside_steps": per_launch,
                  "launch_cycles": launch / (leads * blocks),
                  "dpu_steps_per_launch": steps / blocks, "dpus": D,
                  "warps": leads}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=100,
                    help="K-step blocks in each timed window")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="VA's (and GEMV's) scale: 1.0 runs long enough "
                         "for every window")
    ap.add_argument("--dpus", type=int, default=64)
    ap.add_argument("--tasklets", type=int, default=16)
    ap.add_argument("--sections", action="store_true",
                    help="the per-section cycle split (profiling build)")
    ap.add_argument("--carry-scale", type=float, default=0.05,
                    help="VA's scale on the 2,560-DPU system (--sections)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig

    K = compile_cache.STEPS_PER_CHECK
    cfg = DPUConfig(n_dpus=args.dpus, n_tasklets=args.tasklets,
                    mram_bytes=1 << 21)
    a, kw = record_launch(cfg, "VA", args.tasklets, args.scale)
    res = {"config": f"VA {cfg.n_dpus} DPUs x {args.tasklets} tasklets "
                     f"scale {args.scale}",
           "steps_per_block": K, "blocks": args.blocks,
           "card": torch.cuda.get_device_name(0)}
    if args.sections:
        def step_kernel(route, buf):
            prep = compile_cache.prepare(*a, **kw)
            return prep.kernel.like(prep.st, route, sections=buf)

        res["cycle_step"] = sections_of(step_kernel, STEP_ROUTES, K,
                                        args.blocks)
        # Fig. 11's SIMT+AC design on GEMV (benchmarks/pim_figs.py)
        scfg = cfg.replace(simt_width=16, coalescing=True)
        sa, skw = record_launch(scfg, "GEMV", args.tasklets, args.scale)

        def simt_kernel(route, buf):
            prep = compile_cache.prepare(*sa, **skw)
            return prep.kernel.like(prep.st, route, sections=buf)

        res["simt_config"] = (f"GEMV SIMT+AC {cfg.n_dpus} DPUs x "
                              f"{args.tasklets} tasklets scale {args.scale}")
        res["simt_step"] = sections_of(simt_kernel, SIMT_ROUTES, K,
                                       args.blocks)
        # resident_carry: VA's launch on a full system (two DPUs a warp)
        from repro_torch.kernels.cycle_step import cases
        va = cases.va(FULL_SYSTEM_DPUS, args.carry_scale)

        def carry_kernel(route, buf):
            prep = compile_cache.prepare(*va, device=torch.device("cuda"))
            return prep.kernel.like(prep.st, route, sections=buf)

        res["carry_config"] = (f"VA {FULL_SYSTEM_DPUS} DPUs x 16 tasklets "
                               f"scale {args.carry_scale}")
        res["cycle_step_carry"] = sections_of(
            carry_kernel, ("resident_carry",), K, args.blocks)
        # GEMVS's first command stream on hbmpim_cmd (16 K-blocks)
        ccfg = cfg.replace(backend="hbmpim_cmd")
        ca, ckw = record_launch(ccfg, "GEMVS", args.tasklets, 1.0,
                                first=True)

        def crf_kernel(route, buf):
            prep = compile_cache.prepare(*ca, **ckw)
            return prep.kernel.like(prep.st, route, sections=buf)

        res["crf_config"] = (f"GEMVS hbmpim_cmd {cfg.n_dpus} banks, first "
                             "command stream")
        res["crf_step"] = sections_of(crf_kernel, CRF_ROUTES, K,
                                      min(args.blocks, 10), CRF_SECTIONS)
    else:
        preps = {r: compile_cache.prepare(*a, **kw) for r in STEP_ROUTES}
        for r, prep in preps.items():       # the route asked for
            prep.kernel = prep.kernel.like(prep.st, r)
        turns = {r: [] for r in STEP_ROUTES}
        for r in STEP_ROUTES + STEP_ROUTES[::-1]:
            turns[r].append(profile_route(preps[r], K, args.blocks))
        res["routes"] = {
            r: {k: [t[k] for t in ts] for k in ts[0]}
            for r, ts in turns.items()}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
