"""Measured PIM-engine performance on the PyTorch/CUDA port: the twin of
benchmarks/engine_perf.py (the same views, keys and gates, on
``repro_torch``; the engine runs on the CUDA card, through the
``cycle_step`` kernel, unless ``--device cpu`` asks for the CPU).

Torch runs eagerly, so there is no executable to compile: an entry of
:mod:`repro_torch.core.compile_cache` holds the step driver built for
each device it ran on (the step closure and its device-resident isa
tables, ``_Entry.driver``), and ``compile_cache.stats()["misses"]``
counts those builds.  So the reference's XLA compile becomes, here:

* **Launch latency** — *cold* is the first launch of a shape bucket
  after ``compile_cache.clear()``: the driver build, on the card the
  load of the already built ``cycle_step`` library (its layout check and
  the card's limits included), and the run.  The library is built on
  disk and the CUDA context made before the clock starts: nvcc's time is
  ``chip_smoke.py`` [build]'s, not cold's.  *Warm* is a cache hit: the
  same launch again (state to the device, the K-step blocks, the state
  back).  The warm path is the one every iterated workload (BFS levels,
  NW sweeps, SSORT phases, ``launch(dpus=...)`` subsets) actually sees.
* **Subset reuse** — ``launch(dpus=...)`` subsets sharing one
  power-of-two DPU bucket build no new driver (``new_compiles == 0``).
* **Steady state** — simulated cycles per second and KIPS = simulated
  instructions / wall second of a warm run (paper's PIMulator: 3 KIPS,
  single DPU).  ``compile_s`` is the first run's wall less the second's
  when the first missed the cache (0 on a hit): on the card the driver
  build and, at the process's first launch, the library's load.  Each
  row also gives ``steps`` (the driver's steps: K = 64 a launch of the
  kernel, the launch queued past the end not counted) and
  ``steps_per_s``, ``loop_s`` (the wall inside the driver's K-step
  loops, the run's delta of ``compile_cache.stats()["loop_s"]``) and
  ``outside_share`` = 1 - loop_s / run_s: the run's set-up (the state and
  MRAM image to the device and back, the host's work).

The cache counters keep the reference's meaning: one miss per shape
bucket, a hit per relaunch, ``launches`` per driver run; the port's
``stats()`` adds ``steps`` and ``loop_s``.

``--json PATH`` writes the machine-readable report to PATH (nothing is
written without it; the report also names the device and counts the
``cycle_step`` launches of the whole run); ``--check`` gates warm < cold
and ``new_compiles == 0``, ``--min-speedup N`` tightens the first gate.

    python benchmarks/torch_engine_perf.py [--scale 0.3] [--device cpu]
        [--json chiprun_out/engine_perf.json] [--check]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core import compile_cache  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402


def _setup(name: str, scale: float, n_threads: int, mram_bytes=1 << 21,
           **cfg_kw):
    cfg = DPUConfig(n_tasklets=max(n_threads, 16), mram_bytes=mram_bytes,
                    **cfg_kw)
    W = wl.get(name)
    hd = W.host_data(cfg, scale, 0)
    binary = W.build(n_threads).binary(cfg.iram_instrs)
    wram = np.zeros((cfg.n_dpus, 16), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    return cfg, binary, wram, hd.mram


def ready(device=None):
    """The device a run goes to (None: the CUDA card, raising without
    one).  On the card, make the CUDA context and build the
    ``cycle_step`` library on disk (not loaded), so that a cold launch
    times neither."""
    import torch
    device = compile_cache.resolve_device(device)
    if device.type == "cuda":
        from repro_torch.kernels.cycle_step import cycle_step
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        cycle_step.LIB.build()
    return device


def device_info(device) -> dict:
    """What a report ran on: the device type, and on the card its name
    and the count of cards."""
    import torch
    device = compile_cache.resolve_device(device)
    if device.type != "cuda":
        return {"type": device.type}
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()}


def launch_latency(name: str = "VA", scale: float = 0.005, n_dpus: int = 4,
                   n_threads: int = 16, warm_reps: int = 3, device=None,
                   **cfg_kw):
    """Cold (driver build + run) vs. warm (cache hit + run) launch wall
    time.

    Uses a small kernel so launch overhead, not simulated cycles,
    dominates — the launch-heavy pattern of iterated workloads."""
    device = ready(device)
    cfg, binary, wram, mram = _setup(name, scale, n_threads, n_dpus=n_dpus,
                                     mram_bytes=1 << 18, **cfg_kw)
    compile_cache.clear()
    t0 = time.perf_counter()
    out = compile_cache.run(cfg, binary, wram, mram, n_threads,
                            device=device)
    cold_s = time.perf_counter() - t0
    warm = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        out = compile_cache.run(cfg, binary, wram, mram, n_threads,
                                device=device)
        warm.append(time.perf_counter() - t0)
    warm_s = float(np.median(warm))
    cycles = int(np.asarray(out["cycle"]).max())
    issued = int(np.asarray(out["c_issued"]).sum())
    cs = compile_cache.stats()
    assert cs["misses"] == 1, cs  # every relaunch hit the cache
    return {
        "workload": name, "dpus": n_dpus, "threads": n_threads,
        "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
        "speedup": round(cold_s / max(warm_s, 1e-9), 1),
        "cycles": cycles, "issued": issued,
        "warm_kips": round(issued / warm_s / 1e3, 1),
        "warm_cycles_per_s": int(cycles / warm_s),
    }


def subset_reuse(name: str = "VA", scale: float = 0.1, n_dpus: int = 8,
                 n_threads: int = 16, device=None):
    """Warm latency of ``launch(dpus=...)`` subset sizes sharing one
    DPU bucket (one driver build serves them all)."""
    from repro_torch.core.host import PIMSystem
    cfg = DPUConfig(n_tasklets=n_threads, mram_bytes=1 << 18, n_dpus=n_dpus)
    W = wl.get(name)
    hd = W.host_data(cfg, scale, 0)
    binary = W.build(n_threads).binary(cfg.iram_instrs)
    sys_ = PIMSystem(cfg, device=device)
    sys_.launch(name, binary, hd.args, hd.mram, n_threads=n_threads)  # warm
    m0 = compile_cache.stats()["misses"]
    times = {}
    for k in range(n_dpus // 2 + 1, n_dpus + 1):   # all in one pow2 bucket
        t0 = time.perf_counter()
        sys_.launch(name, binary, hd.args, hd.mram, n_threads=n_threads,
                    dpus=list(range(k)))
        times[k] = round(time.perf_counter() - t0, 4)
    return {"workload": name, "dpus": n_dpus,
            "subset_warm_s": times,
            "new_compiles": compile_cache.stats()["misses"] - m0}


def steady_state(name: str, scale: float, n_threads: int = 16, device=None,
                 **cfg_kw):
    """Returns dict(compile_s, run_s, cycles, issued, kips, cps) and the
    warm run's steps, steps_per_s, loop_s and outside_share.

    ``compile_s`` is 0 when the first run was already a cross-kernel
    cache hit (the shared driver cache makes that common)."""
    device = compile_cache.resolve_device(device)
    cfg, binary, wram, mram = _setup(name, scale, n_threads, **cfg_kw)
    misses0 = compile_cache.stats()["misses"]
    t0 = time.perf_counter()
    out = compile_cache.run(cfg, binary, wram, mram, n_threads,
                            device=device)
    t_first = time.perf_counter() - t0
    cold = compile_cache.stats()["misses"] > misses0
    s0 = compile_cache.stats()
    t0 = time.perf_counter()
    out = compile_cache.run(cfg, binary, wram, mram, n_threads,
                            device=device)
    t_run = time.perf_counter() - t0
    s1 = compile_cache.stats()
    steps, loop_s = s1["steps"] - s0["steps"], s1["loop_s"] - s0["loop_s"]
    compile_s = max(0.0, t_first - t_run) if cold else 0.0
    cycles = int(np.asarray(out["cycle"]).max())
    issued = int(np.asarray(out["c_issued"]).sum())
    return {
        "workload": name, "dpus": cfg.n_dpus, "threads": n_threads,
        "compile_s": round(compile_s, 2), "run_s": round(t_run, 3),
        "cycles": cycles, "issued": issued,
        "kips": round(issued / t_run / 1e3, 1),
        "cycles_per_s": int(cycles / t_run),
        "steps": steps, "steps_per_s": steps / t_run,
        "loop_s": loop_s, "outside_share": 1.0 - loop_s / t_run,
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--launch-scale", type=float, default=0.005,
                    help="workload scale for the launch-latency probe "
                    "(small, so launch overhead dominates — the regime "
                    "of iterated kernels, cf. arXiv:2105.03814)")
    ap.add_argument("--json", default="", help="write the report to PATH")
    ap.add_argument("--check", action="store_true",
                    help="fail unless warm relaunch beats cold launch")
    ap.add_argument("--min-speedup", type=float, default=1.0,
                    help="with --check: required cold/warm ratio")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    device = args.device

    print("== launch latency: cold (driver build) vs warm (cache hit) ==")
    lat = launch_latency("VA", args.launch_scale, device=device)
    print(lat)
    print("== subset launches sharing one DPU bucket ==")
    sub = subset_reuse("VA", args.launch_scale, device=device)
    print(sub)
    print("== steady-state engine throughput ==")
    rows = []
    for d in (1, 4, 16, 64):
        r = steady_state("VA", args.scale, n_dpus=d, device=device)
        rows.append(r)
        print(r)
    for skip in (False, True):
        r = steady_state("BS", args.scale, n_dpus=1, event_skip=skip,
                         device=device)
        r["event_skip"] = skip
        rows.append(r)
        print(r)

    from repro_torch.kernels.cycle_step import ops as step_ops
    report = {"launch": lat, "subset_reuse": sub, "steady_state": rows,
              "cache": compile_cache.stats(), "device": device_info(device),
              "launches": {"cycle_step": step_ops.launches}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    if args.check:
        assert lat["warm_s"] < lat["cold_s"], (
            f"warm relaunch {lat['warm_s']}s not faster than cold "
            f"{lat['cold_s']}s")
        assert lat["speedup"] >= args.min_speedup, (
            f"cold/warm speedup {lat['speedup']}x < {args.min_speedup}x")
        assert sub["new_compiles"] == 0, sub
        print(f"CHECK OK: warm {lat['warm_s']}s < cold {lat['cold_s']}s "
              f"({lat['speedup']}x), subset launches compiled nothing new")
    return report


if __name__ == "__main__":
    main()
