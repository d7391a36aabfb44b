#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--scale S]

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every CUDA kernel (alu_exec, cycle_step,
             simt_step, crf_step, flash_attention's scalar and tensor-core
             kernels, ssd_scan's scalar and tensor-core kernels; sm_90a)
             from the sources in the checkout, all eight libraries at
             once, into build/repro_torch/; the registers and spills
             (ptxas -v) of cycle_step, simt_step, crf_step and of the
             tensor-core SSD kernels are logged; the
             tensor-core flash kernel's SASS (cuobjdump) must hold HGMMA
             (wgmma) in every instance, the tensor-core SSD kernels' HMMA
             (mma.sync);
2. kernels — each kernel against its plain-torch version on the card: the
             ALU bitwise (tolerance 0); flash attention at the cases of
             tests/test_kernels.py (f32 2e-5 on the scalar kernel, bf16
             1e-2 on the tensor-core one), at shapes that stress the
             tensor-core kernel's tiling and at llama3-8b's prefill shape;
             the SSD scan's scalar kernel at its test cases and at
             mamba2-130m's prefill shape (f32 2e-4, bf16 1e-2), its
             tensor-core route at the card tests' shapes and at that
             prefill shape (bf16 1e-2);
3. step    — the fused cycle-step kernel against the eager card step (its
             plain version), every state leaf bitwise after 1, 7 and all
             steps, 64 steps a launch, on every knob case of
             repro_torch/kernels/cycle_step/cases.py (the case studies'
             branches, 24 and 32 tasklets, 4 and 8 issue slots, 40 DPUs
             across blocks, the cache-mode VA) on each of its four
             routes (resident_smem, resident, resident_carry, stepwise),
             cross_dpu at the resident_smem route's limit unpadded (every
             block of the card resident: 396 DPUs on an H100) on that
             route; above the resident limit L (one DPU past it, and a
             full 2,560-DPU system, both padded to 4,096) cross_dpu and
             a whole VA launch (scale 0.02, 16 tasklets) at 2,560 DPUs on
             resident_carry (two DPUs a warp) and on stepwise, and
             cross_dpu unpadded at 2L and 2L + 1 (three DPUs a warp) on
             resident_carry; µs a step on cross_dpu at 2,048 (resident)
             and at 2,560, and on VA's launch at 2,560, the two routes
             above the limit in turns;
4. golden  — VA on 4 DPUs (2 ranks, 2 channels), 8 tasklets, scale 0.02,
             seed 0 must give the JAX package's pre-refactor golden
             (tests/test_backend.py) exactly, through cycle_step;
5. full    — one UPMEM rank of 64 DPUs, 16 tasklets, 2 MiB MRAM each
             (benchmarks/pim_figs.py simulation-rate study): (a) at scale
             0.02 the card (cycle_step) and the CPU give identical
             KernelReport and Timeline; (b) VA at --scale (the simulator's
             main path) passes its numpy oracle with one counted
             cycle_step launch per 64-step block (the driver queues the
             next block before it reads the last one's flag; the one
             launch queued past the end, in which no DPU runs, is
             counted apart as idle) and no alu_exec launch; cycle_step's ms per 64-step launch there on
             its two resident routes in turns (global-WRAM and
             shared-memory WRAM: the main path's must be the faster),
             their registers, shared memory and spills, beside the eager
             card step's;
6. workloads — every workload of repro_torch.workloads (all 18) on the
             card through cycle_step: (a) at the two golden configurations
             of repro_torch/workloads/goldens.py (4 DPUs x 8 tasklets and
             64 x 16, scale 0.02) and the remap scenario (HST-S, one DPU
             killed), each equal to the JAX package's goldens.json
             exactly; (b) at full width (64 DPUs x 16 tasklets, scale
             1.0), each held by its own numpy oracle, with its wall, KIPS,
             steps per second, launches and the share of the wall outside
             the driver's cycle_step loops;
7. simt    — the SIMT engine and the HBM-PIM targets (case study #1,
             Fig. 11): (a) simt_step (on both of its routes) and crf_step
             (on both of its: resident_smem, the image and rows staged in
             shared memory, and global) against their plain versions
             (the eager card steps), every leaf bitwise after 1, 7 and
             all steps, on every case of
             repro_torch/kernels/simt_step/cases.py (64 steps a launch)
             and crf_step/cases.py (8 commands a launch); (b) every entry
             of goldens.json's s4, s4ac, h4, c4 and fig11/*
             configurations (a capped run must raise the golden's error
             from the golden's capped state);
             (c) at full width (64 DPUs x 16 tasklets, 2 MiB MRAM), each
             under its numpy oracle with its wall, KIPS, steps per second,
             kernel launches and set-up share: Fig. 11's five designs on
             GEMV at scale 1.0 (the launches of simt_step counted over
             them), GEMVS on hbmpim_cmd at scale 1.0 (crf_step's, all on
             resident_smem), BFS on hbmpim, SSORT on hbmpim (32 DPUs,
             scale 0.375); (d) at each kernel's path's launch (Fig. 11
             SIMT+AC's; GEMVS's first command stream): one 64-step launch
             of each route bitwise against 64 eager card steps from the
             same state, every leaf, then its ms per launch (the two
             routes in turns, the path's the faster) beside the eager
             card step's and its bytes bound (the leaves the kernel
             touches and the words it moves);
8. lm      — (a) card vs CPU: llama3-8b and mamba2-130m at full width and
             2 layers in float32 (TF32 off), one 384-token prompt (two
             SSD chunks, the second ragged): prefill logits and caches
             agree within 1e-3; (b) the LM serving path
             at full width and depth in bf16: prefill of 4 prompts (1024
             tokens for llama3-8b, 2048 for mamba2-130m), 32 greedy
             decode steps, and a ServeEngine answering 4 requests, with
             every flash / SSD call counted as a launch (all 32 llama3-8b
             prefill launches on the tensor-core flash kernel, all 24
             mamba2-130m prefill scans on the tensor-core SSD route);
9. system  — the reference's full-system cell (src/repro/launch/
             dryrun.py run_pim_cell: 2,560 DPUs, 16 tasklets, 1 MiB MRAM,
             VA at scale 1.0, seed 0) through PIMSystem on the card, on
             resident_carry, under VA's oracle, with its wall, cycles,
             issued, KIPS, steps per second and set-up share, its cycles
             beside the same configuration's on 64 DPUs; then BFS (6
             launches and collectives) at 2,560 DPUs on resident_carry
             and on stepwise: state, KernelReport and Timeline equal;
10. cluster — the cluster, admission and trace stack: (a)
             benchmarks/cluster_load.py's system (8 ranks x 4 DPUs) with
             measured profiles (BFS, HST-S, SSORT on a 4-DPU, 8-tasklet
             rank at scale 0.05, through cycle_step under their oracles),
             both policies at 0 and 2% faults: profiles and reports equal
             to goldens.json's cluster goldens exactly; (b) 8 ranks x 32
             DPUs, profiles of a 32-DPU rank at scale 0.375 (each kind's
             wall, cycle_step launches and set-up share), the report equal
             between inorder and async, across two runs and after a
             journaled run killed and resumed, both policies' scorecards,
             benchmarks/torch_cluster_load.py's gate; (c) BFS at full
             width recorded, saved as JSONL, loaded and replayed: the
             Timeline equal bitwise, a what-if replay; every workload's
             g4 recording of [workloads] (a) replayed equal to its golden
             Timeline; (d) in [lm], on the loaded llama3-8b: a ServeEngine
             whose PIM pool is a 2-rank lease of examples/serve_lm.py's
             cluster gives the pool-free tokens, one decode launch a tick;
             the lease's DPUs disabled mid-stream: decoded on the host,
             no request lost;
11. report — the kernels line (launches, times, bounds; each step
             kernel's routes), the card's name and power limit, and the
             result line.

Imports neither JAX nor the JAX package: the card's machine has no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: tests/test_backend.py GOLDENS["VA-scalar"], captured on the JAX package
GOLDEN_VA = {"cycles": 5336, "issued": 11488,
             "total": 4.131521235521236e-05, "kernel": 1.5245714285714286e-05}

#: NVIDIA H100 SXM data sheet: HBM3 rate, the 32-bit non-tensor rate
#: (67 TFLOP/s float32; the guide's table lists no separate int32 rate)
#: and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
SCALAR32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

INT_MIN, INT_MAX = -2**31, 2**31 - 1
ALU_EDGE = [(9, INT_MIN, -1), (9, 5, 0), (5, 1, 33), (7, -8, 1), (8, 2**30, 2),
            (9, INT_MIN, 1), (9, 0, 0), (9, INT_MAX, -1), (5, 1, 32),
            (5, 3, -1), (6, -8, 1), (6, -1, 32), (6, -1, -31), (7, INT_MIN, 31),
            (7, -1, 64), (11, -1, 3), (10, -1, 3), (0, INT_MAX, 1),
            (1, INT_MIN, 1), (8, INT_MIN, -1), (-1, 5, 1), (12, 6, 2),
            (30, 9, 5)]


class SmokeError(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeError(msg)


def log(msg: str):
    print(msg, flush=True)


def _counters():
    """name -> (module, attribute) of each launch count: flash_attention
    counts both flash kernels, flash_attention_sm90 the tensor-core one;
    ssd_scan both SSD routes, ssd_scan_tc the tensor-core one."""
    from repro_torch.kernels.alu_exec import ops as alu_ops
    from repro_torch.kernels.crf_step import ops as crf_ops
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.simt_step import ops as simt_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"alu_exec": (alu_ops, "launches"),
            "cycle_step": (step_ops, "launches"),
            "simt_step": (simt_ops, "launches"),
            "crf_step": (crf_ops, "launches"),
            "flash_attention": (flash_ops, "launches"),
            "flash_attention_sm90": (flash_ops, "launches_sm90"),
            "ssd_scan": (ssd_ops, "launches"),
            "ssd_scan_tc": (ssd_ops, "launches_tc")}


#: the kernels driven by the pipelined K-block loop, which also count the
#: launches it queued past a run's end (``idle_launches``: counted in
#: ``launches`` as well; no DPU runs in them)
PIPELINED = ("cycle_step", "simt_step", "crf_step")


def reset_launches():
    """Set every kernel's launch count, and the pipelined kernels' counts
    of idle launches, to 0 (just before a path runs)."""
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    for name in PIPELINED:
        _counters()[name][0].idle_launches = 0


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def read_idle() -> dict:
    """Each pipelined kernel's launches queued past a run's end."""
    return {name: _counters()[name][0].idle_launches for name in PIPELINED}


def cuda_time_ms(fn, n: int = 1000, warm: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` issued back to back from the
    host (CUDA events): for a small kernel, this is the host's cost."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def graph_time_ms(fn, n: int = 200, reps: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``n`` calls captured
    in one CUDA graph, replayed ``reps`` times between CUDA events, so
    the host's dispatch is out of the measurement."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _sass_functions(lib, cuobjdump) -> dict:
    """Kernel name -> its SASS text, from the library's cuobjdump."""
    sass = subprocess.run([str(cuobjdump), "--dump-sass", lib._name],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    return {f.split("\n", 1)[0].strip(): f
            for f in sass.stdout.split("Function : ")[1:]}


def _ptxas_report(lib) -> dict:
    """Kernel (entry function) -> (registers, spill stores, spill loads,
    static shared memory bytes) from the library's ptxas -v build log."""
    import re
    from repro_torch.kernels import build
    log = build.build_log(lib)
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", part)
        smem = re.search(r"(\d+) bytes smem", part)
        check(regs and spills, f"no ptxas -v report for {part[:200]!r}")
        out[part.split("'", 1)[0]] = (int(regs.group(1)),
                                      int(spills.group(1)),
                                      int(spills.group(2)),
                                      int(smem.group(1)) if smem else 0)
    check(out, f"no ptxas -v report in the build log: {log[-1000:]!r}")
    return out


def phase_build() -> float:
    """Build the eight kernel libraries concurrently (one nvcc each), log
    the registers and spills of cycle_step, simt_step, crf_step and of
    the tensor-core SSD kernels, then check that every instance of the tensor-core flash
    kernel runs its products on wgmma (HGMMA in its SASS) and every
    instance of the tensor-core SSD kernels on mma.sync (HMMA)."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.alu_exec import alu_exec
    from repro_torch.kernels.crf_step import crf_step
    from repro_torch.kernels.cycle_step import cycle_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.simt_step import simt_step
    from repro_torch.kernels.ssd_scan import ssd_scan
    libs = {"alu_exec": alu_exec.library,
            "cycle_step": cycle_step.library,
            "simt_step": simt_step.library,
            "crf_step": crf_step.library,
            "flash_attention": flash_attention.library,
            "flash_attention_sm90": flash_attention.library_sm90,
            "ssd_scan": ssd_scan.library,
            "ssd_scan_tc": ssd_scan.library_tc}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in libs.items()}
        built = {name: f.result()   # raises the build's error, if any
                 for name, f in futures.items()}
    secs = time.perf_counter() - t0
    log(f"[build] {', '.join(libs)}: built and loaded in {secs:.2f} s "
        f"-> {build.build_dir()}")
    for lib in ("cycle_step", "simt_step", "crf_step"):
        for name, (regs, stores, loads, _) in sorted(
                _ptxas_report(built[lib]).items()):
            kernel = re.search(r"\d((cycle|simt|crf)_\w+?_kernel)", name)
            log(f"[build] {kernel.group(1) if kernel else name} (ptxas -v): "
                f"{regs} registers, spill stores {stores} B, spill loads "
                f"{loads} B")
    tc = _ptxas_report(built["ssd_scan_tc"]).values()
    log(f"[build] ssd_scan_tc (ptxas -v, {len(tc)} kernels): registers "
        f"{min(t[0] for t in tc)}-{max(t[0] for t in tc)}, spill "
        f"stores up to {max(t[1] for t in tc)} B, spill loads up to "
        f"{max(t[2] for t in tc)} B")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    funcs = _sass_functions(built["flash_attention_sm90"], cuobjdump)
    hgmma = [f.count("HGMMA") for k, f in funcs.items()
             if "flash_sm90_kernel" in k]
    check(hgmma and min(hgmma) > 0,
          f"flash_attention_sm90: {len(hgmma)} kernel instances, HGMMA "
          f"counts {hgmma}: the products are not on wgmma")
    log(f"[build] flash_attention_sm90 SASS: {len(hgmma)} kernel "
        f"instances, each with HGMMA ({min(hgmma)}-{max(hgmma)} a "
        "instance)")
    funcs = _sass_functions(built["ssd_scan_tc"], cuobjdump)
    hmma = [f.count("HMMA") for k, f in funcs.items()
            if "ssd_chunk_state" in k or "ssd_chunk_scan" in k]
    check(hmma and min(hmma) > 0,
          f"ssd_scan_tc: {len(hmma)} chunk-state/chunk-scan instances, HMMA "
          f"counts {hmma}: the products are not on the tensor cores")
    log(f"[build] ssd_scan_tc SASS: {len(hmma)} chunk-state and chunk-scan "
        f"instances, each with HMMA ({min(hmma)}-{max(hmma)} an instance)")
    return secs


def _alu_inputs(n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    op = rng.integers(-2, 14, n).astype(np.int32)
    a = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b[::7] = rng.integers(-40, 40, b[::7].shape)
    return op, a, b


def phase_kernels() -> int:
    """ALU kernel vs its plain version on the card; returns max |err|."""
    import numpy as np
    import torch
    from repro_torch.kernels.alu_exec import ops
    from repro_torch.kernels.alu_exec.ref import alu_exec_ref
    cases = [("edge", tuple(np.asarray(c, np.int32) for c in zip(*ALU_EDGE)))]
    cases += [(f"random N={n}", _alu_inputs(n, n))
              for n in (1, 127, 64, 1 << 20)]
    # the engine's own shape at full width: (D, 1) columns, D = 64
    cases.append(("main-path shape (64, 1)",
                  tuple(x.reshape(64, 1) for x in _alu_inputs(64, 11))))
    worst = 0
    for name, case in cases:
        op, a, b = (torch.from_numpy(x).cuda() for x in case)
        got = ops.alu_exec(op, a, b)
        want = alu_exec_ref(op, a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(torch.equal(got, want), f"alu_exec kernel != plain ({name}): "
              f"max |err| {err}")
        worst = max(worst, err)
        log(f"[kernels] alu_exec {name}: bitwise equal")
    return worst


#: DPUs of a full UPMEM system (20 DIMMs x 2 ranks x 64): above the
#: resident limit, padded to 4,096
FULL_SYSTEM_DPUS = 2560
#: VA's scale in [step]'s whole-workload launch at FULL_SYSTEM_DPUS
VA_STEP_SCALE = 0.02


#: cycle_step's routes, in the order the picker prefers them
STEP_ROUTES = ("resident_smem", "resident", "resident_carry", "stepwise")
#: the routes above the resident limit: the picker's, then the yardstick
ABOVE = ("resident_carry", "stepwise")


def phase_step() -> dict:
    """cycle_step against the eager card step, 64 steps a launch
    (cases.hold_against_plain: bitwise after 1, 7 and all steps): every
    knob case on each of the four routes (one plain run, a kernel driver
    a route), cross_dpu at the resident_smem route's limit, unpadded, on
    that route, cross_dpu one DPU above the resident limit L and at a
    full 2,560-DPU system and VA's launch at 2,560 on resident_carry and
    stepwise, and cross_dpu unpadded at 2L and 2L + 1 on resident_carry
    (the picker's route for each); returns the cases' total steps and
    launches and the routes' times."""
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.kernels.cycle_step.cycle_step import (card_limits,
                                                           max_dpus)
    limit = max_dpus(4)
    cfg = cases.launch("cross_dpu", 1)[0]
    smem_limit = step_ops.smem_dpus(4, cfg.wram_words,
                                    card_limits(4), cfg.atomic_bits)
    runs = [(name, None, STEP_ROUTES, None)
            for name in sorted(cases.CASES) + ["cache_va"]]
    runs += [("cross_dpu", smem_limit, ("resident_smem",), smem_limit),
             ("cross_dpu", limit + 1, ABOVE, None),
             ("cross_dpu", FULL_SYSTEM_DPUS, ABOVE, None),
             ("cross_dpu", 2 * limit, ("resident_carry",), 2 * limit),
             ("cross_dpu", 2 * limit + 1, ("resident_carry",),
              2 * limit + 1),
             ("va", FULL_SYSTEM_DPUS, ABOVE, None)]
    total = {"cases": 0, "steps": 0, "launches": 0, "max_abs_err": None}
    t0 = time.perf_counter()
    for name, n_dpus, routes, dpus in runs:
        t1 = time.perf_counter()
        if name == "cache_va":
            case = cases.cache_va()
        elif name == "va":              # a whole workload launch
            case = cases.va(n_dpus, VA_STEP_SCALE)
        else:
            case = cases.launch(name, n_dpus)
        try:
            res = cases.hold_against_plain(
                case, 64, device="cuda", dpus=dpus,
                routes=None if len(routes) == 1 else routes)
        except AssertionError as e:
            raise SmokeError(f"cycle_step != eager card step on {name} "
                             f"({case[0].n_dpus} DPUs): {e}")
        check(res["alu_launches"] == 0,
              f"{name}: {res['alu_launches']} alu_exec launches in cycle_step")
        check(tuple(res["routes"]) == routes, f"{name} ({case[0].n_dpus} "
              f"DPUs) took the {res['routes']} routes, not {routes}")
        log(f"[step] {name} ({dpus or case[0].n_dpus} DPUs x {case[4]} "
            f"tasklets, "
            f"{'/'.join(routes)}): bitwise equal after 1, 7 and "
            f"{res['steps']} steps, {res['launches']} launches a route "
            f"({time.perf_counter() - t1:.1f} s)")
        total["cases"] += 1
        total["steps"] += res["steps"]
        total["launches"] += res["launches"]
    total["max_abs_err"] = 0               # every leaf of every case equal
    log(f"[step] {total['cases']} cases bitwise equal "
        f"({time.perf_counter() - t0:.1f} s)")
    total["max_dpus"] = {T: max_dpus(T) for T in (4, 16, 24)}
    total["carry"] = {D: step_ops.carry_factor(D, 4, card_limits(4))
                      for D in (limit + 1, 4096, 2 * limit, 2 * limit + 1)}
    log(f"[step] the resident route takes at most {total['max_dpus']} DPUs "
        f"(by tasklets) on this card: every block resident; above it "
        f"resident_carry, DPUs a warp (at 4 tasklets, by DPUs): "
        f"{total['carry']}")
    total["us_per_step"] = {
        2048: _route_step_us(cases.launch("cross_dpu", 2048),
                             "cross_dpu at 2048 DPUs", ("resident",)),
        FULL_SYSTEM_DPUS: _route_step_us(
            cases.launch("cross_dpu", FULL_SYSTEM_DPUS),
            f"cross_dpu at {FULL_SYSTEM_DPUS} DPUs", ABOVE)}
    total["va_us_per_step"] = _route_step_us(
        cases.va(FULL_SYSTEM_DPUS, VA_STEP_SCALE),
        f"VA (scale {VA_STEP_SCALE}) at {FULL_SYSTEM_DPUS} DPUs", ABOVE)
    return total


def _launch_bytes(cfg, st, before, cls0, cycles0, n) -> float:
    """The bytes a cycle_step launch must move (PERF.md row 1a's count),
    a mean over the ``n`` launches since ``before`` (the counters' sums),
    ``cls0`` (c_cls's) and ``cycles0`` (each DPU's cycle): every
    per-tasklet and per-DPU leaf (registers, scalars, counters) read once
    and written once, and of the rest only what the launches touch: the
    DMA'd words (read from one memory, written to the other), LW/SW
    words, one atomic word read and written per sync instruction, one
    ts_buf word per time-series window closed.  The TLB and D$ must be
    off."""
    import torch
    from repro_torch.core.isa import CLS_LDST, CLS_SYNC
    check(not cfg.mmu and not cfg.cache_mode,
          "the bound counts no TLB or D$ traffic")
    delta = {k: (st[k].double().sum().item() - v) / n
             for k, v in before.items()}
    cls = (st["c_cls"].double().sum(0) - cls0) / n
    win = cfg.timeseries_window
    windows = ((torch.div(st["cycle"], win, rounding_mode="floor")
                - torch.div(cycles0, win, rounding_mode="floor"))
               .double().sum().item() / n)
    untouched = ("wram", "mram", "atomic", "ts_buf", "tlb_tags", "tlb_lru",
                 "dc_tags", "dc_lru", "dc_dirty")
    small = sum(v.numel() * v.element_size() for k, v in st.items()
                if k not in untouched)
    dma = delta["c_dma_rd_bytes"] + delta["c_dma_wr_bytes"]
    ldst, sync = cls[CLS_LDST].item(), cls[CLS_SYNC].item()
    return {"bytes": 2 * small + 2 * dma + 4 * ldst + 8 * sync + 4 * windows,
            "state_bytes": small, "dma_bytes": dma, "ldst": ldst,
            "sync": sync, "windows": windows,
            "issued": delta["c_issued"]}


def _counters_of(st):
    return ({k: st[k].double().sum().item()
             for k in ("c_issued", "c_dma_rd_bytes", "c_dma_wr_bytes")},
            st["c_cls"].double().sum(0), st["cycle"].clone())


def _route_step_us(case, label: str, routes, blocks: int = 2) -> dict:
    """µs a step of each of cycle_step's ``routes`` for the launch
    ``case`` (set up as the step driver sets it up, a state for each route):
    windows of ``blocks`` raw 64-step launches between CUDA events in
    turns (a, b, b, a) while some DPU still runs (cross_dpu runs ~300
    steps);
    the first route's the result, with its bytes bound over its timed
    launches and the eager card step (its plain version) on a copy of its
    state."""
    import torch
    from repro_torch.core import compile_cache
    cfg, binary, wram, mram, T = case
    K = compile_cache.STEPS_PER_CHECK
    preps = {}
    for r in routes:
        preps[r] = compile_cache.prepare(cfg, binary, wram, mram, T,
                                         device=torch.device("cuda"))
        preps[r].kernel = preps[r].kernel.like(preps[r].st, r)
    torch.cuda.synchronize()
    first = preps[routes[0]]
    before, cls0, cycles0 = _counters_of(first.st)
    turns = _in_turns({r: p.kernel for r, p in preps.items()}, K, blocks)
    work = _launch_bytes(first.kernel.cfg, first.st, before, cls0, cycles0,
                         2 * blocks)
    plain = {k: v.clone() for k, v in first.st.items()}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(K):
        plain.update(first.step_fn(first.ir, plain))
    t1.record()
    torch.cuda.synchronize()
    ms = turns[routes[0]]["ms"]
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = work["issued"] / SCALAR32_OPS_PER_S
    res = {"route": routes[0], "dpus": int(first.st["status"].shape[0]),
           "ms": ms, "us_per_step": ms * 1e3 / K,
           "plain_ms": t0.elapsed_time(t1),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_per_launch": work["bytes"],
           "issued_per_launch": work["issued"],
           "routes": {r: dict(t, us_per_step=t["ms"] * 1e3 / K)
                      for r, t in turns.items()}}
    log(f"[step] cycle_step {label}: " + json.dumps(res))
    return res


def _system(cfg, device):
    from repro_torch.core.host import PIMSystem
    return PIMSystem(cfg, device=device)


def _va(system, n_threads, scale, seed=0):
    import repro_torch.workloads as wl
    return wl.get("VA").run(system, n_threads, scale=scale, seed=seed)


def phase_golden():
    from repro_torch.core.config import DPUConfig
    system = _system(DPUConfig(n_dpus=4, n_ranks=2, n_channels=2), "cuda")
    t0 = time.perf_counter()
    _, rep = _va(system, 8, 0.02)
    got = {"cycles": rep.cycles, "issued": rep.issued,
           "total": system.timeline.total, "kernel": system.timeline.kernel}
    check(got == GOLDEN_VA, f"VA golden on cuda: {got} != {GOLDEN_VA}")
    log(f"[golden] VA 4 DPUs x 8 tasklets scale 0.02 on cuda: {got} "
        f"(exact, {time.perf_counter() - t0:.1f} s)")


def _full_cfg():
    from repro_torch.core.config import DPUConfig
    # benchmarks/pim_figs.py _cfg + simulation_rate: one rank of 64 DPUs
    return DPUConfig(n_dpus=64, n_tasklets=16, mram_bytes=1 << 21)


def _same_report(a, b) -> list:
    import dataclasses
    import numpy as np
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = (np.array_equal(x, y) and np.asarray(x).dtype
                == np.asarray(y).dtype) if isinstance(x, np.ndarray) \
            else x == y
        if not same:
            bad.append(f.name)
    return bad


def _same_timeline(a, b) -> list:
    names = ("h2d", "kernel", "d2h", "inter_dpu", "retry", "shed", "events",
             "elapsed", "total")
    return [n for n in names if getattr(a, n) != getattr(b, n)]


def phase_full_parity() -> dict:
    """(a) 64 DPUs x 16 tasklets at scale 0.02: the card (cold, then
    warm) == the CPU, with the launch seconds and steps per second of
    each run."""
    import torch
    from repro_torch.core import compile_cache
    cfg = _full_cfg()
    out = {}
    runs = {}
    for tag, dev in (("cold", "cuda"), ("cpu", "cpu"), ("warm", "cuda")):
        system = _system(cfg, dev)
        steps0 = compile_cache.stats()["steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = _va(system, 16, 0.02)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = compile_cache.stats()["steps"] - steps0
        out[f"{tag}_s"] = secs
        out[f"{tag}_steps_per_s"] = steps / secs
        runs[tag] = (rep, system.timeline)
    rp, tp = runs["cpu"]
    for tag in ("cold", "warm"):
        rc, tc = runs[tag]
        bad = _same_report(rc, rp) + _same_timeline(tc, tp)
        check(not bad, f"64-DPU scale-0.02 run differs, cuda ({tag}) vs "
              f"cpu, in {bad}")
    log(f"[full] 64 DPUs x 16 tasklets scale 0.02: cuda (cold, warm) "
        f"== cpu (KernelReport, Timeline); cycles {rp.cycles}, issued "
        f"{rp.issued}; " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def phase_main_path(scale: float) -> dict:
    """(b) the main path: VA at ``scale`` on the full-width system, with
    the kernel launch counts taken from this run alone.  Records the
    arguments VA's launch hands to the driver (``launch_args``) for
    :func:`phase_step_times`."""
    import torch
    from repro_torch.core import compile_cache
    cfg = _full_cfg()
    system = _system(cfg, "cuda")
    steps0 = compile_cache.stats()["steps"]
    calls = []
    run = compile_cache.run

    def recording_run(*a, **kw):
        calls.append((a, kw))
        return run(*a, **kw)

    compile_cache.run = recording_run
    try:
        reset_launches()                   # counts of this path only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = _va(system, 16, scale)    # raises on an oracle mismatch
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, idle = read_launches(), read_idle()
    finally:
        compile_cache.run = run
    steps = compile_cache.stats()["steps"] - steps0
    checks = steps // compile_cache.STEPS_PER_CHECK
    check(len(calls) == 1, f"VA made {len(calls)} driver launches")
    check(launches["cycle_step"] > 0,
          "cycle_step was never launched on the main path")
    # the one launch queued past the run's end is counted apart
    check(idle["cycle_step"] == len(calls),
          f"{idle['cycle_step']} cycle_step launches queued past the end "
          f"of {len(calls)} driver launch")
    check(launches["cycle_step"] - idle["cycle_step"] == checks
          and steps == checks * compile_cache.STEPS_PER_CHECK,
          f"cycle_step launches {launches['cycle_step']} less "
          f"{idle['cycle_step']} idle != host checks {checks} ({steps} "
          "steps)")
    check(launches["alu_exec"] == 0,
          f"alu_exec launched {launches['alu_exec']} times on the main path")
    from repro_torch.kernels.cycle_step.ops import launch_route
    res = {"route": launch_route(compile_cache.dpu_bucket(cfg.n_dpus), 16,
                                 cfg.wram_words, cfg.atomic_bits),
           "scale": scale, "cycles": rep.cycles, "issued": rep.issued,
           "steps": steps, "launches": launches["cycle_step"],
           "idle_launches": idle["cycle_step"],
           "alu_exec_launches": launches["alu_exec"], "wall_s": wall,
           "kips": rep.issued / wall / 1e3,
           "cycles_per_s": rep.cycles / wall,
           "steps_per_s": steps / wall, "launch_args": calls[0]}
    log(f"[main] VA 64 DPUs x 16 tasklets scale {scale}: oracle ok; "
        f"{json.dumps({k: v for k, v in res.items() if k != 'launch_args'})}")
    return res


#: scale of each workload's full-width run in [workloads]: 1.0 but for
#: SSORT, whose sample sort on 32 DPUs gives some DPU more than its
#: merge buffer (sort.MERGE_MAX_WORDS) above 0.375 (cuts: PERF.md §4)
FULL_SCALE = {"SSORT": 0.375}
#: the golden configuration whose runs [workloads] (a) records and
#: [cluster] (c) replays
TRACE_KEY = "g4"


def _recording(system_cls, recordings: dict, name: str):
    """A ``system_cls`` factory that attaches a trace recorder to the
    system it makes, keeping (system, recorder) as ``recordings[name]``."""
    from repro_torch import trace

    def make(cfg, **kw):
        system = system_cls(cfg, **kw)
        recordings[name] = (system, trace.record(system))
        return system
    return make


def _golden_runs(gold, recordings: dict) -> int:
    """(a) every workload at the scalar DPU's golden configurations
    (``goldens.SCALAR_KEYS``; the SIMT and HBM-PIM ones are [simt]'s), and
    the remap scenario, on the card: each must equal its JAX-made golden exactly
    and launch cycle_step.  The runs at TRACE_KEY are recorded into
    ``recordings`` (name -> (system, recorder)) for [cluster] (c).
    Returns the runs."""
    import repro_torch.workloads as wl
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.faults import FaultPlan, kill_dpu
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.workloads import goldens
    runs = 0
    for key in goldens.SCALAR_KEYS:
        t0 = time.perf_counter()
        for name in sorted(wl.ALL):
            l0 = step_ops.launches
            system_cls = (_recording(PIMSystem, recordings, name)
                          if key == TRACE_KEY else PIMSystem)
            rep, system, st = goldens.run_config(wl, DPUConfig, system_cls,
                                                 key, name, device="cuda")
            bad = goldens.differences(gold["entries"][key][name],
                                      goldens.entry(rep, system, st))
            check(not bad, f"{name} on {key} (cuda) differs from its golden "
                  f"in {bad}")
            check(step_ops.launches > l0, f"{name} on {key} launched no "
                  "cycle_step")
            runs += 1
        log(f"[workloads] {key} ({goldens.CONFIGS[key][0]}, "
            f"{goldens.CONFIGS[key][1]} threads, scale "
            f"{goldens.CONFIGS[key][2]}): all {len(wl.ALL)} workloads equal "
            f"to their goldens (cycles, issued, Timeline, SHA-256 of every "
            f"KernelReport field and state leaf) "
            f"({time.perf_counter() - t0:.1f} s)")
    rep, system, st = goldens.run_remap(wl, DPUConfig, PIMSystem, FaultPlan,
                                        kill_dpu, device="cuda")
    got = goldens.remap_entry(rep, system, st)
    bad = goldens.differences(gold["remap"], got)
    check(not bad, f"remap scenario {goldens.REMAP} (cuda) differs from its "
          f"golden in {bad}")
    log(f"[workloads] remap {goldens.REMAP}: equal to its golden (fault log "
        f"{got['fault_log']}, Timeline, state)")
    return runs + 1


def _driver_timer():
    """(inside seconds list, restore): ``compile_cache._drive`` timed into
    the list until ``restore()``; the rest of a run's wall is set-up."""
    from repro_torch.core import compile_cache
    inside = [0.0]
    drive = compile_cache._drive

    def timed_drive(prep, k):
        t = time.perf_counter()
        try:
            return drive(prep, k)
        finally:
            inside[0] += time.perf_counter() - t

    compile_cache._drive = timed_drive

    def restore():
        compile_cache._drive = drive
    return inside, restore


def _timed_run(cfg, name: str, scale: float, kernel: str) -> dict:
    """Workload ``name`` on a card system of ``cfg``, its numpy oracle
    inside ``run()``: the wall, the simulation rate, the launches of the
    ``kernel`` counter, the driver's launches, and the share of the wall
    spent outside the driver's K-step loops (set-up: the state and MRAM
    image to the card and back, the host's work)."""
    import torch
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    mod, attr = _counters()[kernel]
    system = _system(cfg, "cuda")
    s0 = compile_cache.stats()
    l0, i0 = getattr(mod, attr), mod.idle_launches
    inside, restore = _driver_timer()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = wl.get(name).run(system, 16, scale=scale, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    s1 = compile_cache.stats()
    steps = s1["steps"] - s0["steps"]
    res = {"workload": name, "dpus": cfg.n_dpus, "scale": scale,
           "wall_s": wall,
           "cycles": rep.cycles, "issued": rep.issued,
           "kips": rep.issued / wall / 1e3, "steps": steps,
           "steps_per_s": steps / wall,
           f"{kernel}_launches": getattr(mod, attr) - l0,
           f"{kernel}_idle_launches": mod.idle_launches - i0,
           "sim_launches": s1["launches"] - s0["launches"],
           "outside_share": 1.0 - inside[0] / wall}
    ran = res[f"{kernel}_launches"] - res[f"{kernel}_idle_launches"]
    check(ran > 0, f"{name} launched no {kernel}")
    check(res[f"{kernel}_idle_launches"] <= res["sim_launches"],
          f"{name}: more idle {kernel} launches than driver launches")
    check(ran * compile_cache.STEPS_PER_CHECK == steps,
          f"{name}: {ran} {kernel} launches (idle ones apart) for {steps} "
          "steps")
    return res


def _full_width_run(name: str, scale: float) -> dict:
    """(b) ``name`` at full width on the card through cycle_step (SSORT
    on its most, 32 DPUs: ``goldens.MAX_DPUS``)."""
    from repro_torch.workloads.goldens import MAX_DPUS
    cfg = _full_cfg()
    cfg = cfg.replace(n_dpus=min(cfg.n_dpus, MAX_DPUS.get(name, cfg.n_dpus)))
    return _timed_run(cfg, name, scale, "cycle_step")


def phase_workloads() -> dict:
    """Every workload of the registry on the card through cycle_step: (a)
    against the JAX package's goldens at two configurations and the remap
    scenario; (b) at full width (64 DPUs x 16 tasklets, scale 1.0 unless
    FULL_SCALE cuts it), held by its own oracle, with its rate and
    set-up share."""
    import repro_torch.workloads as wl
    from repro_torch.workloads import goldens
    t0 = time.perf_counter()
    recordings = {}
    runs = _golden_runs(goldens.load(), recordings)
    full = []
    for name in sorted(wl.ALL):
        res = _full_width_run(name, FULL_SCALE.get(name, 1.0))
        log("[workloads] full width, oracle ok: " + json.dumps(res))
        full.append(res)
    secs = time.perf_counter() - t0
    log(f"[workloads] {runs} golden runs and {len(full)} full-width runs "
        f"({secs:.1f} s)")
    return {"golden_runs": runs, "full": full, "seconds": secs,
            "recordings": recordings}


#: commands a launch in [simt]'s crf_step cases (the cases are short)
CRF_CASE_K = 8
#: crf_step's routes, in the order its picker prefers them
CRF_ROUTES = ("resident_smem", "global")


def _record_launches(fn):
    """Run ``fn()`` with compile_cache.run recording its arguments;
    returns (fn's result, the list of (args, kwargs))."""
    from repro_torch.core import compile_cache
    calls = []
    run = compile_cache.run

    def recording_run(*a, **kw):
        calls.append((a, kw))
        return run(*a, **kw)

    compile_cache.run = recording_run
    try:
        return fn(), calls
    finally:
        compile_cache.run = run


def _prepared_on(a, kw, route):
    """``compile_cache.prepare(*a, **kw)`` with its kernel driver re-made
    on ``route`` (``StepDriver.like``; None: the kernel's own pick)."""
    from repro_torch.core import compile_cache
    prep = compile_cache.prepare(*a, **kw)
    if route is not None:
        prep.kernel = prep.kernel.like(prep.st, route)
    return prep


def _kernel_times(launch_args, label: str, n: int, dma_bytes_moved: int,
                  skip=("wram", "mram", "atomic"), routes=None) -> dict:
    """A step kernel at a path's own launch, set up again with
    ``compile_cache.prepare`` (once for each of ``routes``, each on its own
    state; None: the kernel's own pick): after 2 warm launches, one launch
    of 64 steps of each held bitwise against 64 eager card steps (the
    plain version) from a copy of the same state, every leaf
    (``max_abs_err``: the largest difference over the leaves); then the
    device ms per 64-step launch, windows of ``n`` raw launches between
    CUDA events (uncounted), the routes in turns (a, b, b, a), the path's
    own route's the result; the plain version's time (the eager card step
    x 64) on the copy; the bytes bound: every leaf of the kernel's
    ``LEAVES`` but ``skip`` read and written once, and the memory words
    the timed launches move (the DMA'd or bank words read from one memory
    and written to another, ``dma_bytes_moved`` times their byte count,
    LW/SW words, one atomic word read and written per sync
    instruction)."""
    import torch
    from repro_torch.core import compile_cache
    from repro_torch.core.isa import CLS_LDST, CLS_SYNC
    a, kw = launch_args
    K = compile_cache.STEPS_PER_CHECK
    preps = {r: _prepared_on(a, kw, r) for r in (routes or (None,))}
    main = compile_cache.prepare(*a, **kw).kernel
    main_route = getattr(main, "route", None)
    for prep in preps.values():
        for _ in range(2):
            prep.kernel.run(K)
    torch.cuda.synchronize()
    first = next(iter(preps.values()))
    plain = {k: v.clone() for k, v in first.st.items()}
    for prep in preps.values():
        prep.kernel.run(K)
    for _ in range(K):
        plain.update(first.step_fn(first.ir, plain))
    torch.cuda.synchronize()
    err, bad = 0.0, []
    for r, prep in preps.items():
        for k, want in plain.items():
            got = prep.st[k]
            if want.dtype == torch.float32:    # bitwise, not by value
                same = torch.equal(want.view(torch.int32),
                                   got.view(torch.int32))
            else:
                same = torch.equal(want, got)
            if not same:
                bad.append(f"{k} ({r})")
            err = max(err, (want.double() - got.double()).abs().max().item())
        check(prep.kernel.predicate() == bool(first.cond(plain)),
              f"{label}: predicates differ after the compared launch ({r})")
    check(not bad, f"{label}: the kernel's launch differs from {K} eager "
          f"card steps in {bad} (max abs err {err})")
    key = main_route if routes else None
    prep = preps[key]
    kern, st = prep.kernel, prep.st
    before = {k: st[k].double().sum().item()
              for k in ("c_issued", "c_dma_rd_bytes", "c_dma_wr_bytes")}
    cls0 = st["c_cls"].double().sum(0)
    turns = _in_turns({r: p.kernel for r, p in preps.items()}, K, n)
    ms = turns[key]["ms"]
    delta = {k: (st[k].double().sum().item() - v) / (2 * n)
             for k, v in before.items()}
    cls = (st["c_cls"].double().sum(0) - cls0) / (2 * n)
    for _ in range(2):
        plain.update(prep.step_fn(prep.ir, plain))
    torch.cuda.synchronize()
    m = 10
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(m):
        plain.update(prep.step_fn(prep.ir, plain))
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1) / m * K
    small = sum(st[k].numel() * st[k].element_size() for k in kern.LEAVES
                if k not in skip)
    dma = delta["c_dma_rd_bytes"] + delta["c_dma_wr_bytes"]
    ldst, sync = cls[CLS_LDST].item(), cls[CLS_SYNC].item()
    nbytes = 2 * small + dma_bytes_moved * dma + 4 * ldst + 8 * sync
    ops = delta["c_issued"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR32_OPS_PER_S
    res = {"route": main_route, "ms": ms, "us_per_step": ms * 1e3 / K,
           "plain_ms": plain_ms,
           "max_abs_err": err, "compared_steps": K,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "state_bytes": small,
           "bytes_per_launch": nbytes, "dma_bytes_per_launch": dma,
           "issued_per_launch": ops, "dpus": int(st["status"].shape[0]),
           "timed_launches": 2 * n}
    if routes:
        res["routes"] = turns
        other = [r for r in routes if r != main_route]
        check(all(ms <= 1.05 * turns[r]["ms"] for r in other),
              f"{label}: the path takes {main_route} ({ms:.5f} ms a "
              f"launch), slower than {turns}")
    log(f"[simt] {label}: bitwise equal to {K} eager card steps; "
        + json.dumps(res))
    return res


def phase_simt() -> dict:
    """[simt] the SIMT engine and the HBM-PIM targets on the card: (a)
    simt_step and crf_step bitwise against the eager card steps on every
    case; (b) the SIMT and HBM-PIM goldens; (c) the full-width runs under
    their oracles (Fig. 11's designs, GEMVS on hbmpim_cmd, BFS and SSORT
    on hbmpim), each kernel's launches counted over its own path; (d) each
    kernel's ms per launch at its path's launch."""
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.kernels.crf_step import cases as crf_cases
    from repro_torch.kernels.cycle_step.cases import hold_against_plain
    from repro_torch.kernels.simt_step import cases
    from repro_torch.workloads import goldens
    out = {"cases": 0, "steps": 0}
    t0 = time.perf_counter()
    runs = [(n, cases.launch(n), 64, None, ("resident_smem", "global"))
            for n in sorted(cases.CASES)]
    runs += [(f"crf:{n}", crf_cases.launch(n), CRF_CASE_K,
              crf_cases.edit_of(n), CRF_ROUTES)
             for n in sorted(crf_cases.CASES)]
    for name, case, k, edit, routes in runs:
        t1 = time.perf_counter()
        try:
            res = hold_against_plain(case, k, device="cuda", edit=edit,
                                     routes=routes)
        except AssertionError as e:
            raise SmokeError(f"{name}: kernel != eager card step "
                             f"({case[0].n_dpus} DPUs): {e}")
        check(res["alu_launches"] == 0,
              f"{name}: {res['alu_launches']} alu_exec launches in the kernel")
        check(routes is None or tuple(res["routes"]) == routes,
              f"{name} took the {res['routes']} routes, not {routes}")
        log(f"[simt] {res['kernel']} {name} ({case[0].n_dpus} DPUs x "
            f"{case[4]} lanes{', ' + '/'.join(routes) if routes else ''}): "
            f"bitwise equal after 1, 7 and {res['steps']} "
            f"steps, {res['launches']} launches "
            f"({time.perf_counter() - t1:.1f} s)")
        out["cases"] += 1
        out["steps"] += res["steps"]
    log(f"[simt] {out['cases']} cases bitwise equal "
        f"({time.perf_counter() - t0:.1f} s)")

    gold = goldens.load()["entries"]
    t1 = time.perf_counter()
    runs = 0
    for key in goldens.SIMT_KEYS:
        for name in goldens.workloads_of(key, wl.ALL):
            kernel = goldens.kernel_of(key, name)
            mod, attr = _counters()[kernel]
            l0 = getattr(mod, attr)
            got = goldens.run_entry(wl, DPUConfig, PIMSystem, compile_cache,
                                    key, name, device="cuda")
            bad = goldens.differences(gold[key][name], got)
            check(not bad, f"{name} on {key} (cuda) differs from its golden "
                  f"in {bad}: {got.get('raises', '')}")
            check(getattr(mod, attr) > l0, f"{name} on {key} launched no "
                  f"{kernel}")
            runs += 1
    capped = sorted(f"{k}/{n}" for k in goldens.SIMT_KEYS for n in gold[k]
                    if "raises" in gold[k][n])
    out["golden_runs"] = runs
    log(f"[simt] {runs} golden runs ({', '.join(goldens.SIMT_KEYS)}) equal "
        f"to their goldens; capped at {goldens.CAP} cycles with the "
        f"golden's error and capped state: {', '.join(capped)} "
        f"({time.perf_counter() - t1:.1f} s)")

    # (c) full width, each kernel's launches counted over its own path
    full = _full_cfg()
    out["fig11"] = []
    reset_launches()
    (_, calls) = _record_launches(lambda: [
        out["fig11"].append(dict(design=d, **_timed_run(
            full.replace(**kw), "GEMV", 1.0,
            "cycle_step" if d == "Base" else "simt_step")))
        for d, kw in goldens.FIG11.items()])
    fig11_launches = read_launches()
    out["simt_step_launches"] = fig11_launches["simt_step"]
    out["simt_step_idle_launches"] = read_idle()["simt_step"]
    base_c = out["fig11"][0]["cycles"]
    for r in out["fig11"]:
        r["speedup"] = base_c / r["cycles"]
        log("[simt] Fig. 11 full width, oracle ok: " + json.dumps(r))
    check(fig11_launches["crf_step"] == 0 and fig11_launches["alu_exec"] == 0,
          f"Fig. 11 launched {fig11_launches}")
    simt_args = calls[2]            # SIMT+AC's one launch (GEMV: one each)
    check(simt_args[0][0].coalescing and simt_args[0][0].simt_width == 16,
          "the recorded launch is not SIMT+AC's")
    from repro_torch.kernels.crf_step import ops as crf_ops
    reset_launches()
    from repro_torch.kernels.crf_step import crf_step as k_crf
    ((r, calls_cmd), crf_routes) = _routes_launched(
        k_crf.LIB, lambda: _record_launches(lambda: _timed_run(
            full.replace(backend="hbmpim_cmd"), "GEMVS", 1.0, "crf_step")))
    check(crf_routes == {"resident_smem"}, f"GEMVS on hbmpim_cmd launched "
          f"crf_step on {crf_routes}")
    r["routes"] = sorted(crf_routes)
    out["gemvs_cmd"] = r
    out["crf_step_launches"] = read_launches()["crf_step"]
    out["crf_step_idle_launches"] = read_idle()["crf_step"]
    log("[simt] GEMVS on hbmpim_cmd full width, oracle ok: " + json.dumps(r))
    out["allbank"] = []
    for name, dpus, scale in (("BFS", 64, 1.0), ("SSORT", 32, 0.375)):
        r = _timed_run(full.replace(backend="hbmpim", n_dpus=dpus), name,
                       scale, "simt_step")
        out["allbank"].append(r)
        log(f"[simt] {name} on hbmpim, oracle ok: " + json.dumps(r))

    # (d) each kernel at its path's launch
    # 2 warm launches, 1 compared, 2n timed: the launch still runs after
    n = max(1, min(100, (out["fig11"][2]["simt_step_launches"] - 4) // 2))
    out["simt_times"] = _kernel_times(simt_args, "simt_step at Fig. 11 "
                                      "SIMT+AC's full-width launch", n, 2,
                                      routes=("global", "resident_smem"))
    from repro_torch.kernels.simt_step import simt_step as k_simt
    from repro_torch.kernels.simt_step.ops import smem_bytes
    lib = k_simt.library()
    full_T = full.n_tasklets
    for r, kernel, dyn in (
            ("global", "simt_run_kernel",
             k_simt.DPUS_PER_BLOCK * full_T * 24 * 4),
            ("resident_smem", "simt_smem_kernel",
             smem_bytes(full_T, full.wram_words, full.atomic_bits))):
        out["simt_times"]["routes"][r].update(_kernel_build(lib, kernel),
                                              dynamic_smem_bytes=dyn)
    t = out["simt_times"]
    log("[kernels] simt_step at Fig. 11 SIMT+AC's full-width launch (old: "
        "global, new: resident_smem, in turns; the path's route "
        f"{t['route']}): bound {t['bound_ms']} ms ({t['bound_by']}); "
        + json.dumps(t["routes"]))
    per_launch = out["gemvs_cmd"]["crf_step_launches"] // len(calls_cmd)
    out["crf_times"] = _kernel_times(
        calls_cmd[0], "crf_step at GEMVS's first full-width command "
        "stream", max(1, min(10, (per_launch - 4) // 2)), 1, skip=("mram",),
        routes=CRF_ROUTES[::-1])
    lib = k_crf.library()
    prep = compile_cache.prepare(*calls_cmd[0][0], **calls_cmd[0][1])
    table = prep.kernel.table
    W = full.hbm_lanes
    for r, kernel, dyn in (
            ("global", "crf_run_kernel", 0),
            ("resident_smem", "crf_smem_kernel",
             k_crf.smem_bytes(int(prep.ir.shape[1]), len(table.rows), W))):
        out["crf_times"]["routes"][r].update(_kernel_build(lib, kernel),
                                             dynamic_smem_bytes=dyn)
    t = out["crf_times"]
    t["staged_rows"] = len(table.rows)
    t["us_per_command"] = {r: v["ms"] * 1e3 / compile_cache.STEPS_PER_CHECK
                           for r, v in t["routes"].items()}
    log("[kernels] crf_step at GEMVS's first full-width command stream "
        "(old: global, new: resident_smem, in turns; the path's route "
        f"{t['route']}; {len(table.rows)} rows staged): bound "
        f"{t['bound_ms']} ms ({t['bound_by']}); " + json.dumps(t["routes"]))
    out["seconds"] = time.perf_counter() - t0
    log(f"[simt] phase {out['seconds']:.1f} s")
    return out


def _in_turns(kerns: dict, K: int, n: int) -> dict:
    """Device ms per K-step launch of each kernel driver of ``kerns``
    (route -> driver, each over its own copy of one launch's state), in
    turns: windows of ``n`` raw launches back to back between CUDA events
    (uncounted, no flag reads), in the order a, b, b, a; each route's mean
    over its two windows, and every window's."""
    import torch
    order = list(kerns) + list(kerns)[::-1]
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    windows = {r: [] for r in kerns}
    for r in order:
        torch.cuda.synchronize()
        t0.record()
        for _ in range(n):
            kerns[r].run(K)
        t1.record()
        torch.cuda.synchronize()
        windows[r].append(t0.elapsed_time(t1) / n)
    for r, kern in kerns.items():
        check(kern.predicate(), f"the launch ended inside {r}'s timed "
              "windows: run a larger --scale")
    return {r: {"ms": sum(w) / len(w), "windows_ms": w}
            for r, w in windows.items()}


def _kernel_build(lib, kernel: str) -> dict:
    """A kernel's registers, static shared memory and spills from its
    library's ptxas -v log (``kernel``: part of its entry's name)."""
    for name, (regs, stores, loads, smem) in _ptxas_report(lib).items():
        if kernel in name:
            return {"registers": regs, "static_smem_bytes": smem,
                    "spill_stores": stores, "spill_loads": loads}
    raise SmokeError(f"no ptxas -v report of {kernel}")


def phase_step_times(launch_args, n: int = 100) -> dict:
    """cycle_step's device ms per 64-step launch on the main path's own
    launch (VA at --scale, 64 DPUs), set up again with
    ``compile_cache.prepare`` once for each resident route (the
    global-WRAM one, old, and the shared-memory one, new, each on its own
    state): 10 warm launches each, then windows of ``n`` raw launches in
    turns (old, new, new, old); the main path's route must be the faster
    (within 5%).  The plain version's time, the eager card step x 64, on a
    copy of the main path's route's state; the bound from the bytes and
    instructions of its timed launches; each route's kernel's registers,
    shared memory and spills."""
    import torch
    from repro_torch.core import compile_cache
    from repro_torch.kernels.cycle_step import cycle_step
    from repro_torch.kernels.cycle_step.ops import launch_route, smem_bytes
    a, kw = launch_args
    cfg = a[0]
    K = compile_cache.STEPS_PER_CHECK
    kerns, preps = {}, {}
    for r in ("resident", "resident_smem"):
        preps[r] = _prepared_on(a, kw, r)
        kerns[r] = preps[r].kernel
        for _ in range(10):
            kerns[r].run(K)
    torch.cuda.synchronize()
    main = launch_route(compile_cache.dpu_bucket(cfg.n_dpus),
                        int(preps["resident"].st["status"].shape[1]),
                        cfg.wram_words, cfg.atomic_bits)
    prep, st = preps[main], preps[main].st
    plain = {k: v.clone() for k, v in st.items()}
    before, cls0, cycles0 = _counters_of(st)
    turns = _in_turns(kerns, K, n)
    ms = turns[main]["ms"]
    other = "resident" if main == "resident_smem" else "resident_smem"
    check(ms <= 1.05 * turns[other]["ms"], f"the main path takes {main} "
          f"({ms:.5f} ms a launch), slower than {other} "
          f"({turns[other]['ms']:.5f})")
    work = _launch_bytes(cfg, st, before, cls0, cycles0, 2 * n)
    # eager card step x 64 on the same state
    for _ in range(3):
        plain.update(prep.step_fn(prep.ir, plain))
    torch.cuda.synchronize()
    m = 20
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(m):
        plain.update(prep.step_fn(prep.ir, plain))
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1) / m * K
    nbytes, ops = work["bytes"], work["issued"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR32_OPS_PER_S
    lib = cycle_step.library()
    T, W = int(st["status"].shape[1]), int(st["wram"].shape[1])
    res = {"route": main, "ms": ms, "us_per_step": ms * 1e3 / K,
           "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "state_bytes": work["state_bytes"],
           "bytes_per_launch": nbytes,
           "dma_bytes_per_launch": work["dma_bytes"],
           "ldst_per_launch": work["ldst"], "sync_per_launch": work["sync"],
           "windows_per_launch": work["windows"], "issued_per_launch": ops,
           "cycles_per_launch": float((st["cycle"] - cycles0).double()
                                      .mean()) / (2 * n),
           "dpus": int(st["status"].shape[0]), "timed_launches": 2 * n,
           "routes": {
               "resident": dict(turns["resident"], **_kernel_build(
                   lib, "cycle_step_kernel"), dynamic_smem_bytes=(
                       cycle_step.DPUS_PER_BLOCK * (T * 24 + 24) * 4)),
               "resident_smem": dict(turns["resident_smem"], **_kernel_build(
                   lib, "cycle_step_smem_kernel"),
                   dynamic_smem_bytes=smem_bytes(T, W, cfg.atomic_bits))}}
    log(f"[kernels] cycle_step at the main path's launch ({main} route): "
        + json.dumps(res))
    return res


def phase_kernel_times(n: int) -> dict:
    """Kernel and plain-version ms per call at the main path's shape
    (``(n, 1)``, n = the DPU bucket):
    device time (graph-replayed launches of the raw launcher and of the
    plain version) and the wrapper's cost per call from the host."""
    import torch
    from repro_torch.kernels.alu_exec import ops
    from repro_torch.kernels.alu_exec.alu_exec import alu_exec_cuda
    from repro_torch.kernels.alu_exec.ref import alu_exec_ref
    op, a, b = (torch.from_numpy(x.reshape(n, 1)).cuda()
                for x in _alu_inputs(n, 7))
    op = op.clamp(0, 11)
    out = torch.empty_like(op)
    res = {"ms": graph_time_ms(lambda: alu_exec_cuda(op, a, b, out)),
           "plain_ms": graph_time_ms(lambda: alu_exec_ref(op, a, b)),
           "wrapper_host_ms": cuda_time_ms(lambda: ops.alu_exec(op, a, b)),
           "plain_host_ms": cuda_time_ms(lambda: alu_exec_ref(op, a, b))}
    nbytes = 16 * n                 # op, a, b read once; out written once
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n / SCALAR32_OPS_PER_S
    res["bound_ms"] = max(t_bytes, t_ops) * 1e3
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[kernels] alu_exec at N={n}: " + json.dumps(res))
    return res


#: the reference's full-system cell (src/repro/launch/dryrun.py
#: run_pim_cell): 2,560 DPUs, 16 tasklets, 1 MiB of MRAM each, VA at
#: scale 1.0, seed 0
SYSTEM_MRAM = 1 << 20
#: BFS at FULL_SYSTEM_DPUS: its graph has at most 2,048 vertices (the
#: WRAM arrays), so with 2,560 DPUs V // D = 0 and the last DPU owns every
#: vertex at any scale; every DPU still stages and writes back the dist,
#: frontier and next arrays each level.  128 KiB of MRAM holds its image
SYSTEM_BFS_SCALE = 0.25
SYSTEM_BFS_MRAM = 1 << 17


def _routes_launched(lib, fn):
    """``fn()`` with the step kernel library ``lib``'s launcher
    (``StepLibrary.launch``) recording the routes it launches on; returns
    (fn's result, the set of routes)."""
    routes = set()
    launch = lib.launch

    def recorded(route, *a, **kw):
        routes.add(route)
        return launch(route, *a, **kw)

    lib.launch = recorded
    try:
        return fn(), routes
    finally:
        del lib.launch                  # the class's method again


def phase_system() -> dict:
    """[system] (a) the reference's full-system cell through PIMSystem on
    the card: VA on 2,560 DPUs (padded to 4,096) under its oracle, every
    cycle_step launch on resident_carry, counted over this run alone
    (set to 0 just before it, read just after), with its wall, cycles,
    issued, KIPS, steps/s and set-up share; then the same configuration
    on 64 DPUs, whose cycles it should equal (VA's control flow does not
    depend on the data).  (b) BFS at 2,560 DPUs, 6 launches with
    collectives between them, on resident_carry (the picker's) and on
    stepwise (asked for): the returned state, KernelReport and Timeline
    equal."""
    import numpy as np
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig
    from repro_torch.kernels.cycle_step import ops as step_ops
    t0 = time.perf_counter()
    cfg = DPUConfig(n_dpus=FULL_SYSTEM_DPUS, n_tasklets=16,
                    mram_bytes=SYSTEM_MRAM)
    reset_launches()
    va, routes = _routes_launched(step_ops.LIB, lambda: _timed_run(
        cfg, "VA", 1.0, "cycle_step"))
    launches = read_launches()
    check(routes == {"resident_carry"}, f"the full-system VA launched on "
          f"{routes}, not resident_carry")
    check(launches["cycle_step"] == va["cycle_step_launches"] > 0
          and launches["alu_exec"] == 0, f"the full-system VA launched "
          f"{launches}")
    va["routes"] = sorted(routes)
    va["launches"] = launches["cycle_step"]
    va["idle_launches"] = read_idle()["cycle_step"]
    log(f"[system] VA on {FULL_SYSTEM_DPUS} DPUs x 16 tasklets, 1 MiB MRAM, "
        "scale 1.0 (the reference's full-system cell), oracle ok: "
        + json.dumps(va))
    small = _timed_run(cfg.replace(n_dpus=64), "VA", 1.0, "cycle_step")
    va["cycles_64_dpus"] = small["cycles"]
    va["cycles_equal_64"] = small["cycles"] == va["cycles"]
    log(f"[system] the same configuration on 64 DPUs: cycles "
        f"{small['cycles']} ({'equal to' if va['cycles_equal_64'] else 'NOT'}"
        f" the full system's {va['cycles']}), issued {small['issued']}, "
        f"wall {small['wall_s']:.3f} s")

    # (b) BFS above the resident limit on both routes
    bcfg = DPUConfig(n_dpus=FULL_SYSTEM_DPUS, n_tasklets=16,
                     mram_bytes=SYSTEM_BFS_MRAM)
    runs = {}
    for route in ABOVE:
        pick = step_ops.launch_route
        if route != "resident_carry":
            step_ops.launch_route = lambda *a: route
        try:
            system = _system(bcfg, "cuda")
            s0 = compile_cache.stats()
            t1 = time.perf_counter()
            (st, rep), got = _routes_launched(step_ops.LIB, lambda: wl.get(
                "BFS").run(system, 16, scale=SYSTEM_BFS_SCALE, seed=0))
            secs = time.perf_counter() - t1
            s1 = compile_cache.stats()
        finally:
            step_ops.launch_route = pick
        check(got == {route}, f"BFS at {FULL_SYSTEM_DPUS} DPUs launched on "
              f"{got}, not {route}")
        runs[route] = (st, rep, system.timeline, secs,
                       s1["launches"] - s0["launches"],
                       s1["steps"] - s0["steps"])
    (sa, ra, ta, *ma), (sb, rb, tb, *mb) = runs.values()
    bad = [k for k in sa if not np.array_equal(np.asarray(sa[k]),
                                               np.asarray(sb[k]))]
    bad += _same_report(ra, rb) + _same_timeline(ta, tb)
    check(set(sa) == set(sb) and not bad, f"BFS at {FULL_SYSTEM_DPUS} DPUs: "
          f"resident_carry and stepwise differ in {bad}")
    check(ma[1:] == mb[1:], f"BFS at {FULL_SYSTEM_DPUS} DPUs: step-driver "
          f"launches and steps {ma[1:]} on resident_carry, {mb[1:]} on "
          "stepwise")
    bfs = {"dpus": FULL_SYSTEM_DPUS, "scale": SYSTEM_BFS_SCALE,
           "sim_launches": ma[1], "steps": ma[2],
           "cycles": ra.cycles, "issued": ra.issued,
           "wall_s": {r: v[3] for r, v in runs.items()}}
    log(f"[system] BFS at {FULL_SYSTEM_DPUS} DPUs (scale "
        f"{SYSTEM_BFS_SCALE}), oracle ok on both routes: state, "
        "KernelReport and Timeline equal on resident_carry and stepwise; "
        + json.dumps(bfs))
    out = {"va": va, "bfs": bfs, "seconds": time.perf_counter() - t0}
    log(f"[system] phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the cluster, admission and trace stack
# ---------------------------------------------------------------------------

#: [cluster] (b): the cluster at full width, 8 ranks of 32 DPUs, each
#: profile one 32-DPU, 8-tasklet, 2 MiB rank at scale 0.375: the widest
#: rank and largest scale at which all three kinds run (SSORT takes at
#: most 32 DPUs and, at 32, scale 0.375: PERF.md §4)
CLUSTER_FULL_SYSTEM = dict(n_dpus=256, n_ranks=8, n_channels=4,
                           mram_bytes=1 << 20)
CLUSTER_FULL_SCALE = 0.375
#: journaled step outcomes before [cluster] (b)'s simulated crash
CLUSTER_CRASH_AFTER = 12
#: [cluster] (d): examples/serve_lm.py's cluster and lease
LEASE_SYSTEM = dict(n_dpus=32, n_ranks=8, n_channels=4, mram_bytes=1 << 20)
LEASE_RANKS = 2


def _run_cluster(policy: str, rate: float, config=None, **kw):
    """goldens.run_cluster on the card with the port's classes."""
    import repro_torch.cluster as cluster
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.faults import FaultPlan
    from repro_torch.workloads import goldens
    return goldens.run_cluster(cluster, DPUConfig, PIMSystem, FaultPlan,
                               policy, rate, config=config or goldens.CLUSTER,
                               device="cuda", **kw)


def _scorecard(rep: dict) -> dict:
    m = rep["metrics"]
    return {"jobs": m["jobs"], "completed": m["completed"],
            "p50_ms": m["p50_latency"] * 1e3,
            "p99_ms": m["p99_latency"] * 1e3, "goodput": rep["goodput"],
            "utilization": rep["utilization"]}


def _cluster_goldens() -> dict:
    """(a) goldens.CLUSTER on the card: measured profiles (BFS, HST-S,
    SSORT through cycle_step, each under its oracle) and each (policy,
    fault rate)'s report must equal the JAX package's goldens exactly."""
    from repro_torch.workloads import goldens
    gold = goldens.load()["cluster"]
    reset_launches()                       # counts of this path only
    t0 = time.perf_counter()
    got = goldens.cluster_entries(_run_cluster)
    secs = time.perf_counter() - t0
    launches, idle = read_launches(), read_idle()
    got = json.loads(json.dumps(got))
    bad = [k for k in gold["runs"] if got["runs"].get(k) != gold["runs"][k]]
    bad += [f"profile {k}" for k in gold["profiles"]
            if got["profiles"].get(k) != gold["profiles"][k]]
    check(not bad, f"[cluster] goldens differ in {bad}")
    check(launches["cycle_step"] > idle["cycle_step"]
          and launches["alu_exec"] == 0,
          f"[cluster] the measured profiles launched {launches}")
    out = {"runs": len(got["runs"]), "seconds": secs,
           "cycle_step_launches": launches["cycle_step"],
           "idle_launches": idle["cycle_step"],
           "scorecards": {k: _scorecard(v) for k, v in got["runs"].items()}}
    log("[cluster] (a) goldens.CLUSTER on the card (8 ranks x 4 DPUs, "
        "measured profiles of 4 DPUs x 8 tasklets at scale "
        f"{goldens.CLUSTER['profile_scale']}): the profiles of "
        f"{', '.join(goldens.CLUSTER_KINDS)} and all {out['runs']} "
        "(policy, fault rate) reports equal to goldens.json: "
        + json.dumps(out))
    return out


def _measured_full_width(kind: str) -> dict:
    """One kind's profile measured at [cluster] (b)'s rank on the card,
    under its oracle: its wall, cycle_step launches (counted over this
    measurement alone) and the share of the wall outside the driver's
    K-block loops."""
    import torch
    from repro_torch.cluster import measure_profile
    from repro_torch.core import compile_cache
    per_rank = (CLUSTER_FULL_SYSTEM["n_dpus"]
                // CLUSTER_FULL_SYSTEM["n_ranks"])
    inside, restore = _driver_timer()
    s0 = compile_cache.stats()
    reset_launches()                       # counts of this path only
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = measure_profile(kind, n_dpus=per_rank,
                               scale=CLUSTER_FULL_SCALE, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches, idle = read_launches(), read_idle()
    s1 = compile_cache.stats()
    steps = s1["steps"] - s0["steps"]
    res = {"kind": kind, "dpus": per_rank, "tasklets": 8,
           "scale": CLUSTER_FULL_SCALE, "wall_s": wall,
           "profile_steps": len(prof.steps),
           "sim_launches": s1["launches"] - s0["launches"], "steps": steps,
           "cycle_step_launches": launches["cycle_step"],
           "idle_launches": idle["cycle_step"],
           "outside_share": 1.0 - inside[0] / wall}
    ran = launches["cycle_step"] - idle["cycle_step"]
    check(ran > 0 and ran * compile_cache.STEPS_PER_CHECK == steps
          and launches["alu_exec"] == 0,
          f"[cluster] {kind}'s measured profile launched {launches} for "
          f"{steps} steps")
    return res


def _cluster_full_width() -> dict:
    """(b) the cluster at full width: measured profiles of 32-DPU ranks,
    the report equal between inorder and async and across two runs, a
    journaled run killed and resumed on a fresh cluster and system equal
    to the uninterrupted one, both policies' scorecards at 0 and 2%
    faults, and benchmarks/torch_cluster_load.py's gate (synthetic
    profiles) on the card."""
    import importlib.util
    import tempfile
    from repro_torch.admission import SimulatedCrash
    from repro_torch.workloads import goldens
    t0 = time.perf_counter()
    kinds = [_measured_full_width(k) for k in goldens.CLUSTER_KINDS]
    for r in kinds:
        log("[cluster] (b) measured profile, oracle ok: " + json.dumps(r))
    config = dict(goldens.CLUSTER, system=CLUSTER_FULL_SYSTEM,
                  profile_scale=CLUSTER_FULL_SCALE)

    def report(policy, rate, mode="async", **kw):
        cfg = dict(config, mode=mode)
        return goldens.cluster_report(
            _run_cluster(policy, rate, config=cfg, **kw)[1])

    reset_launches()
    ref = report("fault_aware", 0.02)
    same = {"repeat": report("fault_aware", 0.02),
            "inorder": report("fault_aware", 0.02, mode="inorder")}
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "cluster.journal")
        try:
            report("fault_aware", 0.02, cluster_kw=dict(
                journal=path, crash_after=CLUSTER_CRASH_AFTER))
            check(False, "[cluster] the journaled run did not crash")
        except SimulatedCrash:
            pass
        same["resumed"] = report("fault_aware", 0.02,
                                 cluster_kw=dict(journal=path))
    bad = [k for k, v in same.items() if v != ref]
    check(not bad, f"[cluster] full-width reports differ from the first "
          f"async run: {bad}")
    cards = {goldens.cluster_key("fault_aware", 0.02): _scorecard(ref)}
    for rate in goldens.CLUSTER["rates"]:
        for policy in goldens.CLUSTER["policies"]:
            key = goldens.cluster_key(policy, rate)
            if key not in cards:
                cards[key] = _scorecard(report(policy, rate))
    launches = read_launches()
    check(launches["cycle_step"] == 0, "[cluster] the cluster runs "
          f"re-measured their profiles: {launches}")
    log(f"[cluster] (b) {CLUSTER_FULL_SYSTEM['n_ranks']} ranks x "
        f"{CLUSTER_FULL_SYSTEM['n_dpus'] // CLUSTER_FULL_SYSTEM['n_ranks']} "
        "DPUs: the fault_aware report at 2% faults equal across two async "
        "runs, inorder, and a run killed after "
        f"{CLUSTER_CRASH_AFTER} journaled steps and resumed; scorecards "
        + json.dumps(cards))
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_load", ROOT / "benchmarks/torch_cluster_load.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    try:
        rows = bench.check(device="cuda")
    except SystemExit as e:
        raise SmokeError(f"[cluster] torch_cluster_load.py --check: {e}")
    gate = {r["policy"]: r["goodput"] for r in rows}
    log(f"[cluster] (b) torch_cluster_load.py --check (synthetic profiles) "
        f"on the card: goodput at 2% faults {json.dumps(gate)}")
    return {"kinds": kinds, "scorecards": cards, "gate": gate,
            "seconds": time.perf_counter() - t0}


def _cluster_trace(recordings: dict) -> dict:
    """(c) BFS at [workloads]'s full-width cell recorded on the card,
    saved as JSONL, loaded and replayed: the replay's Timeline equals the
    live one bitwise; a what-if replay (another fabric, more channels);
    every TRACE_KEY recording of [workloads] (a) replayed equals its
    golden Timeline."""
    import tempfile
    import torch
    import repro_torch.workloads as wl
    from repro_torch import trace
    from repro_torch.workloads import goldens
    system = _system(_full_cfg(), "cuda")
    rec = trace.record(system)
    reset_launches()                       # counts of this path only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wl.get("BFS").run(system, 16, scale=1.0, seed=0)
    system.sync()
    live_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["cycle_step"] > 0, "[cluster] BFS launched no cycle_step")
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "bfs.trace.jsonl")
        n = rec.save(path)
        t0 = time.perf_counter()
        res = trace.replay(trace.load(path))
        replay_s = time.perf_counter() - t0
        bad = _same_timeline(res.timeline, system.timeline)
        check(not bad, f"[cluster] BFS full-width replay differs in {bad}")
        what = {}
        for name, cfg in (("fabric=direct", res.cfg.replace(fabric="direct")),
                          ("n_channels=8", res.cfg.replace(n_channels=8))):
            r = trace.replay(path, cfg=cfg)
            what[name] = {"end_to_end": r.end_to_end,
                          "inter_dpu": r.timeline.inter_dpu,
                          "h2d": r.timeline.h2d}
    out = {"records": n, "commands": res.n_commands,
           "cycle_step_launches": launches["cycle_step"],
           "live_s": live_s, "replay_s": replay_s,
           "speedup": live_s / replay_s,
           "end_to_end": system.timeline.end_to_end, "what_if": what}
    log("[cluster] (c) BFS 64 DPUs x 16 tasklets scale 1.0 recorded on the "
        "card, saved, loaded and replayed: Timeline equal bitwise; "
        + json.dumps(out))
    gold = goldens.load()["entries"][TRACE_KEY]
    check(set(recordings) == set(gold), f"[cluster] {TRACE_KEY} recordings "
          f"{sorted(recordings)}")
    bad = [name for name, (_, r) in sorted(recordings.items())
           if json.loads(json.dumps(goldens.timeline(
               trace.replay(r.records).timeline)))
           != gold[name]["timeline"]]
    check(not bad, f"[cluster] {TRACE_KEY} replays differ from their golden "
          f"Timelines: {bad}")
    out["golden_replays"] = len(recordings)
    log(f"[cluster] (c) the card's recordings of all {len(recordings)} "
        f"workloads at {TRACE_KEY} replayed: each equal to its golden "
        "Timeline")
    return out


def phase_cluster(recordings: dict) -> dict:
    """[cluster] (a)-(c); (d), the lease, runs with [lm]'s model
    (:func:`lease_serve`)."""
    t0 = time.perf_counter()
    out = {"goldens": _cluster_goldens(), "full": _cluster_full_width(),
           "trace": _cluster_trace(recordings)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[cluster] phase (a)-(c) {out['seconds']:.1f} s")
    return out


def lease_serve(cfg, model, want: dict) -> dict:
    """[cluster] (d) on [lm]'s loaded llama3-8b: a ServeEngine whose PIM
    pool is a lease of examples/serve_lm.py's cluster answers [lm]'s 4
    requests with the tokens ``want`` of the pool-free engine, one
    ``decode`` launch on the system a tick; then the lease's DPUs are
    disabled after one tick, the pool trips its floor, the engine decodes
    on the host and loses no request.  The launch counts are this path's
    alone (set to 0 before it; [lm]'s are put back after it)."""
    import repro_torch.cluster as cluster
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    saved = {name: getattr(mod, attr)
             for name, (mod, attr) in _counters().items()}
    saved_idle = read_idle()
    reset_launches()
    try:
        t0 = time.perf_counter()
        runs = {}
        for case in ("lease", "lease_lost"):
            system = PIMSystem(DPUConfig(**LEASE_SYSTEM), mode="async",
                               device="cuda")
            pim = cluster.PimCluster(system, policy="fault_aware",
                                     spare_ranks=2)
            lease = pim.lease("serve_lm", n_ranks=LEASE_RANKS)
            eng, t_serve = _serve_engine(cfg, model, lease.pool,
                                         lose=(system, lease)
                                         if case == "lease_lost" else None)
            out = {rid: r.out for rid, r in eng.requests.items()}
            decode = sum(1 for e in system.timeline.events
                         if e[0] == "kernel" and e[1] == "decode")
            runs[case] = {"ranks": list(lease.ranks),
                          "pool_ticks": lease.pool.ticks,
                          "engine_ticks": eng.ticks, "stats": eng.stats,
                          "decode_launches": decode, "wall_s": t_serve,
                          "tokens_equal": out == want}
            pim.release(lease)
        launches = read_launches()
    finally:
        for name, (mod, attr) in _counters().items():
            setattr(mod, attr, saved[name])
        for name in PIPELINED:
            _counters()[name][0].idle_launches = saved_idle[name]
    ok, lost = runs["lease"], runs["lease_lost"]
    check(ok["tokens_equal"] and lost["tokens_equal"],
          f"[cluster] lease-served tokens differ from the pool-free run: "
          f"{runs}")
    check(ok["pool_ticks"] == ok["engine_ticks"] == ok["decode_launches"]
          == ok["stats"]["pim_ticks"] > 0 and ok["stats"]["host_ticks"] == 0,
          f"[cluster] lease ticks {ok}")
    check(lost["stats"]["pim_ticks"] >= 1 and lost["stats"]["host_ticks"] >= 1
          and lost["pool_ticks"] == lost["decode_launches"],
          f"[cluster] the lost lease {lost}")
    res = {"runs": runs, "launches": launches,
           "seconds": time.perf_counter() - t0}
    log("[cluster] (d) llama3-8b (bf16, full width and depth) served with a "
        f"{LEASE_RANKS}-rank lease: tokens equal to the pool-free engine's; "
        "the lease lost mid-stream: decoded on the host, no request lost; "
        + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# LM serving path: flash attention and the SSD scan
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's flash cases (S, H, KV, Dk, Dv, causal, window)
FLASH_CASES = [(128, 4, 4, 32, 32, True, 0), (128, 8, 2, 16, 16, True, 0),
               (256, 4, 1, 32, 64, True, 0), (128, 4, 4, 32, 32, False, 0),
               (256, 4, 2, 32, 32, True, 64)]
#: shapes that stress the tensor-core flash kernel's tiling (bf16, B 2):
#: S ragged to its 128-row tiles, Dk 192 / Dv 128, Dk = Dv = 256, a window
#: across tiles, bidirectional, GQA with H / KV = 8
FLASH_SM90_CASES = [(1000, 4, 2, 128, 128, True, 0),
                    (256, 4, 2, 192, 128, True, 0),
                    (256, 4, 2, 256, 256, True, 0),
                    (1024, 4, 2, 128, 128, True, 300),
                    (512, 4, 2, 128, 128, False, 0),
                    (512, 16, 2, 128, 128, True, 0)]
#: llama3-8b prefill in the LM main path: 4 prompts of 1024 tokens
FLASH_MAIN = dict(b=4, s=1024, h=32, kv=8, dk=128, dv=128, causal=True,
                  window=0)
#: tests/test_kernels.py's SSD cases as (B, S, H, G, P, N, chunk) — its
#: (BH, S, .) rows are BH heads, each its own group — and a ragged one
SSD_CASES = [(1, 64, 3, 3, 8, 8, 16), (1, 128, 3, 3, 16, 8, 32),
             (1, 128, 3, 3, 32, 16, 64), (1, 96, 3, 3, 8, 8, 96),
             (2, 50, 4, 2, 8, 8, 16)]
#: tests/test_torch_cuda.py's tensor-core SSD cases (bf16): Q 64/128/256,
#: P 16/64/128, N 16/64/128, G 1, H / 2 and H, ragged S, S below the chunk
SSD_TC_CASES = [(1, 256, 4, 2, 16, 16, 64), (2, 300, 4, 1, 64, 64, 128),
                (1, 512, 4, 2, 128, 128, 256), (2, 1000, 6, 3, 64, 128, 256),
                (1, 100, 2, 1, 64, 128, 256), (2, 200, 4, 2, 128, 16, 64),
                (1, 192, 3, 3, 32, 32, 64)]
#: mamba2-130m prefill in the LM main path: 4 prompts of 2048 tokens
SSD_MAIN = dict(b=4, s=2048, h=24, g=1, p=64, n=128, chunk=256)
#: rtol = atol.  In bf16 the outputs are rounded to 8 significant bits,
#: so 1e-2 allows about 1-2 ulps, above the one ulp measured on an H100
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
#: card (kernels) vs CPU (plain versions), float32, TF32 off
LM_PARITY_TOL = 1e-3
#: the parity prompt: 1.5 SSD chunks of mamba2-130m (ssm_chunk 256), so
#: the state carried across chunks and the dt = 0 padded tail both run
LM_PARITY_TOKENS = 384


def _normal(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _flash_inputs(gen, b, s, h, kv, dk, dv, dtype, **_):
    return (_normal(gen, (b, s, h, dk), dtype),
            _normal(gen, (b, s, kv, dk), dtype),
            _normal(gen, (b, s, kv, dv), dtype))


def _ssd_inputs(gen, b, s, h, g, p, n, dtype, **_):
    import torch
    x = _normal(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_normal(gen, (b, s, h), torch.float32))
    A = -torch.exp(_normal(gen, (h,), torch.float32))
    return (x, dt, A, _normal(gen, (b, s, g, n), dtype),
            _normal(gen, (b, s, g, n), dtype))


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _tol_ratio(got, want, tol) -> float:
    """max |got - want| / (tol + tol |want|): at most 1 is within
    ``torch.allclose(got, want, rtol=tol, atol=tol)``."""
    want = want.float()
    return float(((got.float() - want).abs() / (tol + tol * want.abs()))
                 .max())


def phase_lm_kernels() -> dict:
    """Flash and SSD kernels vs their plain versions on the card; returns
    the max |err| of each at its main-path shape in bf16 (the scalar SSD
    kernel's through its raw launcher: bf16 goes to the tensor-core
    route)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    keys = ("s", "h", "kv", "dk", "dv", "causal", "window")
    flash = [(dict(zip(keys, c), b=2), dt) for c in FLASH_CASES
             for dt in ("float32", "bfloat16")]
    flash += [(dict(zip(keys, c), b=2), "bfloat16") for c in FLASH_SM90_CASES]
    flash += [(FLASH_MAIN, "float32"), (FLASH_MAIN, "bfloat16")]
    for shape, dt in flash:
        q, k, v = _flash_inputs(gen, dtype=getattr(torch, dt), **shape)
        kernel = fops.route(q.dtype, shape["dk"], shape["dv"])
        sm90_before = fops.launches_sm90
        got = fops.flash_attention(q, k, v, causal=shape["causal"],
                                   window=shape["window"])
        want = flash_attention_ref(q, k, v, causal=shape["causal"],
                                   window=shape["window"])
        torch.cuda.synchronize()
        err, tol = _max_err(got, want), FLASH_TOL[dt]
        ratio = _tol_ratio(got, want, tol)
        log(f"[kernels] flash_attention ({kernel}) {shape} {dt}: max |err| "
            f"{err:.3g} (tolerance {tol}, rtol = atol; {ratio:.3g} of it "
            "used)")
        check(kernel == ("sm90" if dt == "bfloat16" else "scalar")
              and fops.launches_sm90 - sm90_before == (kernel == "sm90"),
              f"flash_attention at {shape} {dt} ran the {kernel} kernel")
        check(ratio <= 1, f"flash_attention kernel != plain at {shape} {dt}: "
              f"max |err| {err}")
        if shape is FLASH_MAIN and dt == "bfloat16":
            worst["flash_attention"] = err
    keys = ("b", "s", "h", "g", "p", "n", "chunk")
    ssd = [(dict(zip(keys, c)), "float32") for c in SSD_CASES]
    ssd += [(dict(zip(keys, c)), "bfloat16") for c in SSD_TC_CASES]
    ssd += [(SSD_MAIN, "float32"), (SSD_MAIN, "bfloat16")]
    for shape, dt in ssd:
        args = _ssd_inputs(gen, dtype=getattr(torch, dt), **shape)
        kernel = sops.route(args[0].dtype, shape["n"], shape["p"],
                            shape["chunk"])
        tc_before = sops.launches_tc
        y, state = sops.ssd_scan(*args, chunk=shape["chunk"])
        yw, sw = ssd_scan_ref(*args, chunk=shape["chunk"])
        torch.cuda.synchronize()
        check(kernel == ("tc" if dt == "bfloat16" else "scalar")
              and sops.launches_tc - tc_before == (kernel == "tc"),
              f"ssd_scan at {shape} {dt} ran the {kernel} route")
        tol = SSD_TOL[dt]
        err = max(_max_err(y, yw), _max_err(state, sw))
        ratio = max(_tol_ratio(y, yw, tol), _tol_ratio(state, sw, tol))
        log(f"[kernels] ssd_scan ({kernel}) {shape} {dt}: max |err| "
            f"{err:.3g} (tolerance {tol}, rtol = atol; {ratio:.3g} of it "
            "used)")
        check(ratio <= 1, f"ssd_scan {kernel} route != plain at {shape} "
              f"{dt}: max |err| {err}")
        if shape is SSD_MAIN and dt == "bfloat16":
            worst["ssd_scan_tc"] = err
            # the scalar kernel on the same bf16 inputs (raw launcher)
            ssd_scan_cuda(*args, y, state, shape["chunk"])
            torch.cuda.synchronize()
            err = max(_max_err(y, yw), _max_err(state, sw))
            ratio = max(_tol_ratio(y, yw, tol), _tol_ratio(state, sw, tol))
            log(f"[kernels] ssd_scan (scalar, raw launcher) {shape} {dt}: "
                f"max |err| {err:.3g} ({ratio:.3g} of the tolerance used)")
            check(ratio <= 1, f"ssd_scan scalar kernel != plain at {shape} "
                  f"{dt}: max |err| {err}")
            worst["ssd_scan"] = err
    return worst


def _lm_model(arch: str, n_layers=None, dtype=None, seed=0):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, Transformer(cfg, device="cuda", generator=gen)


def phase_lm_parity():
    """Each family at full width, 2 layers, float32: prefill of one
    prompt of LM_PARITY_TOKENS on the card (kernels) and on the CPU
    (plain versions) agree within LM_PARITY_TOL."""
    import torch
    from repro_torch.models.transformer import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("llama3-8b", "mamba2-130m"):
        cfg, gpu = _lm_model(arch, n_layers=2, dtype="float32", seed=1)
        toks = torch.randint(0, cfg.vocab_size, (1, LM_PARITY_TOKENS),
                             generator=torch.Generator().manual_seed(2))
        reset_launches()
        t0 = time.perf_counter()
        lg, cg = gpu.prefill({"tokens": toks.cuda()})
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        launches = read_launches()
        cpu = Transformer(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        del gpu
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lc, cc = cpu.prefill({"tokens": toks})
        t_cpu = time.perf_counter() - t0
        errs = {"logits": _max_err(lg.cpu(), lc)}
        errs.update({k: _max_err(cg[k].cpu(), cc[k]) for k in cc
                     if k != "pos"})
        kernel = "flash_attention" if cfg.family == "dense" else "ssd_scan"
        log(f"[lm] {arch} full width, 2 layers, float32, "
            f"{LM_PARITY_TOKENS} tokens: card "
            f"vs CPU max |err| {errs} (tolerance {LM_PARITY_TOL}); "
            f"{kernel} launches {launches[kernel]}; card {t_gpu:.2f} s, "
            f"CPU {t_cpu:.2f} s")
        check(launches[kernel] == cfg.n_layers,
              f"{arch}: {kernel} launches {launches[kernel]} != 2 layers")
        check(launches["flash_attention_sm90"] == 0
              and launches["ssd_scan_tc"] == 0,
              f"{arch}: float32 reached a bf16 tensor-core kernel")
        bad = {k: e for k, e in errs.items() if not e <= LM_PARITY_TOL}
        check(not bad, f"{arch} card vs CPU prefill differs: {bad}")
        del cpu


def _serve_engine(cfg, model, pim_pool=None, lose=None):
    """A ServeEngine answering 4 requests (32-token prompts, 16 new
    tokens each) on a 4-slot pool, with ``pim_pool`` attached; ``lose``
    (system, lease): the lease's DPUs are disabled after the first tick.
    Returns (the engine, its wall seconds)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, model, batch=4, capacity=64, pim_pool=pim_pool)
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, 32), max_new=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if lose is not None:
        eng.step()
        system, lease = lose
        topo = system.topology
        system.disable_dpus([d for r in lease.ranks for d in range(
            *topo.dpu_slice(r).indices(topo.n_dpus))])
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(len(o) for o in out.values()) == [16] * 4,
          f"ServeEngine outputs {out}")
    return eng, wall


def lm_path(arch: str, prompt_len: int, batch: int = 4,
            decode_steps: int = 32, after=None) -> dict:
    """The LM serving path at full width and depth in bf16: prefill,
    greedy decode steps past it, then a ServeEngine; ``after(cfg, model,
    tokens)``, given, runs last on the loaded model with the engine's
    tokens (its result kept as ``"after"``)."""
    import torch
    import torch.nn.functional as F
    cfg, model = _lm_model(arch, seed=3)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(4), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": toks})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits not finite")
    if cfg.family == "dense":  # room for the decoded tokens
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, decode_steps))
                 if torch.is_tensor(v) else v for k, v in cache.items()}
    nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        logits, cache = model.decode_step(cache, nxt)
        nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()),
          f"{arch}: decode logits not finite")
    check(cache["pos"] == prompt_len + decode_steps,
          f"{arch}: pos {cache['pos']}")
    res = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": batch, "prompt": prompt_len, "prefill_s": t_prefill,
           "prefill_tokens_per_s": batch * prompt_len / t_prefill,
           "decode_steps": decode_steps,
           "decode_ms_per_step": t_decode / decode_steps * 1e3}
    del cache
    eng, wall = _serve_engine(cfg, model)
    res.update({"serve_wall_s": wall, "serve_requests": len(eng.requests),
                "serve_tokens": sum(len(r.out)
                                    for r in eng.requests.values()),
                "serve_ticks": eng.ticks})
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if after is not None:
        res["after"] = after(cfg, model, {rid: r.out for rid, r
                                          in eng.requests.items()})
    return res


def phase_lm_main() -> dict:
    """The LM serving path of both families, with the kernel launch counts
    taken from this run alone: flash once per llama3-8b layer per prefill,
    the SSD scan once per mamba2-130m layer per prefill.  [cluster] (d)
    (:func:`lease_serve`) runs on the loaded llama3-8b, counted apart."""
    import torch
    runs = []
    lease = None
    reset_launches()                       # counts of this path only
    for arch, prompt in (("llama3-8b", 1024), ("mamba2-130m", 2048)):
        torch.cuda.reset_peak_memory_stats()
        runs.append(lm_path(arch, prompt, after=lease_serve
                            if arch == "llama3-8b" else None))
        lease = runs[-1].pop("after", lease)
        log(f"[lm] main path: {json.dumps(runs[-1])}")
        torch.cuda.empty_cache()
    launches = read_launches()
    check(launches["flash_attention"] == 32 * 1,
          f"flash_attention launches {launches['flash_attention']} != 32 "
          "layers x 1 prefill")
    check(launches["flash_attention_sm90"] == launches["flash_attention"],
          f"of {launches['flash_attention']} flash_attention launches, "
          f"{launches['flash_attention_sm90']} on the tensor-core kernel")
    check(launches["ssd_scan"] == 24 * 1,
          f"ssd_scan launches {launches['ssd_scan']} != 24 layers x 1 "
          "prefill")
    check(launches["ssd_scan_tc"] == launches["ssd_scan"],
          f"of {launches['ssd_scan']} ssd_scan launches, "
          f"{launches['ssd_scan_tc']} on the tensor-core route")
    return {"runs": runs, "launches": launches, "lease": lease}


def _flash_work(b, s, h, kv, dk, dv, causal, window, esize):
    """(FLOPs, bytes) of one attention call: two products per visible
    (query, key) pair; q, k, v read once and o written once."""
    import numpy as np
    seen = np.arange(1, s + 1) if causal else np.full(s, s)
    if window > 0:
        seen = np.minimum(seen, window)
    flops = 2.0 * b * h * int(seen.sum()) * (dk + dv)
    nbytes = esize * b * s * (h * dk + kv * (dk + dv) + h * dv)
    return flops, nbytes


def _ssd_work(b, s, h, g, p, n, chunk, esize):
    """(FLOPs, bytes) of one SSD scan: per chunk of r rows, C.B over the
    r(r+1)/2 causal pairs once per group, the weighted x for every head,
    and the inter-chunk and state products (2 r N P each); x, B, C, dt, A
    read once, y and the final state written once."""
    q = min(chunk, s)
    flops = 0.0
    for c0 in range(0, s, q):
        r = min(q, s - c0)
        pairs = r * (r + 1) // 2
        flops += b * (g * pairs * 2 * n + h * (pairs * 2 * p + 4 * r * n * p))
    nbytes = (esize * b * s * (2 * h * p + 2 * g * n) + 4 * b * s * h
              + 4 * h + 4 * b * h * n * p)
    return flops, nbytes


def _bound(flops, nbytes, flops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_lm_kernel_times() -> dict:
    """Device ms per call at the main path's shapes (bf16) of each kernel
    (raw launcher, uncounted), its plain version and, for flash, the
    PyTorch library call that computes the same function and the scalar
    kernel in bf16 (the kernel the tensor-core one replaced there); for
    the SSD scan both routes in turns; each between CUDA events in this
    one call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_sm90_cuda)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        ssd_scan_cuda, ssd_scan_tc_cuda)
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    res = {}
    fm = FLASH_MAIN
    q, k, v = _flash_inputs(gen, dtype=bf16, **fm)
    out = torch.empty((fm["b"], fm["s"], fm["h"], fm["dv"]), dtype=bf16,
                      device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flops, nbytes = _flash_work(esize=2, **fm)
    bound_ms, bound_by = _bound(flops, nbytes, BF16_FLOPS_PER_S)
    r = res["flash_attention"] = {
        "ms": cuda_time_ms(lambda: flash_attention_sm90_cuda(
            q, k, v, out, True, 0), n=100, warm=10),
        "scalar_ms": cuda_time_ms(lambda: flash_attention_cuda(
            q, k, v, out, True, 0), n=10, warm=2),
        "plain_ms": cuda_time_ms(lambda: flash_attention_ref(q, k, v),
                                 n=3, warm=1),
        "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n=100, warm=10),
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
        "bytes": nbytes}
    r["tflops"] = flops / r["ms"] / 1e9
    r["bound_share"] = bound_ms / r["ms"]
    r["library_ratio"] = r["ms"] / r["library_ms"]
    r["scalar_speedup"] = r["scalar_ms"] / r["ms"]
    sm = SSD_MAIN
    args = _ssd_inputs(gen, dtype=bf16, **sm)
    y = torch.empty_like(args[0])
    state = torch.empty((sm["b"], sm["h"], sm["n"], sm["p"]),
                        dtype=torch.float32, device="cuda")
    flops, nbytes = _ssd_work(esize=2, **sm)
    bound_ms, bound_by = _bound(flops, nbytes, BF16_FLOPS_PER_S)
    plain_ms = cuda_time_ms(lambda: ssd_scan_ref(*args, chunk=sm["chunk"]),
                            n=3, warm=1)
    # the two routes in turns: scalar, tensor cores, tensor cores, scalar
    tc_ms, scalar_ms = [], []
    for times, fn, n in ((scalar_ms, ssd_scan_cuda, 10),
                         (tc_ms, ssd_scan_tc_cuda, 100),
                         (tc_ms, ssd_scan_tc_cuda, 100),
                         (scalar_ms, ssd_scan_cuda, 10)):
        times.append(cuda_time_ms(lambda: fn(*args, y, state, sm["chunk"]),
                                  n=n, warm=3))
    for name, times in (("ssd_scan_tc", tc_ms), ("ssd_scan", scalar_ms)):
        res[name] = {"ms": sum(times) / 2, "ms_runs": times,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "flops": flops, "bytes": nbytes}
    r = res["ssd_scan_tc"]
    r["bound_share"] = bound_ms / r["ms"]
    r["scalar_speedup"] = res["ssd_scan"]["ms"] / r["ms"]
    for name, r in res.items():
        log(f"[kernels] {name} at the main path's shape, bf16: "
            + json.dumps(r))
    r = res["flash_attention"]
    log(f"[kernels] flash_attention at {FLASH_MAIN}, bf16: tensor-core "
        f"kernel {r['ms']:.5f} ms ({r['tflops']:.1f} TFLOP/s, "
        f"{r['bound_share']:.3f} of the {r['bound_ms']:.5f} ms bound); "
        f"scalar kernel {r['scalar_ms']:.4f} ms ({r['scalar_speedup']:.1f}x "
        f"slower); SDPA {r['library_ms']:.5f} ms (kernel / SDPA "
        f"{r['library_ratio']:.3f})")
    r = res["ssd_scan_tc"]
    log(f"[kernels] ssd_scan at {SSD_MAIN}, bf16: tensor-core route "
        f"{r['ms']:.5f} ms ({r['bound_share']:.3f} of the "
        f"{r['bound_ms']:.5f} ms bound); scalar kernel "
        f"{res['ssd_scan']['ms']:.4f} ms ({r['scalar_speedup']:.1f}x "
        "slower)")
    return res


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="VA scale of the full-width main-path run "
                         "(1.0 = 16,368 elements per DPU)")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    card = gpu_name_power()
    log(f"[card] {torch.cuda.get_device_name(0)}; {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    try:
        phase_build()
        err = phase_kernels()
        lm_err = phase_lm_kernels()
        step_run = phase_step()
        step_err = step_run["max_abs_err"]
        phase_golden()
        full = phase_full_parity()
        main_run = phase_main_path(args.scale)
        step_times = phase_step_times(
            main_run.pop("launch_args"),
            n=max(1, min(100, main_run["launches"] - 11)))
        from repro_torch.core.compile_cache import dpu_bucket
        times = phase_kernel_times(dpu_bucket(_full_cfg().n_dpus))
        work = phase_workloads()
        simt_run = phase_simt()
        system_run = phase_system()
        cluster_run = phase_cluster(work.pop("recordings"))
        phase_lm_parity()
        lm_run = phase_lm_main()
        lm_times = phase_lm_kernel_times()
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    carry = step_run["va_us_per_step"]
    kernels = [{
        "name": "alu_exec", "route": "cuda",
        "source": "src/repro_torch/kernels/alu_exec/csrc/alu_exec.cu",
        "replaces": "src/repro/kernels/alu_exec/alu_exec.py:50",
        "launches": main_run["alu_exec_launches"], "max_abs_err": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None,
    }, {
        "name": "cycle_step", "route": "cuda",
        "source": "src/repro_torch/kernels/cycle_step/csrc/cycle_step.cu",
        "replaces": "src/repro/kernels/alu_exec/alu_exec.py:57",
        "launches": main_run["launches"], "max_abs_err": step_err,
        "ms": step_times["ms"], "plain_ms": step_times["plain_ms"],
        "bound_ms": step_times["bound_ms"],
        "bound_by": step_times["bound_by"], "library_ms": None,
        "idle_launches": main_run["idle_launches"],
        "kernel_route": step_times["route"],
        "routes": {r: v["ms"] for r, v in step_times["routes"].items()},
        # [cluster]: the measured profiles of (a) and (b), BFS recorded (c)
        "cluster_launches": {
            "goldens": cluster_run["goldens"]["cycle_step_launches"],
            **{k["kind"]: k["cycle_step_launches"]
               for k in cluster_run["full"]["kinds"]},
            "trace": cluster_run["trace"]["cycle_step_launches"]},
    }, {
        # above the resident limit: the full-system path ([system]'s VA),
        # timed at VA's launch at 2,560 DPUs ([step]) beside stepwise
        "name": "cycle_step (resident_carry)", "route": "cuda",
        "source": "src/repro_torch/kernels/cycle_step/csrc/cycle_step.cu",
        "replaces": "src/repro/kernels/alu_exec/alu_exec.py:57",
        "launches": system_run["va"]["launches"], "max_abs_err": step_err,
        "ms": carry["ms"], "plain_ms": carry["plain_ms"],
        "bound_ms": carry["bound_ms"], "bound_by": carry["bound_by"],
        "library_ms": None,
        "idle_launches": system_run["va"]["idle_launches"],
        "kernel_route": "resident_carry",
        "routes": {r: v["ms"] for r, v in carry["routes"].items()},
    }]
    for name, times, src, csrc in (
            ("simt_step", simt_run["simt_times"], "src/repro/core/simt.py:83",
             "simt_step/csrc/simt_step.cu"),
            ("crf_step", simt_run["crf_times"], "src/repro/core/hbmpim.py:208",
             "crf_step/csrc/crf_step.cu")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{csrc}", "replaces": src,
            "launches": simt_run[f"{name}_launches"],
            "max_abs_err": times["max_abs_err"],
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": None,
            "idle_launches": simt_run[f"{name}_idle_launches"],
            "kernel_route": times["route"],
            "routes": {r: v["ms"] for r, v in times["routes"].items()}})
    replaces = {
        "flash_attention":
            ("src/repro/kernels/flash_attention/flash_attention.py:67",
             "flash_attention/csrc/flash_attention_sm90.cu"),
        "ssd_scan": ("src/repro/kernels/ssd_scan/ssd_scan.py:57",
                     "ssd_scan/csrc/ssd_scan.cu"),
        "ssd_scan_tc": ("src/repro/kernels/ssd_scan/ssd_scan.py:57",
                        "ssd_scan/csrc/ssd_scan_tc.cu")}
    # the scalar SSD kernel's launches on the main path: those of neither
    # route but the tensor-core one
    launched = dict(lm_run["launches"])
    launched["ssd_scan"] -= launched["ssd_scan_tc"]
    lease = lm_run["lease"]
    for name, (src, csrc) in replaces.items():
        r = lm_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{csrc}",
            "replaces": src, "launches": launched[name],
            "max_abs_err": lm_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # [cluster] (d): the ServeEngine on a lease decodes through
    # decode_step, which reaches no flash kernel (prefill does)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["lease_launches"] = lease["launches"]["flash_attention"]
    lm = {r["arch"]: r for r in lm_run["runs"]}
    log("[report] LM serving (bf16, 4 prompts): " + "; ".join(
        f"{a} prefill {r['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{r['decode_ms_per_step']:.3f} ms/step, ServeEngine "
        f"{r['serve_wall_s']:.3f} s" for a, r in lm.items()))
    log(f"[report] full-width cold launch {full['cold_s']:.3f} s, warm "
        f"{full['warm_s']:.3f} s; main path {main_run['kips']:.3f} KIPS, "
        f"{main_run['cycles_per_s']:.1f} simulated cycles/s, "
        f"{main_run['steps_per_s']:.1f} steps/s, cycle_step "
        f"{step_times['us_per_step']:.3f} µs a step; at "
        f"{FULL_SYSTEM_DPUS} DPUs (cross_dpu, VA) resident_carry "
        + ", ".join(f"{r['routes']['resident_carry']['us_per_step']:.2f}"
                    for r in (step_run["us_per_step"][FULL_SYSTEM_DPUS],
                              carry))
        + " µs a step, stepwise "
        + ", ".join(f"{r['routes']['stepwise']['us_per_step']:.2f}"
                    for r in (step_run["us_per_step"][FULL_SYSTEM_DPUS],
                              carry))
        + f"; smoke {time.perf_counter() - t_start:.1f} s; card: {card}")
    sva = system_run["va"]
    log(f"[report] system: VA on {FULL_SYSTEM_DPUS} DPUs (1 MiB, scale 1.0) "
        f"{sva['wall_s']:.3f} s, {sva['kips']:.1f} KIPS, "
        f"{sva['steps_per_s']:.1f} steps/s, set-up share "
        f"{sva['outside_share']:.3f}, cycles {sva['cycles']} (64 DPUs: "
        f"{sva['cycles_64_dpus']}); BFS at {FULL_SYSTEM_DPUS} DPUs equal on "
        "resident_carry and stepwise")
    log(f"[report] simt: {simt_run['cases']} kernel cases bitwise, "
        f"{simt_run['golden_runs']} golden runs equal; Fig. 11 full width "
        + ", ".join(f"{r['design']} {r['wall_s']:.3f} s ({r['cycles']} "
                    f"cycles)" for r in simt_run["fig11"])
        + f"; simt_step {simt_run['simt_times']['us_per_step']:.3f} µs a "
        f"step, crf_step {simt_run['crf_times']['us_per_step']:.3f} µs a "
        "command")
    cg, cf, ct = (cluster_run[k] for k in ("goldens", "full", "trace"))
    log(f"[report] cluster: {cg['runs']} golden reports equal (measured "
        f"profiles, {cg['cycle_step_launches']} cycle_step launches); full "
        "width measured profiles " + ", ".join(
            f"{k['kind']} {k['wall_s']:.3f} s ({k['cycle_step_launches']} "
            f"launches, set-up {k['outside_share']:.3f})" for k in cf["kinds"])
        + f"; BFS full-width trace live {ct['live_s']:.3f} s, replay "
        f"{ct['replay_s']:.4f} s ({ct['speedup']:.0f}x), bit-exact; "
        f"{ct['golden_replays']} {TRACE_KEY} replays equal; lease "
        f"{lease['runs']['lease']['pool_ticks']} ticks, tokens equal, lost "
        f"lease decoded on the host; phase {cluster_run['seconds']:.1f} s "
        f"+ lease {lease['seconds']:.1f} s")
    log(f"[report] workloads: {work['golden_runs']} golden runs equal; full "
        f"width KIPS " + ", ".join(f"{r['workload']} {r['kips']:.1f}"
                                   for r in work["full"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
