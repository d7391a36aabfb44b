#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--scale S]

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every CUDA kernel (alu_exec, cycle_step,
             simt_step, crf_step, flash_attention's scalar and
             tensor-core forwards and backwards, ssd_scan's scalar and
             tensor-core forwards and backwards; sm_90a) from the sources
             in the checkout, all twelve libraries at once, into
             build/repro_torch/; the registers and spills (ptxas -v) of
             cycle_step, simt_step, crf_step and of the tensor-core SSD
             and flash-backward kernels are logged; the SASS (cuobjdump)
             of every instance of the tensor-core flash forward and
             backward kernels must hold HGMMA (wgmma), of the tensor-core
             SSD forward and backward kernels HMMA (mma.sync);
2. kernels — each kernel against its plain-torch version on the card: the
             ALU bitwise (tolerance 0); flash attention at the cases of
             tests/test_kernels.py (f32 2e-5 on the scalar kernel, bf16
             1e-2 on the tensor-core one), at shapes that stress the
             tensor-core kernel's tiling and at every family's prefill
             shape (llama3-8b's; qwen3-moe's GQA 8:1, deepseek's MLA with
             Dk 192 / Dv 128, recurrentgemma's MQA with a 2,048-token
             window at D 256, seamless's bidirectional encoder at D 64,
             llava's 4,096 patch-prefixed positions);
             the SSD scan's scalar kernel at its test cases and at
             mamba2-130m's prefill shape (f32 2e-4, bf16 1e-2), its
             tensor-core route at the card tests' shapes and at that
             prefill shape (bf16 1e-2); the scalar kernels past their
             whole-row instances (the head-tiled ones, float32): flash
             at Dk 320 / Dv 288 and Dk 272 / Dv 64 (causal,
             bidirectional, windowed, MQA) and at recurrentgemma-9b's
             attention shape widened to Dk 320 / Dv 288, the SSD scan
             at N 192 / P 160, N 144 / P 200, N = P = 128 and at
             mamba2-130m's prefill shape widened to N 192, P 160, chunk
             96;
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
8. lm      — (a) card vs CPU, float32 (TF32 off), one prompt of 384
             positions, at full width but cut depth: llama3-8b,
             mamba2-130m (two SSD chunks, the second ragged) and
             qwen3-moe-30b-a3b at 2 layers, recurrentgemma-9b at one
             (rglru, rglru, local) group, seamless-m4t-large-v2 at one
             encoder and one decoder layer (384 frames, then its BOS
             step), llava-next-mistral-7b at 2 layers (256 patches + 128
             tokens), deepseek-v3-671b at its smoke width: prefill logits
             and every cache leaf agree within 1e-3, one scalar flash
             launch an attention layer; (b) the LM serving path of every
             family at full width in bf16 (LM_PATHS): two prefills (the
             second timed), 32 greedy decode steps, and a ServeEngine
             answering 4 requests, one model loaded at a time, each run's
             launches counted alone, per prefill:
             llama3-8b (4 x 1,024 tokens; 32 flash launches),
             mamba2-130m (4 x 2,048; 24 SSD scans on the tensor-core
             route), qwen3-moe-30b-a3b at 24 of 48 layers (4 x 1,024;
             24), deepseek-v3-671b at 1 dense + 1 MoE layer (1 x 256; 2),
             recurrentgemma-9b (4 x 4,096, the window ring wrapped; 12),
             seamless-m4t-large-v2 (4 x 1,024 frames, then BOS; 24, its
             encoder), llava-next-mistral-7b (4 x (2,880 patches + 1,216
             tokens); 32), every flash launch on the tensor-core kernel,
             finite logits, peak memory under 80 GB;
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
             wall, cycle_step launches and set-up share; the profiles
             equal to tests/data/cluster_profiles_wide.json, which the CPU
             tests feed both packages), the report equal
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
11. scripts — the paper's study scripts through their twins on the
             card: benchmarks/torch_engine_perf.py --scale 1.0 --check in a
             process of its own (its launch probe, subset launches and BS
             rows equal to goldens.json, VA's cycles and issued per DPU
             equal at 1, 4, 16 and 64 DPUs and to [workloads]'s full-width
             VA; cold, warm, KIPS, steps per second, set-up share); then
             in this process, each in an empty working directory of its
             own, every run of tools/script_runs.py's SCRIPT_RUNS (the
             seven examples, the design sweep and the offload planner
             among them, torch_fault_tolerance.py with --smoke and
             --check, torch_overlap_scaling.py, torch_rank_overlap.py,
             and torch_run.py's suites but lm under --trace, with --check
             but for the overload suite, whose check fails in the
             reference too, ROADMAP §3): exit 0, no error row, the
             printed lines (wall-clock numbers masked) equal to
             goldens.json's, the figs suite's characterization simulated
             in the run (its cycle_step launches counted), each with its
             wall and launches;
12. train — the training path (repro_torch.train): (a) the backward
             kernels on both routes (bf16 to the tensor-core ones,
             flash_attention_bwd_sm90.cu and ssd_scan_bwd_tc.cu; float32
             to the scalar ones, flash_attention_bwd.cu and
             ssd_scan_bwd.cu), one counted backward each on its route,
             against autograd of their plain versions, f32 1e-4 and bf16
             2e-2 of each gradient's largest value, deterministic, the
             training forward's output bitwise the serving one's, at the
             cases of [kernels] (flash's tensor-core tiling cases, the
             SSD tensor-core cases up to N = P = 128), llama3-8b's
             training shape (1 x 4,096, H 32, KV 8, D 128),
             recurrentgemma-9b's attention (1 x 4,096, H 16, KV 1, D 256,
             window 2,048; bf16 and float32, the scalar pair's head-tiled
             kernels), the quickstart's (f32), mamba2-130m's (4 x 4,096)
             and the wide cases of [kernels] (f32); each route and each
             kernel of a pair timed apart, beside the plain backward,
             the bound and (flash) SDPA's backward (float32's at
             recurrentgemma's shape); the head-tiled forwards and
             backwards timed at the wide timing shapes; the tensor-core
             flash backward at each family's training shape beside
             SDPA's; (b) one step's gradients of
             every family at full width (TRAIN_PATHS: llama3-8b 4 of 32
             layers, mamba2-130m 24, qwen3-moe-30b-a3b 3 of 48,
             deepseek-v3-671b its dense MLA layer, recurrentgemma-9b 6
             of 38, seamless-m4t-large-v2 24 + 24, llava-next-mistral-7b
             4 of 32), 4 x 1,024 tokens (llava 4 x 4,096, deepseek 8
             sequences), kernels against plain versions in bf16 (every
             leaf finite and not zero, within 5e-2, or held to the
             float32 step where bf16 noise dominates) and in float32
             (1e-3; recurrentgemma's D 256 on the scalar pair's
             head-tiled kernels), a MoE's expert choices replayed
             between the runs compared, each step's launches as
             reckoned; (c) the same models at 4,096 tokens a sequence
             (train_4k's), the config's optimizer, remat and
             microbatches: a warm-up step, then three timed (s a step,
             tokens/s, peak GB; the RG-LRU scan's share), each kernel's
             launches equal to the reckoned ones, every bf16 backward
             on the tensor-core routes; (d)
             examples/torch_quickstart.py from the reference's initial
             weights and batches: its lines those of goldens.json; (e)
             python -m repro_torch.launch.train --smoke: exit 0, losses
             falling; run_with_restarts with two injected failures:
             every parameter bit-equal to the run without;
13. launch — (a) python -m repro_torch.launch.dryrun in processes of
             their own (started before [train] at the lowest CPU
             priority, collected here): the 16x16 mesh's every arch x
             shape and the
             2x16x16 mesh's for llama3-8b, mamba2-130m and qwen3-moe
             (the port's sharded program as ranks all-0 and all-last of a
             fake group, priced on H100s, each collective over its
             group's slowest link), each row OK or SKIP(policy), named for
             its mesh, collective_ms >= 0, the PIM cell on each mesh (its
             DPUs over the ranks, one vote a K-block); the one-card rows
             of the hillclimb's architectures and the PIM cell (2,560
             DPUs, one cycle_step launch); each row's compute, memory,
             collective ms and GiB a device; (e) the 2,560-DPU VA launch
             split over four ranks sharing the card (gloo, 640 DPUs a
             rank on cycle_step's resident route, one vote a K-block;
             the ranks' CUDA contexts wait without spinning):
             every rank's block bitwise [system]'s one-process run (its
             digests), cycle_step launched on every rank, the votes, their
             bytes, each rank's wall and set-up share; (f) llama3-8b and
             mamba2-130m at full width, 2 layers, bf16, sharded on a
             (data 2, model 2) mesh of four ranks: a prefill of 2 x 1,024
             and 8 decode steps, logits within 2e-2 of a one-process run,
             the sm90 flash or the tensor-core SSD scan launched once a
             layer on every rank; the phase within 150 s; (b) llama3-8b's and
             mamba2-130m's prefill_32k sequence cut to 2 layers and batch
             1, bf16, run for real: each wall at least its row's
             max(compute, memory) (a miscounted row fails here), one flash
             or tensor-core SSD launch a layer, max_memory_allocated
             beside the row's args + out + temp; (c)
             repro_torch.parallel on a process group of one rank (NCCL and
             gloo, a FileStore): quantize_int8 bitwise card vs CPU, each of
             the reference's scenario_compressed_dp's 60 steps on the card
             from the CPU run's state within 1e-6, the card's own run
             through the scenario's gate, pipeline_apply at one stage equal
             to the stage in sequence; (d) the offload planner's twin among
             [scripts]' golden runs, benchmarks/torch_run.py --suite lm
             reading (a)'s one-card rows with no error row, the hillclimb
             twin exit 0 with its cells equal to (a)'s;
14. mesh   — sharded training: four ranks sharing the card (processes
             on gloo, a FileStore; started while this process takes the
             reference step), on a (data 2, model 2) mesh, take one step
             of qwen3-moe-30b-a3b at full width and 1 of its 48 layers
             (bf16 on float32 weights from a seed, AdamW, its 4
             microbatches, 8 x 1,024 tokens): each rank's parameters and
             moments its blocks by param_shardings, its rows by
             batch_sharding, tensor and sequence parallel on model (each
             rank's heads in the flash kernels), its experts
             expert-parallel (gathered over data, as the reference's);
             the loss, every gradient and
             every update within 2e-2 of a one-process step on the card
             with moe_ep_plain in the EP group's place (the experts'
             choices replayed; an update less what the two gradients
             put between AdamW's first steps); the
             tensor-core flash forward and backward launched on every
             rank, 8 and 4 times; the phase within 90 s; the state
             saved from (2, 2) by rank 0 and restored onto
             (4, 1) and as one rank, every block and leaf bitwise the
             saved one; the step's wall, each rank's
             max_memory_allocated and collectives by kind (calls, bytes,
             seconds), the kernel's shapes a rank;
15. report — the kernels line (launches, times, bounds; each step
             kernel's routes; the backward kernels; [mesh]'s launches),
             the card's name and power limit, and the result line.

Imports neither JAX nor the JAX package: the card's machine has no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
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
#: a function's peak by the type it computes in
FLOPS_PER_S = {"bfloat16": BF16_FLOPS_PER_S, "float32": SCALAR32_OPS_PER_S}

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
    ssd_scan both SSD routes, ssd_scan_tc the tensor-core one; the _bwd
    counts a backward pass each on either route, the _bwd_sm90 and
    _bwd_tc counts those on the tensor-core routes."""
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
            "ssd_scan_tc": (ssd_ops, "launches_tc"),
            "flash_attention_bwd": (flash_ops, "launches_bwd"),
            "flash_attention_bwd_sm90": (flash_ops, "launches_bwd_sm90"),
            "ssd_scan_bwd": (ssd_ops, "launches_bwd"),
            "ssd_scan_bwd_tc": (ssd_ops, "launches_bwd_tc")}


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
    """Build the twelve kernel libraries concurrently (one nvcc each),
    log the registers and spills of cycle_step, simt_step, crf_step and
    of the tensor-core SSD and flash-backward kernels, then check that
    every instance of the tensor-core flash kernels (forward and
    backward) runs its products on wgmma (HGMMA in its SASS) and every
    instance of the tensor-core SSD kernels (forward and backward) on
    mma.sync (HMMA)."""
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
            "flash_attention_bwd": flash_attention.library_bwd,
            "flash_attention_bwd_sm90": flash_attention.library_bwd_sm90,
            "ssd_scan": ssd_scan.library,
            "ssd_scan_tc": ssd_scan.library_tc,
            "ssd_scan_bwd": ssd_scan.library_bwd,
            "ssd_scan_bwd_tc": ssd_scan.library_bwd_tc}
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
    for lib in ("ssd_scan_tc", "ssd_scan_bwd_tc",
                "flash_attention_bwd_sm90"):
        tc = _ptxas_report(built[lib]).values()
        log(f"[build] {lib} (ptxas -v, {len(tc)} kernels): registers "
            f"{min(t[0] for t in tc)}-{max(t[0] for t in tc)}, spill "
            f"stores up to {max(t[1] for t in tc)} B, spill loads up to "
            f"{max(t[2] for t in tc)} B")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    # (library, SASS op, the kernels every instance of which must hold it)
    for lib, op, kernels in (
            ("flash_attention_sm90", "HGMMA", ("flash_sm90_kernel",)),
            ("flash_attention_bwd_sm90", "HGMMA",
             ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90")),
            ("ssd_scan_tc", "HMMA", ("ssd_chunk_state", "ssd_chunk_scan")),
            ("ssd_scan_bwd_tc", "HMMA", ("ssd_bwd_chunk_state",
                                         "ssd_bwd_keys", "ssd_bwd_queries"))):
        funcs = _sass_functions(built[lib], cuobjdump)
        counts = {k: [f.count(op) for name, f in funcs.items() if k in name]
                  for k in kernels}
        check(all(c and min(c) > 0 for c in counts.values()),
              f"{lib}: {op} counts by instance {counts}: the products are "
              "not on the tensor cores")
        log(f"[build] {lib} SASS: " + ", ".join(
            f"{len(c)} {k} instances" for k, c in counts.items())
            + f", each with {op} ("
            + ", ".join(f"{min(c)}-{max(c)}" for c in counts.values())
            + " an instance)")
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
    # cross_pair's program is cross_dpu's, sized by DPU pair for [launch]
    # (e), which holds its sharded runs to one-process card runs
    runs = [(name, None, STEP_ROUTES, None)
            for name in sorted(cases.CASES) + ["cache_va"]
            if not name.startswith("cross_pair")]
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


def _run_digests(st, rep=None, timeline=None) -> dict:
    """sha256 digests of a run, to hold another process's run to it bit
    for bit: ``state`` {leaf: its bytes, dtype and shape}, and where given
    the ``KernelReport``'s fields and the ``Timeline``'s (as
    :func:`_same_report` and :func:`_same_timeline` compare them)."""
    import dataclasses
    import hashlib
    import numpy as np

    def sha(b) -> str:
        return hashlib.sha256(b).hexdigest()

    def plain(x):
        if isinstance(x, np.ndarray):
            return [str(x.dtype), x.shape, x.tolist()]
        return np.asarray(x).tolist() if isinstance(x, np.generic) else x

    def leaf(v) -> str:
        v = np.ascontiguousarray(v)
        h = hashlib.sha256(v.reshape(-1).view(np.uint8))
        h.update(repr((v.dtype.str, v.shape)).encode())
        return h.hexdigest()

    out = {"state": {k: leaf(v) for k, v in st.items()}}
    if rep is not None:
        out["report"] = sha(json.dumps(
            {f.name: plain(getattr(rep, f.name))
             for f in dataclasses.fields(rep)}, default=plain).encode())
    if timeline is not None:
        out["timeline"] = sha(json.dumps(
            {n: getattr(timeline, n) for n in (
                "h2d", "kernel", "d2h", "inter_dpu", "retry", "shed",
                "events", "elapsed", "total")}, default=plain).encode())
    return out


def _digest_diff(got: dict, want: dict) -> list:
    """What differs between two :func:`_run_digests`."""
    bad = sorted(k for k in set(got["state"]) | set(want["state"])
                 if got["state"].get(k) != want["state"].get(k))
    return bad + [k for k in ("report", "timeline")
                  if k in want and got.get(k) != want[k]]


def _timed_run(cfg, name: str, scale: float, kernel: str,
               digests: bool = False) -> dict:
    """Workload ``name`` on a card system of ``cfg``, its numpy oracle
    inside ``run()``: the wall, the simulation rate, the launches of the
    ``kernel`` counter, the driver's launches, and the share of the wall
    spent outside the driver's K-step loops (set-up: the state and MRAM
    image to the card and back, the host's work); ``digests``: the final
    state's, the report's and the timeline's (:func:`_run_digests`)."""
    import torch
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    mod, attr = _counters()[kernel]
    system = _system(cfg, "cuda")
    s0 = compile_cache.stats()
    l0, i0 = getattr(mod, attr), mod.idle_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, rep = wl.get(name).run(system, 16, scale=scale, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
           "outside_share": 1.0 - (s1["loop_s"] - s0["loop_s"]) / wall}
    if digests:
        res["digests"] = _run_digests(st, rep, system.timeline)
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
        cfg, "VA", 1.0, "cycle_step", digests=True))
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
        + json.dumps({k: v for k, v in va.items() if k != "digests"}))
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
    s0 = compile_cache.stats()
    reset_launches()                       # counts of this path only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = measure_profile(kind, n_dpus=per_rank, scale=CLUSTER_FULL_SCALE,
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, idle = read_launches(), read_idle()
    s1 = compile_cache.stats()
    steps = s1["steps"] - s0["steps"]
    res = {"kind": kind, "dpus": per_rank, "tasklets": 8,
           "scale": CLUSTER_FULL_SCALE, "wall_s": wall,
           "profile_steps": len(prof.steps),
           "sim_launches": s1["launches"] - s0["launches"], "steps": steps,
           "cycle_step_launches": launches["cycle_step"],
           "idle_launches": idle["cycle_step"],
           "outside_share": 1.0 - (s1["loop_s"] - s0["loop_s"]) / wall}
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
    # the same profiles (measure_profile's cache) against the recording
    # the CPU tests feed both packages (tests/test_torch_cluster_wide.py)
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_profiles", ROOT / "tools/torch_cluster_profiles.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    check(tool.RANK == dict(n_dpus=CLUSTER_FULL_SYSTEM["n_dpus"]
                            // CLUSTER_FULL_SYSTEM["n_ranks"], n_threads=8,
                            scale=CLUSTER_FULL_SCALE, seed=0,
                            mram_bytes=1 << 21),
          f"[cluster] tools/torch_cluster_profiles.py's rank {tool.RANK}")
    wide = json.loads(json.dumps(tool.measure("cuda")["profiles"]))
    check(wide == json.loads(tool.OUT.read_text())["profiles"],
          f"[cluster] (b)'s measured profiles differ from {tool.OUT}")
    log(f"[cluster] (b) the measured profiles equal "
        f"{tool.OUT.relative_to(ROOT)}")
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
# the paper's study scripts: the entry-point twins
# ---------------------------------------------------------------------------

#: where [scripts] writes what a twin writes (gitignored)
OUT_DIR = ROOT / "chiprun_out"
#: torch_engine_perf.py's arguments: VA at 1, 4, 16 and 64 DPUs x 16
#: tasklets, 2 MiB, scale 1.0 (the main path's cell at full width)
ENGINE_PERF_ARGV = ["--scale", "1.0", "--check"]
#: the golden runs that simulate nothing: the rank-overlap study prices
#: modeled launches, the cluster and overload suites replay synthetic
#: job profiles
ENGINE_FREE = ("rank_overlap", "run --suite cluster", "run --suite overload")
#: the golden run whose figures 5-9 come from the per-thread
#: characterization (torch_pim_figs.characterize, cached under reports/
#: in the working directory)
CHAR_RUN = "run --suite figs"


def _script_runs():
    """tools/script_runs.py: the entry points' golden runs, the loader
    and the wall-clock masks the goldens were written with."""
    if str(ROOT / "tools") not in sys.path:
        sys.path.insert(0, str(ROOT / "tools"))
    import script_runs
    return script_runs


def _engine_perf(main_va: dict) -> dict:
    """torch_engine_perf.py --scale 1.0 --check in a process of its own
    (so that its cold launch loads the kernel library, built by [build]):
    exit 0 (warm < cold, no new driver for the subset launches); its
    launch probe, subset launches and BS rows equal to goldens.json's
    engine_perf rows; VA's cycles, and its issued instructions per DPU,
    equal at 1, 4, 16 and 64 DPUs (VA's control flow ignores the data),
    and at 64 DPUs equal to [workloads]'s full-width VA (``main_va``)."""
    from repro_torch.workloads import goldens
    sr = _script_runs()
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "engine_perf.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks/torch_engine_perf.py"),
         *ENGINE_PERF_ARGV, "--json", str(path)],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "[scripts] torch_engine_perf.py "
          f"{' '.join(ENGINE_PERF_ARGV)} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    rep = json.loads(path.read_text())
    check(rep["device"]["type"] == "cuda", f"[scripts] engine_perf ran on "
          f"{rep['device']}")
    gold = goldens.load()["scripts"]["engine_perf"]
    va = [r for r in rep["steady_state"] if r["workload"] == "VA"]
    got = {"launch": rep["launch"], "subset_reuse": rep["subset_reuse"],
           **{f"BS event_skip={r['event_skip']}": r
              for r in rep["steady_state"] if r["workload"] == "BS"}}
    wall_keys = sr.wall_keys("engine_perf")
    # main() names a BS row's knob in the row; the golden, in its key
    drop = sr.PORT_KEYS["engine_perf"] + ("event_skip",)
    got = json.loads(json.dumps({k: sr.modeled(v, wall_keys, drop)
                                 for k, v in got.items()}))
    bad = [k for k in gold if got.get(k) != gold[k]]
    check(not bad, f"[scripts] engine_perf rows differ from goldens.json: "
          f"{ {k: (got.get(k), gold[k]) for k in bad} }")
    check([r["dpus"] for r in va] == [1, 4, 16, 64]
          and len({r["cycles"] for r in va}) == 1
          and len({r["issued"] // r["dpus"] for r in va}) == 1
          and all(r["issued"] % r["dpus"] == 0 for r in va),
          f"[scripts] engine_perf's VA rows differ across DPU counts: "
          f"{[(r['dpus'], r['cycles'], r['issued']) for r in va]}")
    check(va[-1]["cycles"] == main_va["cycles"]
          and va[-1]["issued"] == main_va["issued"],
          f"[scripts] engine_perf's VA at 64 DPUs ({va[-1]['cycles']} "
          f"cycles, {va[-1]['issued']} issued) differs from [workloads]'s "
          f"({main_va['cycles']}, {main_va['issued']})")
    check(rep["launches"]["cycle_step"] > 0, "[scripts] engine_perf "
          "launched no cycle_step")
    lat, sub = rep["launch"], rep["subset_reuse"]
    out = {"wall_s": wall, "launches": rep["launches"],
           "cold_s": lat["cold_s"], "warm_s": lat["warm_s"],
           "speedup": lat["speedup"], "new_compiles": sub["new_compiles"],
           "steady_state": [{k: r[k] for k in (
               "workload", "dpus", "event_skip", "cycles", "issued", "run_s",
               "kips", "steps", "steps_per_s", "loop_s", "outside_share")
               if k in r} for r in rep["steady_state"]]}
    log("[scripts] torch_engine_perf.py " + " ".join(ENGINE_PERF_ARGV)
        + ": check passed, launch probe, subset launches and BS rows equal "
        "to goldens.json, VA's cycles and issued per DPU equal at 1-64 DPUs "
        "and to [workloads]'s; " + json.dumps(out))
    return out


def _counting_characterize(seen: dict):
    """Wrap torch_pim_figs.characterize (as torch_run.py imports it) so
    that ``seen`` gets the launches each call made by kernel; returns the
    function that puts the plain one back."""
    import importlib
    figs = importlib.import_module("benchmarks.torch_pim_figs")
    plain = figs.characterize

    def characterize(*args, **kw):
        before = read_launches()
        rows = plain(*args, **kw)
        seen["rows"] = len(rows)
        seen["launches"] = {k: v - before[k]
                            for k, v in read_launches().items()}
        return rows

    figs.characterize = characterize
    return lambda: setattr(figs, "characterize", plain)


def _script_run(key: str, path: str, argv: list, want: dict) -> dict:
    """One twin's ``main`` on the card, in this process, in a working
    directory of its own made empty first (so that nothing a run caches
    there, as the figs suite's characterization, comes from an earlier
    run): exit 0, its printed lines (wall-clock numbers masked) equal to
    the golden ``want``, no ``error`` row; a torch_run.py suite traced,
    and passing its ``--check`` where it has one; the figs suite's
    characterization simulated here, through cycle_step.  Returns its
    wall and launches by kernel."""
    import os
    import shutil
    import torch
    from repro_torch import obs
    sr = _script_runs()
    mod = sr.load_script(ROOT, path, twin=True)
    work = OUT_DIR / "scripts" / key.replace("/", "_").replace(" ", "_")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    char: dict = {}
    restore = _counting_characterize(char) if key == CHAR_RUN else None
    cwd = os.getcwd()
    os.chdir(work)
    reset_launches()                       # counts of this twin only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rc, text = sr.run_main(mod, sr.script_argv(path, argv, OUT_DIR))
    finally:
        os.chdir(cwd)
        obs.set_default_tracer(None)       # --trace sets it process-wide
        if restore is not None:
            restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    name = " ".join([Path(path).stem] + list(argv))
    lines = sr.masked_lines(text, name)
    check(rc == 0 and want["rc"] == 0,
          f"[scripts] {key}: exit code {rc} (the reference's: "
          f"{want['rc']}):\n{text[-3000:]}")
    errors = [line for line in lines if '"error": ' in line]
    check(not errors, f"[scripts] {key}: error rows {errors}")
    if path.endswith("run.py") and "--check" in argv:
        check(text.splitlines()[-1].startswith("# check: OK"),
              f"[scripts] {key}: trace check {text.splitlines()[-1]!r}")
    bad = [i for i, (a, b) in enumerate(zip(lines, want["lines"]))
           if a != b]
    check(len(lines) == len(want["lines"]) and not bad,
          f"[scripts] {key}: {len(lines)} lines against the golden's "
          f"{len(want['lines'])}; first difference "
          + (f"{lines[bad[0]]!r} != {want['lines'][bad[0]]!r}"
             if bad else "in the count"))
    check(sum(launches.values()) > 0 or key in ENGINE_FREE,
          f"[scripts] {key} launched no kernel")
    out = {"key": key, "rc": rc, "wall_s": wall, "launches": launches,
           "lines": len(lines)}
    if key == CHAR_RUN:
        check(char.get("launches", {}).get("cycle_step", 0) > 0
              and (work / "reports" / "torch_pim_char.json").exists(),
              f"[scripts] {key}: the characterization behind figures 5-9 "
              f"was not simulated in this run: {char}")
        out["characterize"] = char
    return out


def phase_scripts(main_va: dict) -> dict:
    """The paper's study scripts on the card through their twins:
    torch_engine_perf.py at full width (:func:`_engine_perf`), then every
    run of tools/script_runs.py's SCRIPT_RUNS (the examples, the
    benchmarks' mains, torch_run.py's suites but lm) equal to
    goldens.json."""
    from repro_torch.workloads import goldens
    sr = _script_runs()
    t0 = time.perf_counter()
    out = {"engine_perf": _engine_perf(main_va), "runs": []}
    gold = goldens.load()["scripts"]["runs"]
    check(set(gold) == set(sr.SCRIPT_RUNS), "[scripts] goldens.json "
          f"holds {sorted(gold)}, not script_runs.SCRIPT_RUNS")
    for key, (path, argv) in sr.SCRIPT_RUNS.items():
        r = _script_run(key, path, argv, gold[key])
        log(f"[scripts] {key}: exit {r['rc']}, {r['lines']} lines equal to "
            f"goldens.json (wall-clock numbers masked); wall "
            f"{r['wall_s']:.3f} s, launches {json.dumps(r['launches'])}"
            + (f"; its characterization: {json.dumps(r['characterize'])}"
               if "characterize" in r else ""))
        out["runs"].append(r)
    out["launches"] = {}
    for r in out["runs"]:
        for k, v in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    out["seconds"] = time.perf_counter() - t0
    log(f"[scripts] phase {out['seconds']:.1f} s, launches "
        + json.dumps(out["launches"]))
    return out


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
#: the flash kernel's shapes in the other families' prefills on the main
#: path (LM_PATHS), each launched once per attention layer: name -> (its
#: configuration, the shape)
FLASH_FAMILIES = {
    # qwen3-moe-30b-a3b: 4 x 1,024 tokens, GQA with H / KV = 8
    "moe": ("qwen3-moe-30b-a3b", dict(b=4, s=1024, h=32, kv=4, dk=128,
                                      dv=128, causal=True, window=0)),
    # deepseek-v3-671b's MLA: Dk = qk_nope + qk_rope, Dv = v_head, 1 x 256
    "mla": ("deepseek-v3-671b", dict(b=1, s=256, h=128, kv=128, dk=192,
                                     dv=128, causal=True, window=0)),
    # recurrentgemma-9b's local attention: MQA, a 2,048-token window
    "window": ("recurrentgemma-9b", dict(b=4, s=4096, h=16, kv=1, dk=256,
                                         dv=256, causal=True, window=2048)),
    # seamless-m4t-large-v2's encoder over 4 x 1,024 frames
    "encoder": ("seamless-m4t-large-v2", dict(b=4, s=1024, h=16, kv=16,
                                              dk=64, dv=64, causal=False,
                                              window=0)),
    # llava-next-mistral-7b: 2,880 patches + 1,216 text tokens
    "patch_prefix": ("llava-next-mistral-7b", dict(b=4, s=4096, h=32, kv=8,
                                                   dk=128, dv=128,
                                                   causal=True, window=0)),
}
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
#: widths past the scalar kernels' whole-row instances, which their
#: head-tiled kernels take (float32): flash (S, H, KV, Dk, Dv, causal,
#: window) at Dv past 256 and Dk past the rows' shared memory, the SSD
#: scan (B, S, H, G, P, N, chunk) at N and P past 128 (and N = P = 128,
#: whose backward was refused at chunk 256)
FLASH_WIDE_CASES = [(200, 4, 2, 320, 288, True, 0),
                    (200, 4, 2, 320, 288, False, 0),
                    (200, 4, 2, 320, 288, True, 64),
                    (130, 4, 1, 272, 64, True, 0),
                    (130, 4, 2, 272, 64, True, 50)]
SSD_WIDE_CASES = [(1, 300, 2, 1, 160, 192, 96), (2, 250, 4, 2, 200, 144, 100),
                  (1, 512, 2, 1, 128, 128, 256)]
#: the wide instances timed: recurrentgemma-9b's attention shape with Dk
#: 320, Dv 288; mamba2-130m's prefill shape with N 192, P 160, chunk 96
FLASH_WIDE = dict(b=1, s=4096, h=16, kv=1, dk=320, dv=288, causal=True,
                  window=2048)
SSD_WIDE = dict(b=4, s=2048, h=24, g=1, p=160, n=192, chunk=96)
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
    from repro_torch.kernels.flash_attention.flash_attention import is_wide
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import is_wide as ssd_is_wide
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    keys = ("s", "h", "kv", "dk", "dv", "causal", "window")
    flash = [(dict(zip(keys, c), b=2), dt) for c in FLASH_CASES
             for dt in ("float32", "bfloat16")]
    flash += [(dict(zip(keys, c), b=2), "bfloat16") for c in FLASH_SM90_CASES]
    flash += [(FLASH_MAIN, "float32"), (FLASH_MAIN, "bfloat16")]
    flash += [(dict(zip(keys, c), b=2), "float32") for c in FLASH_WIDE_CASES]
    flash += [(FLASH_WIDE, "float32")]
    family_of = {id(shape): name for name, (_, shape)
                 in FLASH_FAMILIES.items()}
    flash += [(shape, "bfloat16") for _, shape in FLASH_FAMILIES.values()]
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
        wide = kernel == "scalar" and is_wide(shape["dk"], shape["dv"])
        log(f"[kernels] flash_attention ({kernel}"
            f"{', head-tiled' if wide else ''}) {shape} {dt}: max |err| "
            f"{err:.3g} (tolerance {tol}, rtol = atol; {ratio:.3g} of it "
            "used)")
        check(kernel == ("sm90" if dt == "bfloat16" else "scalar")
              and fops.launches_sm90 - sm90_before == (kernel == "sm90"),
              f"flash_attention at {shape} {dt} ran the {kernel} kernel")
        check(ratio <= 1, f"flash_attention kernel != plain at {shape} {dt}: "
              f"max |err| {err}")
        if shape is FLASH_MAIN and dt == "bfloat16":
            worst["flash_attention"] = err
        if shape is FLASH_WIDE:
            check(wide, f"flash_attention at {shape}: not head-tiled")
            worst["flash_attention (wide)"] = err
        if id(shape) in family_of:
            worst[f"flash_attention ({family_of[id(shape)]})"] = err
        del q, k, v, got, want
    keys = ("b", "s", "h", "g", "p", "n", "chunk")
    ssd = [(dict(zip(keys, c)), "float32") for c in SSD_CASES]
    ssd += [(dict(zip(keys, c)), "bfloat16") for c in SSD_TC_CASES]
    ssd += [(SSD_MAIN, "float32"), (SSD_MAIN, "bfloat16")]
    ssd += [(dict(zip(keys, c)), "float32") for c in SSD_WIDE_CASES]
    ssd += [(SSD_WIDE, "float32")]
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
        wide = kernel == "scalar" and ssd_is_wide(
            shape["n"], shape["p"], min(shape["chunk"], shape["s"]))
        log(f"[kernels] ssd_scan ({kernel}{', head-tiled' if wide else ''})"
            f" {shape} {dt}: max |err| {err:.3g} (tolerance {tol}, rtol = "
            f"atol; {ratio:.3g} of it used)")
        check(ratio <= 1, f"ssd_scan {kernel} route != plain at {shape} "
              f"{dt}: max |err| {err}")
        if shape is SSD_WIDE:
            check(wide, f"ssd_scan at {shape}: not head-tiled")
            worst["ssd_scan (wide)"] = err
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


def _lm_model(arch: str, dtype=None, seed=0, smoke=False, **replace):
    """(cfg, Transformer on the card) of ``arch`` (its smoke width if
    ``smoke``), with ``replace``'s fields (a cut depth) and random weights
    from ``seed``."""
    import torch
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.models.transformer import Transformer
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if dtype is not None:
        replace["dtype"] = dtype
    cfg = cfg.replace(**replace)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, Transformer(cfg, device="cuda", generator=gen)


def _lm_inputs(cfg, batch: int, text: int, frontend: int, seed: int,
               device) -> dict:
    """A prefill batch made from ``seed`` on ``device``: ``text`` tokens
    (none for encdec), and vlm's ``frontend`` patch embeddings or
    encdec's ``frontend`` frame embeddings (the frontends are stubs in the
    JAX package too: callers pass embeddings)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    if cfg.family != "encdec":
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, text),
                                      generator=gen, device=device)
    key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if key is not None:
        out[key] = torch.randn((batch, frontend, cfg.d_model),
                               generator=gen, device=device)
    return out


#: [lm] (a): each family at full width but cut depth (deepseek at its smoke
#: width: its full width is ~56 GB and several TFLOP on the CPU side), one
#: prompt of LM_PARITY_TOKENS positions, float32: (arch, smoke width?,
#: config fields replaced, text tokens, patches or frames, flash launches)
LM_PARITY = [
    ("llama3-8b", False, dict(n_layers=2), LM_PARITY_TOKENS, 0, 2),
    ("mamba2-130m", False, dict(n_layers=2), LM_PARITY_TOKENS, 0, 0),
    ("qwen3-moe-30b-a3b", False, dict(n_layers=2), LM_PARITY_TOKENS, 0, 2),
    # one (rglru, rglru, local) group
    ("recurrentgemma-9b", False, dict(n_layers=3), LM_PARITY_TOKENS, 0, 1),
    # one encoder and one decoder layer: the prefill encodes the frames
    # (one flash launch) and decodes a BOS
    ("seamless-m4t-large-v2", False,
     dict(n_layers=2, n_enc_layers=1, n_dec_layers=1), 0, LM_PARITY_TOKENS,
     1),
    # 256 patches + 128 text tokens: the CPU side's blocked attention stays
    # exact (S <= attn_chunk, ROADMAP §3)
    ("llava-next-mistral-7b", False, dict(n_layers=2), 128,
     LM_PARITY_TOKENS - 128, 2),
    # 1 dense (MLA) + 2 MoE layers
    ("deepseek-v3-671b", True, {}, LM_PARITY_TOKENS, 0, 3),
]


def phase_lm_parity():
    """Each family at full width, cut depth (LM_PARITY), float32: prefill
    of one prompt of LM_PARITY_TOKENS positions on the card (kernels) and
    on the CPU (plain versions) agree within LM_PARITY_TOL, logits and
    every cache leaf, with one flash launch (scalar kernel) per attention
    layer or one SSD scan per mamba2 layer."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, smoke, replace, text, frontend, n_flash in LM_PARITY:
        cfg, model = _lm_model(arch, dtype="float32", seed=1, smoke=smoke,
                               **replace)
        batch = _lm_inputs(cfg, 1, text, frontend, 2, "cpu")
        reset_launches()
        t0 = time.perf_counter()
        lg, cg = model.prefill({k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        launches = read_launches()
        model = model.cpu()              # the same weights, on the CPU
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lc, cc = model.prefill(batch)
        t_cpu = time.perf_counter() - t0
        check(sorted(cg) == sorted(cc) and cg["pos"] == cc["pos"],
              f"{arch}: card cache {sorted(cg)} != CPU cache {sorted(cc)}")
        errs = {"logits": _max_err(lg.cpu(), lc)}
        errs.update({k: _max_err(cg[k].cpu(), cc[k]) for k in cc
                     if k != "pos"})
        kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
        want = cfg.n_layers if cfg.family == "ssm" else n_flash
        log(f"[lm] {cfg.name} {'smoke' if smoke else 'full'} width, "
            f"{replace or 'all layers'}, float32, "
            f"{text} tokens + {frontend} patches/frames: card "
            f"vs CPU max |err| {errs} (tolerance {LM_PARITY_TOL}); "
            f"{kernel} launches {launches[kernel]}; card {t_gpu:.2f} s, "
            f"CPU {t_cpu:.2f} s")
        check(launches[kernel] == want,
              f"{arch}: {kernel} launches {launches[kernel]} != {want}")
        check(launches["flash_attention_sm90"] == 0
              and launches["ssd_scan_tc"] == 0,
              f"{arch}: float32 reached a bf16 tensor-core kernel")
        bad = {k: e for k, e in errs.items() if not e <= LM_PARITY_TOL}
        check(not bad, f"{arch} card vs CPU prefill differs: {bad}")
        del model, lg, cg, lc, cc


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


#: the LM serving path of every family in bf16 (full width; depth cut
#: only where the float32 weights would not fit the card's 80 GB):
#: (arch, config fields replaced, batch, text tokens, patches or frames,
#: flash launches in one prefill: one a self-attention layer, encdec's
#: encoder layers alone)
LM_PATHS = [
    ("llama3-8b", {}, 4, 1024, 0, 32),
    ("mamba2-130m", {}, 4, 2048, 0, 0),
    # 24 of 48 layers (48: 122 GB of float32 weights)
    ("qwen3-moe-30b-a3b", dict(n_layers=24), 4, 1024, 0, 24),
    # 1 dense (MLA) + 1 MoE layer of 256 experts (~56 GB)
    ("deepseek-v3-671b", dict(n_layers=2, n_dense_layers=1), 1, 256, 0, 2),
    # 38 layers: 12 groups (one local-attention layer each) + 2 rglru; the
    # 4,096-token prompts fill the 2,048-slot window ring twice
    ("recurrentgemma-9b", {}, 4, 4096, 0, 12),
    # 24 + 24 layers; the prefill encodes 1,024 frames, then decodes a BOS
    ("seamless-m4t-large-v2", {}, 4, 0, 1024, 24),
    # 32 layers; 2,880 anyres patches + 1,216 text tokens
    ("llava-next-mistral-7b", {}, 4, 1216, 2880, 32),
]
#: prefills of each LM_PATHS run: the first carries one-time costs (lazy
#: loading of library kernels, their heuristics, first allocations) that
#: spread its time 0.27-0.72 s at llama3-8b's on one H100, so the second
#: is the one timed (tools/lm_prefill_ab.py)
LM_PREFILLS = 2


def _pad_positions(cache, n: int, family: str):
    """Room for ``n`` more positions in the dense, moe and vlm cache
    leaves (axis 2); the hybrid ring and encdec's self cache (as long as
    the source) need none."""
    import torch
    import torch.nn.functional as F
    if family not in ("dense", "moe", "vlm"):
        return cache
    return {k: F.pad(v, [0, 0] * (v.dim() - 3) + [0, n])
            if torch.is_tensor(v) else v for k, v in cache.items()}


def lm_path(arch: str, replace: dict, batch: int, text: int, frontend: int,
            decode_steps: int = 32, after=None) -> dict:
    """The LM serving path at full width in bf16: LM_PREFILLS prefills
    (the last timed, the first's time kept), greedy decode steps past the
    last, then a ServeEngine; ``after(cfg, model, tokens)``,
    given, runs last on the loaded model with the engine's tokens (its
    result kept as ``"after"``)."""
    import torch
    cfg, model = _lm_model(arch, seed=3, **replace)
    inputs = _lm_inputs(cfg, batch, text, frontend, 4, "cuda")
    t_prefill = []
    for _ in range(LM_PREFILLS):     # the first carries one-time costs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(inputs)
        torch.cuda.synchronize()
        t_prefill.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits not finite")
    pos = cache["pos"]
    check(pos == (1 if cfg.family == "encdec" else text + frontend),
          f"{arch}: prefill pos {pos}")
    cache = _pad_positions(cache, decode_steps, cfg.family)
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
    check(cache["pos"] == pos + decode_steps, f"{arch}: pos {cache['pos']}")
    res = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "cut": replace,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": batch, "text": text, "frontend": frontend,
           "prefill_first_s": t_prefill[0], "prefill_s": t_prefill[-1],
           "prefill_tokens_per_s": batch * (text + frontend) / t_prefill[-1],
           "decode_steps": decode_steps,
           "decode_ms_per_step": t_decode / decode_steps * 1e3}
    del cache, inputs
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
    """The LM serving path of every family (LM_PATHS), one model loaded at
    a time, each run's launch counts set to 0 just before it and read
    just after: flash once per self-attention layer per prefill (all on
    the tensor-core kernel), the SSD scan once per mamba2-130m layer per
    prefill (all on the tensor-core route), nothing else.  [cluster] (d)
    (:func:`lease_serve`) runs on the loaded llama3-8b, counted apart."""
    import gc
    import torch
    runs = []
    lease = None
    total = dict.fromkeys(_counters(), 0)
    for arch, replace, batch, text, frontend, n_flash in LM_PATHS:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                   # counts of this run only
        run = lm_path(arch, replace, batch, text, frontend,
                      after=lease_serve if arch == "llama3-8b" else None)
        launches = read_launches()
        lease = run.pop("after", lease)
        run["launches"] = {k: n for k, n in launches.items() if n}
        runs.append(run)
        log(f"[lm] main path: {json.dumps(run)}")
        gc.collect()
        torch.cuda.empty_cache()
        n_flash *= LM_PREFILLS
        n_ssd = 24 * LM_PREFILLS if arch == "mamba2-130m" else 0
        check(launches["flash_attention"] == n_flash,
              f"{arch}: flash_attention launches "
              f"{launches['flash_attention']} != {n_flash} (one a "
              "self-attention layer of each prefill)")
        check(launches["flash_attention_sm90"] == n_flash,
              f"{arch}: of {n_flash} flash_attention launches, "
              f"{launches['flash_attention_sm90']} on the tensor-core kernel")
        check(launches["ssd_scan"] == launches["ssd_scan_tc"] == n_ssd,
              f"{arch}: ssd_scan launches {launches['ssd_scan']} "
              f"(tensor-core route {launches['ssd_scan_tc']}) != {n_ssd}")
        check(run["peak_gb"] < 80, f"{arch}: peak {run['peak_gb']:.1f} GB")
        for name, n in launches.items():
            total[name] += n
    return {"runs": runs, "launches": total, "lease": lease}


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


def _flash_family_times(gen, shape: dict) -> dict:
    """Device ms of one call at ``shape`` (bf16) of the tensor-core flash
    kernel (raw launcher, uncounted), of its plain version, and of
    ``scaled_dot_product_attention`` on the same inputs (``enable_gqa``; a
    window as an explicit boolean mask), each between CUDA events, beside
    the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_sm90_cuda)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    bf16 = torch.bfloat16
    q, k, v = _flash_inputs(gen, dtype=bf16, **shape)
    out = torch.empty((shape["b"], shape["s"], shape["h"], shape["dv"]),
                      dtype=bf16, device="cuda")
    causal, window, s = shape["causal"], shape["window"], shape["s"]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window > 0:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    flops, nbytes = _flash_work(esize=2, **shape)
    bound_ms, bound_by = _bound(flops, nbytes, BF16_FLOPS_PER_S)
    r = {"ms": cuda_time_ms(lambda: flash_attention_sm90_cuda(
            q, k, v, out, causal, window), n=50, warm=5),
         "plain_ms": cuda_time_ms(lambda: flash_attention_ref(
             q, k, v, causal=causal, window=window), n=2, warm=1),
         "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
             enable_gqa=True), n=50, warm=5),
         "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
         "bytes": nbytes, "shape": shape}
    r["tflops"] = flops / r["ms"] / 1e9
    r["bound_share"] = bound_ms / r["ms"]
    r["library_ratio"] = r["ms"] / r["library_ms"]
    return r


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
    del q, k, v, out, qt, kt, vt
    for name, (_, shape) in FLASH_FAMILIES.items():
        res[f"flash_attention ({name})"] = _flash_family_times(gen, shape)
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
    for name, (arch, shape) in FLASH_FAMILIES.items():
        r = res[f"flash_attention ({name})"]
        log(f"[kernels] flash_attention at {arch}'s prefill {shape}, bf16: "
            f"tensor-core kernel {r['ms']:.5f} ms ({r['bound_share']:.3f} of "
            f"the {r['bound_ms']:.5f} ms bound, by {r['bound_by']}); SDPA "
            f"{r['library_ms']:.5f} ms (kernel / SDPA "
            f"{r['library_ratio']:.3f}); plain {r['plain_ms']:.3f} ms")
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


# ---------------------------------------------------------------------------
# training: the backward kernels, full-width steps, the quickstart
# ---------------------------------------------------------------------------

#: [train] (a): the flash backward at llama3-8b's training shape (one
#: microbatch of train_4k's 4,096 tokens), at recurrentgemma-9b's local
#: attention (the widest head, D 256, a 2,048-token window) and at the
#: quickstart's (float32, the scalar forward), the SSD backward at
#: mamba2-130m's (4 x 4,096)
FLASH_TRAIN = dict(b=1, s=4096, h=32, kv=8, dk=128, dv=128, causal=True,
                   window=0)
FLASH_TRAIN_WINDOW = dict(b=1, s=4096, h=16, kv=1, dk=256, dv=256,
                          causal=True, window=2048)
FLASH_QUICKSTART = dict(b=4, s=64, h=4, kv=2, dk=16, dv=16, causal=True,
                        window=0)
SSD_TRAIN = dict(b=4, s=4096, h=24, g=1, p=64, n=128, chunk=256)
#: the flash backward at each family's training shape (a microbatch of
#: one sequence of 4,096, seamless's of two): name -> (its configuration,
#: the shape), timed beside SDPA's backward
FLASH_TRAIN_FAMILIES = {
    # qwen3-moe-30b-a3b: GQA with KV 4
    "moe": ("qwen3-moe-30b-a3b", dict(b=1, s=4096, h=32, kv=4, dk=128,
                                      dv=128, causal=True, window=0)),
    # deepseek-v3-671b's MLA: Dk = qk_nope + qk_rope 192, Dv 128, H 128
    "mla": ("deepseek-v3-671b", dict(b=1, s=4096, h=128, kv=128, dk=192,
                                     dv=128, causal=True, window=0)),
    # recurrentgemma-9b's local attention: D 256, MQA, a 2,048 window
    "window": ("recurrentgemma-9b", FLASH_TRAIN_WINDOW),
    # seamless-m4t-large-v2: the bidirectional encoder and the
    # equal-length cross-attention (D 64), and the causal decoder
    "encoder": ("seamless-m4t-large-v2", dict(b=2, s=4096, h=16, kv=16,
                                              dk=64, dv=64, causal=False,
                                              window=0)),
    "decoder": ("seamless-m4t-large-v2", dict(b=2, s=4096, h=16, kv=16,
                                              dk=64, dv=64, causal=True,
                                              window=0)),
    # llava-next-mistral-7b's 4,096-position patch-prefixed prompt:
    # llama3-8b's shape
    "patch_prefix": ("llava-next-mistral-7b", FLASH_TRAIN),
}
#: each gradient against the plain backward's (autograd of the plain
#: forward), |err| / max |plain|: float32 sums in another order; in bf16
#: the plain version rounds its intermediate gradients to bf16 where its
#: forward rounds (the kernels keep them in f32), ~6e-3 measured on an H100
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: [train] (b), (c): (arch, config fields replaced: the depth kept) at
#: full width in bf16 with f32 parameters, the config's optimizer, remat
#: and train_microbatches, a batch of TRAIN_BATCH sequences (or one a
#: microbatch where the config takes more microbatches).  Depth is cut
#: only where the float32 training state cannot fit the 80 GB card:
#: AdamW holds 16 B a parameter (weight, gradient, two moments), and the
#: microbatches' float32 gradient sum 4 B more; Adafactor ~8 B (weight and
#: gradient; its factored moments are small) and the sum.  Reckoned
#: (:func:`_state_gb`, logged with each run):
#: - llama3-8b at 4 of 32 layers: 1.92e9 parameters, ~38 GB; all 32
#:   (8e9 x 16 B = 128 GB) cannot fit;
#: - mamba2-130m uncut (24 layers, 0.13e9);
#: - qwen3-moe-30b-a3b at 3 of 48 layers: ~0.62e9 parameters a layer (128
#:   experts) and 0.62e9 of embedding and head, 2.48e9, ~50 GB; all 128
#:   experts run on every token (~0.8 GB a bf16 intermediate a layer at
#:   4,096 tokens);
#: - deepseek-v3-671b: one MoE layer is ~11.0e9 parameters (256 experts),
#:   ~88 GB with its f32 weight and gradient alone, so only its dense MLA
#:   layer trains here (1 layer, 2.44e9 with embedding and head, ~29 GB
#:   with Adafactor); its MoE layer waits for bf16-held weights (ROADMAP
#:   §3) and is held to the JAX package on the CPU only;
#: - recurrentgemma-9b at 6 of 38 layers (two whole (rglru, rglru, local)
#:   groups, ~0.2e9 a layer, 1.05e9 of tied embedding): 2.26e9, ~45 GB;
#: - seamless-m4t-large-v2 uncut (24 + 24 layers, 1.63e9, ~33 GB);
#: - llava-next-mistral-7b at 4 of 32 layers, as llama3-8b: 1.13e9, ~23 GB.
TRAIN_PATHS = [("llama3-8b", dict(n_layers=4)), ("mamba2-130m", {}),
               ("qwen3-moe-30b-a3b", dict(n_layers=3)),
               ("deepseek-v3-671b", dict(n_layers=1, n_dense_layers=1)),
               ("recurrentgemma-9b", dict(n_layers=6)),
               ("seamless-m4t-large-v2", {}),
               ("llava-next-mistral-7b", dict(n_layers=4))]
TRAIN_BATCH, TRAIN_SEQ = 4, 4096     # train_4k's sequence
#: (b): the sequence where the plain attention's autograd fits the card
TRAIN_PARITY_SEQ = 1024
#: (b): what (b) cuts further, for time: the plain flash version walks
#: the kernel's 64 x 64 tiles in Python (~4 s a backward at 4,096
#: positions, ~0.1-0.4 s at 1,024), so llava's patch prefix is cut to 512
#: (its 2,880 would not leave a text token in 1,024 positions) and
#: seamless to 6 + 6 layers (its 48 make 432 plain attention calls a
#: step, ~3 minutes); (c) runs each at its TRAIN_PATHS depth and prompt
TRAIN_PARITY_CUT = {
    "llava-next-mistral-7b": dict(n_frontend_tokens=512),
    "seamless-m4t-large-v2": dict(n_layers=12, n_enc_layers=6,
                                  n_dec_layers=6)}
#: (b): each gradient leaf of a step with the kernels against the same
#: step with the plain versions, |err| / max |plain|: bf16 activations
#: rounded in other places through every layer.  A leaf past it (a sum
#: over every position with heavy cancellation, such as a head's A_log,
#: where the plain version's bf16-rounded intermediate gradients weigh)
#: is held to the same step in float32 (plain versions): the kernels'
#: bf16 gradient may be at most STEP_NOISE times as far from it as the
#: plain version's (the two bf16 runs round in different places, and
#: their distances to the float32 step scatter around each other: 0.35 to
#: 1.5 of each other measured on mamba2-130m's A_log and dt_bias at
#: random init, both up to ~0.5 of the leaf's largest value)
STEP_GRAD_TOL = 5e-2
STEP_NOISE = 2.0
#: (b) in float32: the kernels' arithmetic against the plain versions'
#: (float32 sums in other orders through every layer)
STEP_GRAD_TOL_F32 = 1e-3
#: (c): steps timed after one warm-up step
TRAIN_TIMED_STEPS = 3


def _flash_bwd_work(b, s, h, kv, dk, dv, causal, window, esize):
    """(FLOPs, bytes) of one attention backward: five products per
    visible (query, key) pair (S, dP, dv, dq, dk); q, k, v, o, do and the
    log-sum-exp read once, dq, dk, dv written once."""
    import numpy as np
    seen = np.arange(1, s + 1) if causal else np.full(s, s)
    if window > 0:
        seen = np.minimum(seen, window)
    flops = 2.0 * b * h * int(seen.sum()) * (3 * dk + 2 * dv)
    nbytes = (esize * b * s * (2 * h * dk + 2 * kv * (dk + dv)
                               + 2 * h * dv) + 4 * b * h * s)
    return flops, nbytes


def _ssd_bwd_work(b, s, h, g, p, n, chunk, esize):
    """(FLOPs, bytes) of one SSD backward: per chunk of r rows, C.B over
    the r(r+1)/2 causal pairs once per group, then for every head dy.x,
    dx, dB and dC over the pairs, and five (N, P) products a row (the
    reverse state pass, dx's and dB's state terms, dC's, the inter-chunk
    d(seg)); x, B, C, dt, A, dy and the chunk-start states read once,
    dx, ddt, dA, dB and dC written once."""
    q = min(chunk, s)
    nc = -(-s // q)
    flops = 0.0
    for c0 in range(0, s, q):
        r = min(q, s - c0)
        pairs = r * (r + 1) // 2
        flops += b * (g * pairs * 2 * n
                      + h * (pairs * (4 * p + 4 * n) + 10 * r * n * p))
    nbytes = (esize * b * s * (3 * h * p + 4 * g * n) + 8 * b * s * h + 8 * h
              + 4 * b * h * nc * n * p)
    return flops, nbytes


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _flash_bwd_case(gen, shape, dt) -> dict:
    """The flash backward kernels against the plain backward on one case:
    the forward through the autograd Function (log-sum-exp written) gives
    the serving forward's output bit for bit, one backward launch a pass
    on the route ``route_bwd`` picks, two backward runs give the same
    bits."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v = (t.requires_grad_() for t in _flash_inputs(
        gen, dtype=getattr(torch, dt), **shape))
    kw = dict(causal=shape["causal"], window=shape["window"])
    with torch.no_grad():
        serving = fops.flash_attention(q, k, v, **kw)
    out = fops.flash_attention(q, k, v, **kw)
    check(torch.equal(out.detach(), serving), f"flash_attention at {shape} "
          f"{dt}: the training forward's output differs from serving's")
    do = _normal(gen, out.shape, out.dtype)
    route = fops.route_bwd(q.dtype, shape["dk"], shape["dv"])
    before = fops.launches_bwd, fops.launches_bwd_sm90
    got = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    made = (fops.launches_bwd - before[0],
            fops.launches_bwd_sm90 - before[1])
    check(made == (2, 2 if route == "sm90" else 0), f"flash backward at "
          f"{shape} {dt}: launches (all, sm90) {made} for two backward "
          f"passes on the {route} route")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash backward at {shape} {dt}: two runs differ")
    want = flash_attention_bwd_ref(q, k, v, do, **kw)
    errs = [_rel_err(g, w) for g, w in zip(got, want)]
    ratio = max(errs) / BWD_TOL[dt]
    log(f"[train] flash_attention_bwd ({route}) {shape} {dt}: dq, dk, dv "
        f"|err| / max |plain| {', '.join(f'{e:.3g}' for e in errs)} "
        f"(tolerance {BWD_TOL[dt]}; {ratio:.3g} of it used); serving "
        "forward bitwise equal; deterministic")
    check(ratio <= 1, f"flash backward != plain at {shape} {dt}: {errs}")
    return {"route": route, "rel_err": max(errs), "ratio": ratio,
            "max_abs_err": max(_max_err(g, w) for g, w in zip(got, want))}


def _ssd_bwd_case(gen, shape, dt) -> dict:
    """The SSD backward kernels against the plain backward on one case
    (the final state's gradient given), one backward launch a pass on the
    route ``route_bwd`` picks, two runs the same bits."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    ins = [t.requires_grad_() for t in _ssd_inputs(
        gen, dtype=getattr(torch, dt), **shape)]
    chunk = shape["chunk"]
    y, state = sops.ssd_scan(*ins, chunk=chunk)
    dy = _normal(gen, y.shape, y.dtype)
    dst = _normal(gen, state.shape, torch.float32)
    route = sops.route_bwd(ins[0].dtype, shape["n"], shape["p"], chunk)
    before = sops.launches_bwd, sops.launches_bwd_tc
    got = torch.autograd.grad((y, state), ins, (dy, dst), retain_graph=True)
    again = torch.autograd.grad((y, state), ins, (dy, dst))
    torch.cuda.synchronize()
    made = (sops.launches_bwd - before[0], sops.launches_bwd_tc - before[1])
    check(made == (2, 2 if route == "tc" else 0), f"SSD backward at "
          f"{shape} {dt}: launches (all, tc) {made} for two backward passes "
          f"on the {route} route")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"SSD backward at {shape} {dt}: two runs differ")
    want = ssd_scan_bwd_ref(*ins, dy, dst, chunk=chunk)
    errs = [_rel_err(g, w) for g, w in zip(got, want)]
    ratio = max(errs) / BWD_TOL[dt]
    log(f"[train] ssd_scan_bwd ({route}) {shape} {dt}: dx, ddt, dA, dB, "
        f"dC |err| / max |plain| {', '.join(f'{e:.3g}' for e in errs)} "
        f"(tolerance {BWD_TOL[dt]}; {ratio:.3g} of it used); "
        "deterministic")
    check(ratio <= 1, f"SSD backward != plain at {shape} {dt}: {errs}")
    return {"route": route, "rel_err": max(errs), "ratio": ratio,
            "max_abs_err": max(_max_err(g, w) for g, w in zip(got, want))}


def _flash_bwd_times(gen, shape: dict, routes: dict, dtype: str = "bfloat16",
                     plain: bool = True, library: bool = True) -> dict:
    """Device ms of one flash backward at ``shape`` (``dtype``: bf16 from
    the tensor-core forward, float32 from the scalar one) on each route
    (raw launchers, uncounted) and of each of its two kernels alone (the
    launcher's ``parts``, the scratch of a whole run kept), beside the
    plain backward's (``plain``; else None), the bound and (``library``;
    else None) the backward of ``scaled_dot_product_attention`` (autograd,
    ``enable_gqa``, the window as an explicit mask) on the same inputs;
    CUDA events.  ``routes``: name -> (launcher, timed launches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_sm90_cuda)
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    dt, causal, window = getattr(torch, dtype), shape["causal"], \
        shape["window"]
    q, k, v = _flash_inputs(gen, dtype=dt, **shape)
    out = torch.empty((shape["b"], shape["s"], shape["h"], shape["dv"]),
                      dtype=dt, device="cuda")
    lse = torch.empty((shape["b"], shape["h"], shape["s"]), device="cuda")
    (flash_attention_sm90_cuda if dtype == "bfloat16"
     else flash_attention_cuda)(q, k, v, out, causal, window, lse)
    do = _normal(gen, out.shape, dt)
    args = (q, k, v, out, do, lse, *(torch.empty_like(t) for t in (q, k, v)),
            causal, window)
    library_ms = None
    if library:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if window > 0:
            i = torch.arange(shape["s"], device="cuda")
            mask = ((i[None, :] <= i[:, None])
                    & (i[:, None] - i[None, :] < window))
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            is_causal=causal and mask is None,
                                            enable_gqa=True)
        dot = do.transpose(1, 2)
        library_ms = cuda_time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), n=20, warm=3)
        del qt, kt, vt, ot, dot
    flops, nbytes = _flash_bwd_work(esize=2 if dtype == "bfloat16" else 4,
                                    **shape)
    bound_ms, bound_by = _bound(flops, nbytes, FLOPS_PER_S[dtype])
    common = {
        "plain_ms": cuda_time_ms(lambda: flash_attention_bwd_ref(
            q, k, v, do, causal=causal, window=window), n=1, warm=1)
        if plain else None,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "shape": shape, "dtype": dtype}
    res = {}
    for name, (fn, n) in routes.items():
        scratch = fn(*args)
        r = res[name] = dict(common, ms=cuda_time_ms(
            lambda: fn(*args, scratch=scratch), n=n, warm=1), parts={
                part: cuda_time_ms(lambda: fn(*args, parts=mask_,
                                              scratch=scratch), n=n, warm=1)
                for part, mask_ in (("dq", 1), ("dkdv", 2))})
        r["bound_share"] = bound_ms / r["ms"]
        if library:
            r["library_ratio"] = r["ms"] / r["library_ms"]
    return res


def _wide_fwd_times(gen) -> dict:
    """[train] (a)'s forward times of the scalar kernels in float32 at the
    shapes whose backward :func:`_bwd_times` times there: flash at
    recurrentgemma-9b's attention shape (the whole-row instance, beside
    SDPA's float32 forward with the window as an explicit mask) and at
    FLASH_WIDE, the SSD scan at SSD_WIDE (both head-tiled; no PyTorch call
    computes either at once), each beside its plain version and bound;
    raw launchers, CUDA events."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda
    f32, res = torch.float32, {}
    for name, shape in (("flash_attention (window, float32)",
                         FLASH_TRAIN_WINDOW),
                        ("flash_attention (wide)", FLASH_WIDE)):
        q, k, v = _flash_inputs(gen, dtype=f32, **shape)
        out = torch.empty((shape["b"], shape["s"], shape["h"], shape["dv"]),
                          device="cuda")
        kw = dict(causal=shape["causal"], window=shape["window"])
        library_ms = None
        if shape is FLASH_TRAIN_WINDOW:
            i = torch.arange(shape["s"], device="cuda")
            mask = ((i[None, :] <= i[:, None])
                    & (i[:, None] - i[None, :] < shape["window"]))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), n=10,
                warm=2)
        flops, nbytes = _flash_work(esize=4, **shape)
        bound_ms, bound_by = _bound(flops, nbytes, FLOPS_PER_S["float32"])
        res[name] = {
            "ms": cuda_time_ms(lambda: flash_attention_cuda(
                q, k, v, out, kw["causal"], kw["window"]), n=10, warm=2),
            "plain_ms": cuda_time_ms(lambda: flash_attention_ref(
                q, k, v, **kw), n=1, warm=1),
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "shape": shape, "dtype": "float32"}
        del q, k, v, out
    sw = SSD_WIDE
    args = _ssd_inputs(gen, dtype=f32, **sw)
    y = torch.empty_like(args[0])
    state = torch.empty((sw["b"], sw["h"], sw["n"], sw["p"]), device="cuda")
    flops, nbytes = _ssd_work(esize=4, **sw)
    bound_ms, bound_by = _bound(flops, nbytes, FLOPS_PER_S["float32"])
    res["ssd_scan (wide)"] = {
        "ms": cuda_time_ms(lambda: ssd_scan_cuda(*args, y, state,
                                                 sw["chunk"]), n=10, warm=2),
        "plain_ms": cuda_time_ms(lambda: ssd_scan_ref(
            *args, chunk=sw["chunk"]), n=2, warm=1),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes, "shape": sw, "dtype": "float32"}
    for name, r in res.items():
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[train] {name} forward (scalar kernel) at {r['shape']}, "
            f"float32: {r['ms']:.4f} ms ({r['bound_share']:.4f} of the "
            f"{r['bound_ms']:.5f} ms bound, by {r['bound_by']}); plain "
            f"{r['plain_ms']:.2f} ms"
            + (f"; SDPA {r['library_ms']:.4f} ms" if r["library_ms"]
               else ""))
    torch.cuda.empty_cache()
    return res


def _bwd_times(gen) -> dict:
    """[train] (a)'s times at the training shapes (bf16): the flash
    backward on both routes at FLASH_TRAIN and on the tensor-core route
    at FLASH_TRAIN_WINDOW (:func:`_flash_bwd_times`), the SSD backward on
    both routes at SSD_TRAIN, each kernel alone too (the launchers'
    ``parts``), beside the plain backward and the bound; and in float32
    the scalar flash backward at FLASH_TRAIN_WINDOW and FLASH_WIDE, the
    scalar SSD backward at SSD_WIDE (head-tiled); CUDA events."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_sm90_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        scratch_bwd_tc, ssd_scan_bwd_cuda, ssd_scan_bwd_tc_cuda, ssd_scan_cuda,
        ssd_scan_tc_cuda)
    bf16 = torch.bfloat16
    res = _flash_bwd_times(gen, FLASH_TRAIN, {
        "flash_attention_bwd_sm90": (flash_attention_bwd_sm90_cuda, 20),
        "flash_attention_bwd": (flash_attention_bwd_cuda, 3)})
    res["flash_attention_bwd_sm90 (window)"] = _flash_bwd_times(
        gen, FLASH_TRAIN_WINDOW, {"sm90": (flash_attention_bwd_sm90_cuda,
                                           10)})["sm90"]
    torch.cuda.empty_cache()
    # float32 at the same shape (the scalar pair's head-tiled kernels,
    # recurrentgemma's float32 training) and at FLASH_WIDE
    res["flash_attention_bwd (window, float32)"] = _flash_bwd_times(
        gen, FLASH_TRAIN_WINDOW, {"scalar": (flash_attention_bwd_cuda, 5)},
        dtype="float32")["scalar"]
    torch.cuda.empty_cache()
    res["flash_attention_bwd (wide)"] = _flash_bwd_times(
        gen, FLASH_WIDE, {"scalar": (flash_attention_bwd_cuda, 5)},
        dtype="float32", library=False)["scalar"]
    torch.cuda.empty_cache()
    for name, (_, shape) in FLASH_TRAIN_FAMILIES.items():
        if shape is not FLASH_TRAIN and shape is not FLASH_TRAIN_WINDOW:
            res[f"flash_attention_bwd_sm90 ({name})"] = _flash_bwd_times(
                gen, shape, {"sm90": (flash_attention_bwd_sm90_cuda, 10)},
                plain=False)["sm90"]
            torch.cuda.empty_cache()
    ss = SSD_TRAIN
    args = _ssd_inputs(gen, dtype=bf16, **ss)
    y = torch.empty_like(args[0])
    state = torch.empty((ss["b"], ss["h"], ss["n"], ss["p"]),
                        device="cuda")
    states = ssd_scan_tc_cuda(*args, y, state, ss["chunk"])
    full = (*args, _normal(gen, y.shape, bf16), states, None, ss["chunk"])
    nc = -(-ss["s"] // ss["chunk"])
    flops, nbytes = _ssd_bwd_work(esize=2, **ss)
    bound_ms, bound_by = _bound(flops, nbytes, BF16_FLOPS_PER_S)
    common = {
        "plain_ms": cuda_time_ms(lambda: ssd_scan_bwd_ref(
            *full[:6], chunk=ss["chunk"]), n=1, warm=1),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes, "shape": ss}
    for name, fn, scratch, n, parts in (
            ("ssd_scan_bwd_tc", ssd_scan_bwd_tc_cuda,
             scratch_bwd_tc(args[0], args[3], ss["chunk"]), 20,
             ("ssd_chunk_cb", "ssd_bwd_chunk_state", "ssd_bwd_state_pass",
              "ssd_bwd_keys", "ssd_bwd_queries", "ssd_bwd_finish")),
            ("ssd_scan_bwd", ssd_scan_bwd_cuda,
             torch.empty((ss["b"], ss["h"], nc, ss["n"], ss["p"]),
                         device="cuda"), 5,
             ("ssd_bwd_state_pass", "ssd_bwd_chunk"))):
        fn(*full, scratch=scratch)
        r = res[name] = dict(common, ms=cuda_time_ms(
            lambda: fn(*full, scratch=scratch), n=n, warm=1), parts={
                part: cuda_time_ms(lambda: fn(*full, parts=1 << i,
                                              scratch=scratch), n=n, warm=1)
                for i, part in enumerate(parts)})
        r["bound_share"] = bound_ms / r["ms"]
    # the head-tiled SSD backward at SSD_WIDE, from the scalar forward's
    # float32 states
    sw, f32 = SSD_WIDE, torch.float32
    nc = -(-sw["s"] // sw["chunk"])
    args = _ssd_inputs(gen, dtype=f32, **sw)
    y = torch.empty_like(args[0])
    state = torch.empty((sw["b"], sw["h"], sw["n"], sw["p"]), device="cuda")
    states = torch.empty((sw["b"], sw["h"], nc, sw["n"], sw["p"]),
                         device="cuda")
    ssd_scan_cuda(*args, y, state, sw["chunk"], states)
    full = (*args, _normal(gen, y.shape, f32), states, None, sw["chunk"])
    scratch = torch.empty_like(states)
    flops, nbytes = _ssd_bwd_work(esize=4, **sw)
    bound_ms, bound_by = _bound(flops, nbytes, FLOPS_PER_S["float32"])
    ssd_scan_bwd_cuda(*full, scratch=scratch)
    r = res["ssd_scan_bwd (wide)"] = {
        "ms": cuda_time_ms(lambda: ssd_scan_bwd_cuda(*full, scratch=scratch),
                           n=5, warm=1),
        "parts": {part: cuda_time_ms(lambda: ssd_scan_bwd_cuda(
            *full, parts=mask_, scratch=scratch), n=5, warm=1)
            for part, mask_ in (("ssd_wide_state_pass", 1),
                                ("ssd_wide_dx, _db, _dc, _dt", 2))},
        "plain_ms": cuda_time_ms(lambda: ssd_scan_bwd_ref(
            *full[:6], chunk=sw["chunk"]), n=1, warm=1),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes, "shape": sw, "dtype": "float32"}
    r["bound_share"] = bound_ms / r["ms"]
    del args, y, state, states, full, scratch
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"[train] {name} at {r['shape']}, {r.get('dtype', 'bfloat16')}: "
            f"{r['ms']:.4f} ms "
            f"({r['bound_share']:.4f} of the {r['bound_ms']:.5f} ms bound, "
            f"by {r['bound_by']}; kernels alone "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["parts"].items())
            + " ms)" + (f"; plain {r['plain_ms']:.2f} ms"
                        if r["plain_ms"] is not None else "")
            + (f"; SDPA's backward {r['library_ms']:.4f} ms (kernel / SDPA "
               f"{r['library_ratio']:.3f})" if r["library_ms"] else ""))
    return res


def _train_batch(cfg) -> int:
    """Sequences a step of ``cfg``: TRAIN_BATCH, or one a microbatch where
    its train_microbatches is larger (deepseek-v3-671b's 8)."""
    return max(TRAIN_BATCH, cfg.train_microbatches)


def _train_batches(cfg, seq, n, seed=0):
    """``n`` batches of :func:`_train_batch` sequences of the data
    pipeline on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import loop
    ds = SyntheticLM(cfg, DataConfig(seq_len=seq,
                                     global_batch=_train_batch(cfg),
                                     vocab_size=cfg.vocab_size, seed=seed))
    return [loop.to_device(next(ds), "cuda") for _ in range(n)]


def _attn_layers(cfg) -> int:
    """Attention calls of one forward of ``cfg``: a flash launch each (an
    SSD scan each for ssm): one a layer, hybrid's local layer of each
    (rglru, rglru, local) group alone, encdec's encoder layers and each
    decoder layer's self- and cross-attention."""
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return cfg.n_layers


def _state_gb(cfg, n_params: int) -> float:
    """The float32 training state reckoned: AdamW 16 B a parameter,
    Adafactor 8 B, and 4 B more for the microbatches' gradient sum."""
    per = (16 if cfg.optimizer == "adamw" else 8) \
        + 4 * (cfg.train_microbatches > 1)
    return n_params * per / 1e9


def _reckoned(cfg, steps: int, dtype: str = "bfloat16") -> dict:
    """The forward and backward launches of ``steps`` steps: one forward
    an attention layer and microbatch (:func:`_attn_layers`), again in
    remat's recompute, one backward; in bf16 every backward on the
    tensor-core route, in float32 none."""
    mb = cfg.train_microbatches
    layers = _attn_layers(cfg)
    fwd = layers * mb * (1 + (cfg.remat == "block")) * steps
    bwd = layers * mb * steps
    tc = bwd if dtype == "bfloat16" else 0
    if cfg.family == "ssm":
        return {"ssd_scan": fwd, "ssd_scan_bwd": bwd, "ssd_scan_bwd_tc": tc,
                "flash_attention": 0, "flash_attention_bwd": 0,
                "flash_attention_bwd_sm90": 0}
    return {"flash_attention": fwd, "flash_attention_bwd": bwd,
            "flash_attention_bwd_sm90": tc, "ssd_scan": 0,
            "ssd_scan_bwd": 0, "ssd_scan_bwd_tc": 0}


def _step_grads(model, batch, mb, dtype=None, plain=False, experts=None):
    """(metrics, gradients) of one step's batch on the card; ``dtype``
    replaces the config's compute dtype, ``plain`` runs the plain versions
    in the kernels' place (their wrappers swapped for the plain functions
    for this run alone).  ``experts``, a list: a MoE's expert choices
    (``moe.top_k``'s indices, call by call) are appended to it when it is
    empty, and replayed from it when it is not, so that two runs compared
    route every token alike (top-k is discontinuous: a router logit tie
    broken the other way by float noise moves a token to another expert
    and its whole gradient with it)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import moe
    from repro_torch.train import loop
    cfg, saved = model.cfg, (fops.flash_attention, sops.ssd_scan, moe.top_k)
    if dtype is not None:
        model.cfg = cfg.replace(dtype=dtype)
    if plain:
        fops.flash_attention, sops.ssd_scan = flash_attention_ref, ssd_scan_ref
    if experts is not None:
        replay, calls = bool(experts), iter(list(experts))

        def top_k(probs, k):
            if replay:
                idx = next(calls)
                return probs.gather(-1, idx), idx
            vals, idx = saved[2](probs, k)
            experts.append(idx)
            return vals, idx

        moe.top_k = top_k
    try:
        out = loop.grads_and_metrics(model, batch, mb)
        torch.cuda.synchronize()
    finally:
        model.cfg = cfg
        fops.flash_attention, sops.ssd_scan, moe.top_k = saved
    return out


def _train_parity(arch: str, replace: dict) -> dict:
    """(b): one step's gradients at full width (TRAIN_PARITY_SEQ tokens a
    sequence; TRAIN_PARITY_CUT) with the kernels and with the plain
    versions, in
    bf16 and in float32: every bf16 leaf finite, not all zero and within
    STEP_GRAD_TOL of the plain versions' (or, past it, no farther than
    STEP_NOISE times the plain version's own distance from the float32
    step), every float32 leaf within STEP_GRAD_TOL_F32 (recurrentgemma's
    D 256 on the scalar backward's head-tiled kernels)."""
    import torch
    cut = TRAIN_PARITY_CUT.get(arch, {})
    cfg, model = _lm_model(arch, **{**replace, **cut})
    seq = TRAIN_PARITY_SEQ
    batch = _train_batches(cfg, seq, 1)[0]
    mb = cfg.train_microbatches
    # each pair compared routes its tokens alike: the plain versions' bf16
    # step replays the kernels' expert choices, the kernels' float32 step
    # the plain versions' (a MoE's top-k; nothing for the other families)
    experts, experts32 = [], []
    reset_launches()
    m_k, g_k = _step_grads(model, batch, mb, experts=experts)
    launches = read_launches()
    want = _reckoned(cfg, 1)
    check(all(launches[k] == n for k, n in want.items()),
          f"[train] {arch}: kernel step launched {launches}, reckoned "
          f"{want}")
    m_p, g_p = _step_grads(model, batch, mb, plain=True, experts=experts)
    errs, bad = {}, []
    for name, g in g_k.items():
        w = g_p[name]
        if not (torch.isfinite(g).all() and g.abs().max() > 0
                and torch.isfinite(w).all()):
            bad.append(name)
        errs[name] = _rel_err(g, w)
    check(not bad, f"[train] {arch}: gradients not finite or all zero: "
          f"{bad[:8]}")
    # the float32 step, plain versions: the arbiter of the leaves past the
    # tolerance, then the kernels' float32 step against it
    _, g_32 = _step_grads(model, batch, mb, dtype="float32", plain=True,
                          experts=experts32)
    over = sorted((n for n, e in errs.items() if e > STEP_GRAD_TOL),
                  key=errs.get, reverse=True)
    noise = {}
    if over:
        noise = {n: (_rel_err(g_k[n], g_32[n]), _rel_err(g_p[n], g_32[n]))
                 for n in over}
        log(f"[train] (b) {arch}: {len(over)} bf16 leaves past "
            f"{STEP_GRAD_TOL} of the plain versions' (kernels' |err|, plain "
            "version's |err| against the float32 step): " + ", ".join(
                f"{n} {noise[n][0]:.3g}, {noise[n][1]:.3g}" for n in over))
        farther = [n for n in over if noise[n][0] > STEP_NOISE * noise[n][1]]
        check(not farther, f"[train] {arch}: the kernels' bf16 gradients "
              f"of {farther[:8]} are more than {STEP_NOISE}x as far from the "
              "float32 step as the plain versions'")
    del g_k, g_p
    within = {n: e for n, e in errs.items() if n not in noise}
    worst = max(within, key=within.get)
    ratio = errs[worst] / STEP_GRAD_TOL
    reset_launches()
    _, g_k32 = _step_grads(model, batch, mb, dtype="float32",
                           experts=experts32)
    launches32 = read_launches()
    want32 = _reckoned(cfg, 1, "float32")
    check(all(launches32[k] == n for k, n in want32.items()),
          f"[train] {arch}: float32 kernel step launched {launches32}, "
          f"reckoned {want32}")
    errs32 = {n: _rel_err(g_k32[n], g_32[n]) for n in g_32}
    worst32 = max(errs32, key=errs32.get)
    ratio32 = errs32[worst32] / STEP_GRAD_TOL_F32
    del g_k32
    n_params = sum(t.numel() for t in model.parameters())
    state32 = _state_gb(cfg, n_params)
    f32_note = (f"float32: worst leaf {worst32} {errs32[worst32]:.3g} "
                f"(tolerance {STEP_GRAD_TOL_F32}; {ratio32:.3g} of it used; "
                f"{n_params / 1e9:.3f}e9 parameters, state reckoned "
                f"{state32:.1f} GB)")
    log(f"[train] (b) {arch} at {cfg.n_layers} layers"
        + (f" (cut for (b): {cut})" if cut else "") + ", "
        f"{_train_batch(cfg)} x {seq} tokens, {mb} microbatches: all "
        f"{len(errs)} gradients finite and not zero; kernels vs plain "
        f"versions, bf16: worst leaf {'but those ' if noise else ''}{worst} "
        f"|err| / max |plain| {errs[worst]:.3g} (tolerance "
        f"{STEP_GRAD_TOL}; {ratio:.3g} of it used), loss "
        f"{float(m_k['loss']):.5f} vs {float(m_p['loss']):.5f}; {f32_note}; "
        f"launches of the bf16 step {want} (kernel step launched as "
        f"reckoned), of the float32 step {want32}")
    check(ratio <= 1, f"[train] {arch}: gradient {worst} off the plain "
          f"versions' by {errs[worst]}")
    check(ratio32 <= 1, f"[train] {arch}: float32 gradient {worst32} off "
          f"the plain versions' by {errs32.get(worst32)}")
    check(abs(float(m_k["loss"]) - float(m_p["loss"]))
          <= 1e-2 * abs(float(m_p["loss"])), f"[train] {arch}: loss "
          f"{float(m_k['loss'])} vs plain {float(m_p['loss'])}")
    del model, g_32
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "leaves": len(errs),
            "seq": seq, "worst_leaf": worst, "rel_err": errs[worst],
            "ratio": ratio, "noise_leaves": noise, "launches": want,
            "worst_leaf_f32": worst32, "rel_err_f32": errs32[worst32],
            "launches_f32": want32, "state_gb": state32}


def _lru_share(cfg, step_s: float) -> dict:
    """The RG-LRU scan's share of a hybrid step: ``linear_scan`` (plain
    torch; its gradient is autograd's, the JAX package has no kernel for
    it) timed alone at a microbatch's shape, forward and forward +
    backward (CUDA events), times its calls a step: each rglru layer's
    forward once a microbatch, again in remat's recompute, and one
    backward.  A reckoning from its parts' times, not a trace."""
    import torch
    from repro_torch.models import rglru
    mb = cfg.train_microbatches
    B, W = _train_batch(cfg) // mb, cfg.lru_width or cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(3)
    la = -torch.rand((B, TRAIN_SEQ, W), generator=gen, device="cuda")
    b = torch.randn((B, TRAIN_SEQ, W), generator=gen, device="cuda")
    h0 = torch.zeros((B, W), device="cuda")
    la.requires_grad_(), b.requires_grad_()
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: rglru.linear_scan(la, b, h0,
                                                     cfg.ssm_chunk), n=10,
                           warm=2)
    dh = torch.randn((B, TRAIN_SEQ, W), generator=gen, device="cuda")

    def fwd_bwd():
        h, _ = rglru.linear_scan(la, b, h0, cfg.ssm_chunk)
        torch.autograd.grad(h, (la, b), dh)

    both = cuda_time_ms(fwd_bwd, n=10, warm=2)
    n_lru = cfg.n_layers - _attn_layers(cfg)
    remat = cfg.remat == "block"
    ms = n_lru * mb * (both + remat * fwd)
    return {"fwd_ms": fwd, "fwd_bwd_ms": both, "layers": n_lru,
            "ms_a_step": ms, "share": ms / 1e3 / step_s}


def _train_timed(arch: str, replace: dict) -> dict:
    """(c): a warm-up step then TRAIN_TIMED_STEPS timed steps at full
    width and TRAIN_SEQ tokens a sequence (host clock around synchronised
    steps), each kernel's launches over them equal to the reckoned ones,
    losses and parameters finite, peak memory; hybrid's RG-LRU scan's
    share (:func:`_lru_share`)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.train import loop
    cfg, model = _lm_model(arch, **replace)
    opt = get_optimizer(cfg.optimizer, warmup_cosine(3e-4, warmup=10))
    params = dict(model.named_parameters())
    state = {"params": model, "opt": opt.init(params), "step": 0}
    n_params = sum(p.numel() for p in params.values())
    step = loop.make_train_step(cfg, opt,
                                microbatches=cfg.train_microbatches)
    batches = _train_batches(cfg, TRAIN_SEQ, 1 + TRAIN_TIMED_STEPS)
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    losses = [float(m["loss"])]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))   # synchronises each step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = _reckoned(cfg, TRAIN_TIMED_STEPS)
    check(all(launches[k] == n for k, n in want.items()),
          f"[train] {arch}: {TRAIN_TIMED_STEPS} steps launched {launches}, "
          f"reckoned {want}")
    check(all(map(math.isfinite, losses)), f"[train] {arch}: losses {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in params.values()),
          f"[train] {arch}: parameters not finite after the steps")
    step_s = wall / TRAIN_TIMED_STEPS
    batch = _train_batch(cfg)
    run = {"arch": arch, "layers": cfg.n_layers,
           "of_layers": get_config(arch).n_layers, "params": n_params,
           "state_gb": _state_gb(cfg, n_params), "batch": batch,
           "seq": TRAIN_SEQ, "microbatches": cfg.train_microbatches,
           "remat": cfg.remat, "optimizer": cfg.optimizer, "step_s": step_s,
           "tokens_per_s": batch * TRAIN_SEQ / step_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": {k: launches[k] for k in want},
           "reckoned": want}
    del state, model, params, batches
    torch.cuda.empty_cache()
    extra = ""
    if cfg.family == "hybrid":
        run["rglru"] = _lru_share(cfg, step_s)
        r = run["rglru"]
        extra = (f"; the RG-LRU scan (plain torch, autograd) "
                 f"{r['fwd_ms']:.3f} ms forward, {r['fwd_bwd_ms']:.3f} ms "
                 f"forward + backward a layer and microbatch, x "
                 f"{r['layers']} layers: {r['ms_a_step']:.1f} ms, "
                 f"{r['share']:.3f} of the step (reckoned from its parts)")
    if arch == "deepseek-v3-671b":
        extra += ("; its dense MLA layer alone (a MoE layer, ~11.0e9 "
                  "parameters, needs ~88 GB of f32 weight and gradient: it "
                  "waits for bf16-held weights, ROADMAP §3, and is held to "
                  "the JAX package on the CPU only)")
    log(f"[train] (c) {arch} at {cfg.n_layers} of {run['of_layers']} layers "
        f"({n_params / 1e9:.3f}e9 parameters, f32 weights, bf16 compute, "
        f"{cfg.optimizer}, remat {cfg.remat}; state reckoned "
        f"{run['state_gb']:.1f} GB), {batch} x {TRAIN_SEQ} tokens, "
        f"{cfg.train_microbatches} microbatches: {step_s:.4f} s a step, "
        f"{run['tokens_per_s']:.1f} tokens/s, peak {run['peak_gb']:.2f} GB, "
        f"losses {[round(x, 4) for x in losses]}; launches over "
        f"{TRAIN_TIMED_STEPS} steps {run['launches']} (as reckoned){extra}")
    return run


def _train_quickstart() -> dict:
    """(d): examples/torch_quickstart.py on the card from the reference's
    initial weights and on the batches the reference took (the card's
    numpy may draw other Zipf samples for the data pipeline: its first
    batch is compared and logged): its lines against goldens.json's (the
    JAX package's) within script_runs.QUICKSTART_TOL, its loss falling,
    its backward passes on the kernels (one an attention layer and
    microbatch a step)."""
    import numpy as np
    import torch
    from repro_torch.workloads import goldens
    runs = _script_runs()
    gold = goldens.load()["quickstart"]
    mod = runs.load_script(ROOT, runs.QUICKSTART["script"], twin=True)
    with np.load(ROOT / gold["data"]) as z:
        taken = {k: z[k] for k in z.files}

    class Taken(mod.SyntheticLM):
        """The pipeline giving the reference's batches by step."""

        def batch_at(self, step):
            return {k: v[step] for k, v in taken.items()}

    own = mod.SyntheticLM(mod.config(), mod.DataConfig(
        seq_len=taken["tokens"].shape[2],
        global_batch=taken["tokens"].shape[1],
        vocab_size=mod.config().vocab_size)).batch_at(0)
    same_data = all(np.array_equal(own[k], v[0]) for k, v in taken.items())
    log(f"[train] (d) numpy {np.__version__} here draws "
        f"{'the same' if same_data else 'other'} batches than the "
        "reference's machine (Zipf samples of the data pipeline); the twin "
        "takes the reference's")
    mod.SyntheticLM = Taken
    reset_launches()
    t0 = time.perf_counter()
    rc, text = runs.run_main(mod, ["--init", str(ROOT / gold["init"])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    lines = text.splitlines()
    bad = runs.quickstart_departures(lines, gold["lines"])
    losses = runs.quickstart_losses(lines)
    # one backward an attention layer and microbatch (2) a step
    bwd = len(taken["tokens"]) * 2 * mod.config().n_layers
    log(f"[train] (d) examples/torch_quickstart.py on the card: exit {rc}, "
        f"{wall:.2f} s, losses {losses}, {len(bad)} lines off the JAX "
        f"package's beyond {runs.QUICKSTART_TOL}; flash launches "
        f"{launches['flash_attention']} forward (scalar kernel, f32), "
        f"{launches['flash_attention_bwd']} backward")
    check(rc == 0 and not bad, f"[train] quickstart: exit {rc}, {bad}")
    check(losses[-1] < losses[0] - 2, f"[train] quickstart: loss {losses}")
    check(launches["flash_attention_bwd"] == bwd
          and launches["flash_attention_bwd_sm90"] == 0
          and launches["flash_attention"] >= 2 * bwd,
          f"[train] quickstart launched {launches}")
    return {"wall_s": wall, "losses": losses, "lines": lines,
            "same_data": same_data,
            "launches": {k: launches[k] for k in
                         ("flash_attention", "flash_attention_bwd",
                          "flash_attention_bwd_sm90")}}


#: (e): the launch/train.py twin's arguments (its --ckpt-dir a fresh
#: directory): three step lines (steps 0, 10, 20), a checkpoint every 10
LAUNCH_TRAIN_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps",
                     "21", "--batch", "8", "--seq", "64", "--ckpt-every",
                     "10"]
#: (e): run_with_restarts on RESTART_ARCH's smoke width in bf16 (the
#: tensor-core backward; f32 weights): RESTART_STEPS steps, a checkpoint
#: every RESTART_EVERY, a worker failure injected at each of RESTART_FAILS
RESTART_ARCH = "qwen3-moe-30b-a3b"
RESTART_STEPS, RESTART_EVERY, RESTART_FAILS = 10, 2, (3, 7)


def _restart_run(inject: bool, ckpt_dir: str) -> tuple:
    """(parameters, stats) of RESTART_STEPS steps under
    ``run_with_restarts`` from the same initial weights, with or without
    the injected failures (tests/test_ckpt_runtime.py's scenario on the
    card)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.runtime.coordinator import (WorkerFailure,
                                                 run_with_restarts)
    from repro_torch.train import loop
    cfg = get_smoke_config(RESTART_ARCH).replace(dtype="bfloat16")
    opt = get_optimizer(cfg.optimizer, warmup_cosine(1e-3))
    ref = {"state": loop.init_train_state(cfg, opt, device="cuda")}
    step_fn = loop.make_train_step(cfg, opt)
    data = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4,
                                       vocab_size=cfg.vocab_size))
    seen = set()

    def one_step(i):
        if inject and i in RESTART_FAILS and i not in seen:
            seen.add(i)
            raise WorkerFailure(f"node died at step {i}")
        batch = loop.to_device(data.batch_at(i), "cuda")
        ref["state"], _ = step_fn(ref["state"], batch)
        data.step = i + 1

    stats = run_with_restarts(one_step, state_ref=ref, data=data,
                              n_steps=RESTART_STEPS, ckpt_dir=ckpt_dir,
                              ckpt_every=RESTART_EVERY)
    return dict(ref["state"]["params"].named_parameters()), stats


def _train_restarts() -> dict:
    """(e): ``python -m repro_torch.launch.train`` at ``--smoke`` on the
    card (exit 0, its losses falling, its steps through the flash
    kernels); then ``run_with_restarts`` with a worker failure injected at
    two steps ends with every parameter bit-equal to the run without
    failures (restored from the JAX-layout checkpoints; the backward
    kernels use no atomics)."""
    import re
    import tempfile
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import train as launch_train
    sr = _script_runs()
    with tempfile.TemporaryDirectory(prefix="launch_train_") as td:
        reset_launches()
        t0 = time.perf_counter()
        rc, text = sr.run_main(launch_train,
                               LAUNCH_TRAIN_ARGV + ["--ckpt-dir", td])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    losses = [float(x) for x in re.findall(r" loss=([0-9.]+) ", text)]
    log(f"[train] (e) python -m repro_torch.launch.train "
        f"{' '.join(LAUNCH_TRAIN_ARGV)}: exit {rc}, {wall:.2f} s, losses "
        f"{losses}, flash launches {launches['flash_attention']} forward, "
        f"{launches['flash_attention_bwd']} backward; its lines: "
        + " | ".join(text.splitlines()))
    check(rc == 0 and len(losses) == 3 and losses[-1] < losses[0],
          f"[train] launch/train.py: exit {rc}, losses {losses}:\n{text}")
    check(launches["flash_attention_bwd"] > 0, "[train] launch/train.py "
          f"made no flash backward launch: {launches}")
    with tempfile.TemporaryDirectory(prefix="restarts_") as td:
        before = fops.launches_bwd_sm90
        clean, st_clean = _restart_run(False, f"{td}/clean")
        failed, st_fail = _restart_run(True, f"{td}/failed")
        torch.cuda.synchronize()
        sm90 = fops.launches_bwd_sm90 - before
    differ = [n for n, p in clean.items() if not torch.equal(p, failed[n])]
    log(f"[train] (e) run_with_restarts on {RESTART_ARCH}'s smoke width "
        f"(bf16): without failures {st_clean}; failures at steps "
        f"{list(RESTART_FAILS)} {st_fail}; {len(clean) - len(differ)} of "
        f"{len(clean)} parameters bit-equal; {sm90} tensor-core backward "
        "launches")
    check(st_fail["failures"] == 2 and st_fail["restores"] == 2
          and st_clean["completed"] == st_fail["completed"] == RESTART_STEPS,
          f"[train] run_with_restarts: {st_clean}, {st_fail}")
    check(sm90 > 0, "[train] run_with_restarts ran no tensor-core backward")
    check(not differ, f"[train] run_with_restarts: parameters {differ[:8]} "
          "differ from the run without failures")
    return {"launch_rc": rc, "launch_losses": losses, "launch_wall_s": wall,
            "restarts": st_fail, "params": len(clean)}


def phase_train() -> dict:
    """[train] (a) the backward kernels against their plain versions on
    the card (and timed), (b) one full-width step's gradients with the
    kernels against the plain versions, (c) timed full-width steps, (d)
    the quickstart twin against the JAX package's lines, (e) the
    launch/train.py twin and restarts bit-equal to a run without
    failures."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    keys = ("s", "h", "kv", "dk", "dv", "causal", "window")
    flash = [(dict(zip(keys, c), b=2), dt) for c in FLASH_CASES
             for dt in ("float32", "bfloat16")]
    flash += [(dict(zip(keys, c), b=2), "bfloat16") for c in FLASH_SM90_CASES]
    flash += [(FLASH_QUICKSTART, "float32"), (FLASH_TRAIN, "bfloat16"),
              (FLASH_TRAIN_WINDOW, "bfloat16"),
              (FLASH_TRAIN_WINDOW, "float32")]
    wide = [(dict(zip(keys, c), b=2), "float32") for c in FLASH_WIDE_CASES]
    # each kernel's max |err| at its main path's shape: the tensor-core
    # route's at llama3-8b's, the scalar one's at the quickstart's
    worst = {"flash_attention_bwd (wide)": 0.0, "ssd_scan_bwd (wide)": 0.0}
    for shape, dt in flash + wide:
        r = _flash_bwd_case(gen, shape, dt)
        if shape is FLASH_TRAIN:
            worst["flash_attention_bwd_sm90"] = r["max_abs_err"]
        if shape is FLASH_QUICKSTART:
            worst["flash_attention_bwd"] = r["max_abs_err"]
        if shape is FLASH_TRAIN_WINDOW and dt == "float32":
            worst["flash_attention_bwd (window, float32)"] = r["max_abs_err"]
        if (shape, dt) in wide:
            worst["flash_attention_bwd (wide)"] = max(
                worst["flash_attention_bwd (wide)"], r["max_abs_err"])
    keys = ("b", "s", "h", "g", "p", "n", "chunk")
    ssd = [(dict(zip(keys, c)), "float32") for c in SSD_CASES]
    ssd += [(dict(zip(keys, c)), "bfloat16") for c in SSD_TC_CASES]
    ssd_f32 = dict(SSD_TRAIN, s=1024)
    ssd += [(ssd_f32, "float32"), (SSD_TRAIN, "bfloat16")]
    wide = [(dict(zip(keys, c)), "float32") for c in SSD_WIDE_CASES]
    for shape, dt in ssd + wide:
        r = _ssd_bwd_case(gen, shape, dt)
        if shape is SSD_TRAIN:
            worst["ssd_scan_bwd_tc"] = r["max_abs_err"]
        if shape is ssd_f32:
            worst["ssd_scan_bwd"] = r["max_abs_err"]
        if (shape, dt) in wide:
            worst["ssd_scan_bwd (wide)"] = max(worst["ssd_scan_bwd (wide)"],
                                               r["max_abs_err"])
    times = _bwd_times(gen)
    times.update(_wide_fwd_times(gen))
    torch.cuda.empty_cache()
    parity = [_train_parity(a, r) for a, r in TRAIN_PATHS]
    torch.cuda.empty_cache()
    timed = [_train_timed(a, r) for a, r in TRAIN_PATHS]
    quick = _train_quickstart()
    restarts = _train_restarts()
    return {"max_abs_err": worst, "times": times, "parity": parity,
            "timed": timed, "quickstart": quick, "restarts": restarts}


def _family_bwd_times(train: dict) -> dict:
    """family -> (arch, [train] (a)'s times of the tensor-core flash
    backward at its training shape (FLASH_TRAIN_FAMILIES))."""
    t = train["times"]
    out = {}
    for fam, (arch, shape) in FLASH_TRAIN_FAMILIES.items():
        key = ("flash_attention_bwd_sm90" if shape is FLASH_TRAIN else
               "flash_attention_bwd_sm90 (window)"
               if shape is FLASH_TRAIN_WINDOW else
               f"flash_attention_bwd_sm90 ({fam})")
        out[fam] = (arch, t[key])
    return out


# ---------------------------------------------------------------------------
# [launch]: the one-card dry-run, a counted cell run for real, the
# parallel modules on a process group, the LM report scripts
# ---------------------------------------------------------------------------

#: (b): prefill_32k's sequence, cut to 2 layers and batch 1, of an
#: attention and an SSD architecture: (arch, the kernel its layers launch)
LAUNCH_CELLS = (("llama3-8b", "flash_attention"),
                ("mamba2-130m", "ssd_scan_tc"))
LAUNCH_CUT = dict(n_layers=2)
LAUNCH_SEQ, LAUNCH_BATCH = 32768, 1
#: (c): the reference's scenario_compressed_dp problem
#: (tests/_dist_scenarios.py), its steps and tolerances
DP_STEPS = 60
DP_LOSS_TOL = 1e-6


#: processes the smoke started in the background, stopped when it ends
BACKGROUND = []
#: (a): the dry-runs' processes, on the upper half of the host's cores
#: (DRYRUN_CORES) beside [train]; 2x16x16 is counted for MP_ARCHS (the
#: whole of it does not fit beside [train]), the one-card rows for every
#: architecture, which (d) reads
DRYRUN_JOBS = {"sp": 3, "mp": 1, "1x1": 1}
MP_ARCHS = ("llama3-8b", "mamba2-130m", "qwen3-moe-30b-a3b")
#: [launch] as a whole, checked
LAUNCH_LIMIT_S = 150.0
#: (e) and (f): ranks sharing the card (gloo, a FileStore)
LAUNCH_RANKS = 4
#: (f): sharded serving on a (data 2, model 2) mesh: each architecture cut
#: to 2 layers at full width, bf16, a prefill of SERVE_ROWS x SERVE_SEQ
#: tokens and SERVE_STEPS decode steps, its logits within SERVE_TOL (of
#: the largest |logit|) of a one-process run on the card
SERVE_AXES = {"data": 2, "model": 2}
SERVE_ARCHS = (("llama3-8b", "flash_attention"),
               ("mamba2-130m", "ssd_scan_tc"))
SERVE_ROWS, SERVE_SEQ, SERVE_STEPS = 2, 1024, 8
SERVE_TOL = 2e-2
SERVE_SEED = 7
#: (e): cycle_step's cases of a run split over the ranks, on 8 DPUs (2 a
#: rank), each bitwise a one-process run on the card: the tail-clip DMA,
#: cross_pair (ranks 0 and 2 replay with the system's DMA windows) and
#: cross_pair stopped at max_cycles (ranks whose DPUs stopped catch up)
SHARD_CASES = ("dma_tail_clip", "cross_pair", "cross_pair_max_cycles")
SHARD_CASE_DPUS = 8


def _dryrun_rows(out_dir: Path) -> list:
    return [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]


def _blocking_sync():
    """This process's CUDA context yields its host core while it waits for
    the card (``CU_CTX_SCHED_BLOCKING_SYNC`` on device 0's primary
    context, set before torch makes it): four ranks sharing the card on 8
    host cores would otherwise spin a core each in every wait."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    set_flags = getattr(cuda, "cuDevicePrimaryCtxSetFlags_v2",
                        cuda.cuDevicePrimaryCtxSetFlags)
    rc = cuda.cuInit(0) or cuda.cuDeviceGet(ctypes.byref(dev), 0) \
        or set_flags(dev, 0x4)
    check(rc == 0, f"cuDevicePrimaryCtxSetFlags(blocking sync): CUresult "
          f"{rc}")


def _serve_inputs(cfg, device):
    """(f)'s prompt (SERVE_ROWS x SERVE_SEQ tokens) and decode tokens
    (SERVE_STEPS x SERVE_ROWS), drawn from SERVE_SEED."""
    import torch
    gen = torch.Generator().manual_seed(SERVE_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_ROWS, SERVE_SEQ),
                           generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (SERVE_STEPS, SERVE_ROWS),
                          generator=gen)
    return tokens.to(device), steps.to(device)


def _serve_model(arch, device):
    """(f)'s model: ``arch`` at full width and 2 layers, bf16, its random
    weights drawn on the card from SERVE_SEED."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    cfg = get_config(arch).replace(n_layers=2)
    return cfg, Transformer(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SERVE_SEED))


def _record_shapes(fops, sops) -> set:
    """The set of the shapes each flash and SSD call of this process is
    handed from now on (flash: q, k, v; SSD: x, B), as strings: the
    kernels' wrappers, the models' entry to them, are wrapped (their
    launch counts untouched)."""
    shapes = set()

    def wrap(mod, name, n):
        fn = getattr(mod, name)

        def recorded(*args, **kw):
            shapes.add(f"{name} " + " ".join(
                "x".join(map(str, a.shape)) for a in (
                    args[:n] if n == 3 else (args[0], args[3]))))
            return fn(*args, **kw)

        setattr(mod, name, recorded)

    wrap(fops, "flash_attention", 3)
    wrap(sops, "ssd_scan", 2)
    return shapes


def _coll_text(counts: dict) -> str:
    """A rank's collectives (``collectives.COUNTS``) by kind: calls, MB
    handed over, host s in them."""
    return ", ".join(f"{k} {c} ({b / 1e6:.1f} MB, {t:.2f} s)"
                     for k, (c, b, t) in sorted(counts.items()))


def _serve(model, cfg, rows) -> tuple:
    """A prefill into a cache with room for SERVE_STEPS more positions
    and SERVE_STEPS decode steps (``rows``: a tensor's rows this process
    serves); (the logits of each, float32 on the host, the wall, the
    cache's position after them, and for a K/V cache the positions this
    process holds and how many of them hold something, the prefill's
    wall)."""
    import torch
    tokens, steps = _serve_inputs(cfg, "cuda")
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": rows(tokens)},
                                  global_batch=SERVE_ROWS,
                                  capacity=SERVE_SEQ + SERVE_STEPS)
    out = [logits.float().cpu()]
    prefill_s = time.perf_counter() - t0
    for tok in steps:
        logits, cache = model.decode_step(cache, rows(tok))
        out.append(logits.float().cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kv = {}
    if "k" in cache:
        held = cache["k"].float().abs().amax(dim=(0, 1, 3, 4))
        kv = {"positions": held.numel(), "filled": int((held > 0).sum())}
    return out, wall, int(cache["pos"]), kv, prefill_s


def _serve_reference(tmp) -> dict:
    """(f)'s one-process runs on the card: each architecture's logits
    written to ``tmp/serve_<arch>.pt`` for the ranks; the walls."""
    import torch
    walls = {}
    for arch, _ in SERVE_ARCHS:
        cfg, model = _serve_model(arch, "cuda")
        logits, walls[arch], pos, kv, _ = _serve(model, cfg, lambda t: t)
        want = SERVE_SEQ + SERVE_STEPS
        check(pos == want and kv.get("filled", want) == want,
              f"[launch] (f) {arch} in one process: position {pos}, K/V "
              f"written at {kv} positions, not {want}: the decode steps "
              "did not write past the prompt")
        torch.save(logits, Path(tmp, f"serve_{arch}.pt"))
        del model
        torch.cuda.empty_cache()
    return walls


def _shard_case_digests() -> dict:
    """(e)'s SHARD_CASES run in this one process on the card: {case: its
    final state's digests}."""
    from repro_torch.core import compile_cache
    from repro_torch.kernels.cycle_step import cases
    out = {}
    for name in SHARD_CASES:
        cfg, binary, wram, mram, T = cases.launch(name, SHARD_CASE_DPUS)
        out[name] = _run_digests(compile_cache.run(
            cfg, binary, wram, mram, n_threads=T, device="cuda"))
    return out


def _launch_rank(rank, world, tmp):
    """[launch] (e) and (f), rank ``rank`` of ``world`` (gloo, a FileStore
    in ``tmp``; ``tmp/rank<r>.json``), started before and held until the
    parent's own work on the card is done (``tmp/go``; what to hold the
    runs to in ``tmp/want.json``).  (e): each of SHARD_CASES with its DPUs
    split over the ranks (``compile_cache.run_sharded``), its whole final
    state bitwise the one-process card run's; then the full-system VA
    through ``PIMSystem(cfg, group=...)``, its 2,560 DPUs 640 a rank (one
    cycle_step launch a K-block on the resident route, an all-reduce a
    K-block, the blocks gathered), the whole final state, KernelReport
    and Timeline bitwise [system]'s one-process run, under its oracle.
    (f): each of SERVE_ARCHS sharded on a SERVE_AXES mesh, its prefill
    and decode steps' logits (this rank's rows) against the one-process
    run's (``tmp/serve_<arch>.pt``), each kernel's launches."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(SRC))
    _blocking_sync()
    import torch
    import torch.distributed as dist
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models.layers import cdtype
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        t1 = time.perf_counter()
        while not Path(tmp, "go").exists():
            check(time.perf_counter() - t1 < 300, "[launch] (e) the parent "
                  "did not let the ranks start in 300 s")
            time.sleep(0.1)
        torch.cuda.set_device(0)
        want = json.loads(Path(tmp, "want.json").read_text())
        group = dist.group.WORLD
        out = {"rank": rank, "cases": {}}

        def counted(fn):
            """fn's result, and the sharded runs' counts over it."""
            s0, l0 = compile_cache.stats(), step_ops.launches
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s1 = compile_cache.stats()
            n = {k: s1[k] - s0[k] for k in ("votes", "replays",
                                            "catch_ups", "loop_s")}
            n.update(launches=step_ops.launches - l0, wall_s=wall)
            return res, n

        for name in SHARD_CASES:
            cfg, binary, wram, mram, T = cases.launch(name, SHARD_CASE_DPUS)
            st, n = counted(lambda: compile_cache.run_sharded(
                cfg, binary, wram, mram, group, n_threads=T, device="cuda"))
            n["bad"] = _digest_diff(_run_digests(st), want["cases"][name])
            out["cases"][name] = n
        cfg = DPUConfig(n_dpus=FULL_SYSTEM_DPUS, n_tasklets=16,
                        mram_bytes=SYSTEM_MRAM)
        system = PIMSystem(cfg, device="cuda", group=group)
        (st, rep), n = counted(lambda: wl.get("VA").run(
            system, 16, scale=1.0, seed=0))
        n["bad"] = _digest_diff(_run_digests(st, rep, system.timeline),
                                want["va"])
        n.update(dpus=list(compile_cache.dpu_block(FULL_SYSTEM_DPUS, world,
                                                   rank)),
                 vote_bytes=4 * (2 + compile_cache.STEPS_PER_CHECK
                                 * cfg.superscalar),
                 setup_share=1.0 - n["loop_s"] / n["wall_s"])
        out["pim"] = n
        del st, rep, system
        torch.cuda.empty_cache()
        mesh = make_elastic_mesh(model_parallel=SERVE_AXES["model"],
                                 device_type="cuda")
        check(par.mesh_axes(mesh) == SERVE_AXES, f"[launch] (f) {mesh}")
        out["serve"] = {}
        shapes = _record_shapes(fops, sops)
        for arch, kernel in SERVE_ARCHS:
            cfg, model = _serve_model(arch, "cuda")
            par.shard_module(model, mesh, cdtype(cfg))
            torch.cuda.empty_cache()
            counters = (fops.launches, fops.launches_sm90, sops.launches,
                        sops.launches_tc)
            coll.reset_counts()
            shapes.clear()
            logits, secs, pos, kv, prefill_s = _serve(
                model, cfg, lambda t: par.batch_rows(t, mesh))
            launched = [b - a for a, b in zip(counters, (
                fops.launches, fops.launches_sm90, sops.launches,
                sops.launches_tc))]
            ref = [par.batch_rows(w, mesh) for w in torch.load(
                Path(tmp, f"serve_{arch}.pt"), weights_only=True)]
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(logits, ref))
            out["serve"][arch] = {
                "wall_s": secs, "prefill_s": prefill_s, "err": err,
                "kernel": kernel, "pos": pos, "kv": kv,
                "collectives": dict(coll.COUNTS), "shapes": sorted(shapes),
                "launches": dict(zip(("flash_attention", "flash_sm90",
                                      "ssd_scan", "ssd_scan_tc"), launched)),
                "finite": all(bool(torch.isfinite(g).all()) for g in logits),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
            del model
            torch.cuda.empty_cache()
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _start_ranks():
    """[launch] (e) and (f)'s LAUNCH_RANKS ranks of :func:`_launch_rank`
    started (a FileStore in a temporary directory), to wait for
    :func:`_let_ranks_go`: (the temporary directory, the processes'
    context)."""
    import tempfile
    import torch.multiprocessing as tmp_mp
    tmpdir = tempfile.TemporaryDirectory()
    ctx = tmp_mp.start_processes(
        _launch_rank, args=(LAUNCH_RANKS, tmpdir.name),
        nprocs=LAUNCH_RANKS, join=False, start_method="spawn")
    return tmpdir, ctx


def _let_ranks_go(tmpdir, want: dict):
    """The ranks of :func:`_start_ranks` started on the card, holding
    their runs to ``want``."""
    Path(tmpdir.name, "want.json").write_text(json.dumps(want))
    Path(tmpdir.name, "go").touch()


def _finish_ranks(tmpdir, ctx, system_va: dict, ref_walls: dict) -> dict:
    """The ranks of :func:`_start_ranks` joined and their results
    checked: (e) each sharded case's whole state bitwise the one-process
    card run's, cycle_step launched on every rank, ranks 0 and 2 replaying
    cross_pair, catch-ups taken in both cross_pair cases; VA's whole
    state, KernelReport and Timeline bitwise [system]'s run, cycle_step
    launched on every rank; (f) logits within SERVE_TOL, the decode steps
    past the prompt, each kernel launched a layer on every rank."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    try:
        while not ctx.join():
            pass
        ranks = [json.loads(Path(tmpdir.name, f"rank{r}.json").read_text())
                 for r in range(LAUNCH_RANKS)]
    except Exception as e:
        raise SmokeError(f"[launch] (e)/(f) {type(e).__name__}: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
        tmpdir.cleanup()
    for name in SHARD_CASES:
        got = [r["cases"][name] for r in ranks]
        check(all(not g["bad"] and g["launches"] > 0 for g in got),
              f"[launch] (e) {name} over {LAUNCH_RANKS} ranks: leaves "
              f"{[g['bad'] for g in got]} differ from the one-process card "
              f"run; cycle_step launches {[g['launches'] for g in got]}")
        if name.startswith("cross_pair"):
            check(sum(g["catch_ups"] for g in got) > 0, f"[launch] (e) "
                  f"{name}: no rank caught up {got}")
    replays = [r["cases"]["cross_pair"]["replays"] for r in ranks]
    check(replays[0] > 0 and replays[2] > 0, f"[launch] (e) cross_pair: "
          f"replays {replays}, not on ranks 0 and 2")
    for r in ranks:
        e = r["pim"]
        check(not e["bad"] and e["launches"] > 0 and e["votes"] > 0,
              f"[launch] (e) VA rank {r['rank']} (DPUs {e['dpus']}): "
              f"{e['bad']} differ from [system]'s run; {e['launches']} "
              f"cycle_step launches, {e['votes']} votes")
        for arch, kernel in SERVE_ARCHS:
            f = r["serve"][arch]
            layers = get_config(arch).replace(n_layers=2).n_layers
            n = f["launches"]
            want = ({"flash_attention": layers, "flash_sm90": layers,
                     "ssd_scan": 0, "ssd_scan_tc": 0}
                    if kernel == "flash_attention" else
                    {"flash_attention": 0, "flash_sm90": 0,
                     "ssd_scan": layers, "ssd_scan_tc": layers})
            room = (SERVE_SEQ + SERVE_STEPS) // SERVE_AXES["model"]
            check(f["finite"] and f["err"] <= SERVE_TOL and n == want
                  and f["pos"] == SERVE_SEQ + SERVE_STEPS
                  and f["kv"].get("positions", room) == room
                  and f["kv"].get("filled", room) == room,
                  f"[launch] (f) rank {r['rank']} {arch}: logits "
                  f"{f['err']:.3e} of the largest off the one-process "
                  f"run's (finite: {f['finite']}); launches {n}, not "
                  f"{want}; position {f['pos']}, K/V {f['kv']}")
    log(f"[launch] (e) {LAUNCH_RANKS} ranks sharing the card (gloo), "
        f"{SHARD_CASE_DPUS} DPUs: "
        + "; ".join(f"{name} bitwise the one-process card run, launches "
                    f"{[r['cases'][name]['launches'] for r in ranks]}, "
                    f"votes {[r['cases'][name]['votes'] for r in ranks]}, "
                    f"replays {[r['cases'][name]['replays'] for r in ranks]}"
                    f", catch-ups "
                    f"{[r['cases'][name]['catch_ups'] for r in ranks]}"
                    for name in SHARD_CASES))
    log(f"[launch] (e) VA on {FULL_SYSTEM_DPUS} DPUs, scale 1.0, through "
        f"PIMSystem(cfg, group=...) over {LAUNCH_RANKS} ranks sharing the "
        "card (gloo): on every rank the whole final state, KernelReport "
        "and Timeline bitwise [system]'s one-process run, oracle ok; "
        + "; ".join(
            f"rank {r['rank']} (DPUs {p['dpus'][0]}-{p['dpus'][1] - 1}): "
            f"{p['launches']} cycle_step launches, {p['votes']} votes of "
            f"{p['vote_bytes']} bytes, {p['replays']} replays, "
            f"{p['catch_ups']} catch-ups, wall {p['wall_s']:.3f} s, K-block "
            f"loop {p['loop_s']:.3f} s, set-up share {p['setup_share']:.3f}"
            for r, p in ((r, r["pim"]) for r in ranks))
        + f" (the one-process run: wall {system_va['wall_s']:.3f} s, "
        f"set-up share {system_va['outside_share']:.3f})")
    for arch, kernel in SERVE_ARCHS:
        fs = [r["serve"][arch] for r in ranks]
        log(f"[launch] (f) {arch} at 2 layers, full width, bf16, sharded "
            f"on {SERVE_AXES} ({LAUNCH_RANKS} ranks sharing the card): a "
            f"prefill of {SERVE_ROWS} x {SERVE_SEQ} into a cache of "
            f"{SERVE_SEQ + SERVE_STEPS} positions and {SERVE_STEPS} decode "
            f"steps writing positions {SERVE_SEQ}-"
            f"{SERVE_SEQ + SERVE_STEPS - 1}, logits within "
            f"{max(f['err'] for f in fs):.3e} of the one-process run's "
            f"largest (tolerance {SERVE_TOL}); {kernel} launched "
            f"{[f['launches'] for f in fs]} a rank; K/V positions a rank "
            f"{[f['kv'] for f in fs]}; walls "
            f"{[round(f['wall_s'], 3) for f in fs]} s, of which the "
            f"prefill {[round(f['prefill_s'], 3) for f in fs]} s (one "
            f"process {ref_walls[arch]:.3f} s); max_memory_allocated "
            f"{[round(f['max_memory_allocated'] / 2**30, 2) for f in fs]} "
            f"GiB; kernel shapes a rank {fs[0]['shapes']}; collectives "
            "(calls, MB, host s) " + "; ".join(
                f"rank {r}: {_coll_text(f['collectives'])}"
                for r, f in enumerate(fs)))
    return {"ranks": ranks, "serve_ref_s": ref_walls,
            "join_s": time.perf_counter() - t0}


def _launch_cell(pim_row: Path) -> dict:
    """[launch] (b): each of :data:`LAUNCH_CELLS` counted on meta and
    priced on the H100, then run for real on the card in bf16 (a warm-up
    prefill, then a timed one): its wall at least its row's max(compute,
    memory) (no card beats its roofline), its kernel launched once a
    layer; max_memory_allocated beside the row's args + out + temp.  The
    row's useful_ratio and roofline_fraction are left out: model_flops is
    2 N a token with N counting the embedding and the lm_head, which the
    port's prefill applies to the last position alone, so at a cut depth
    they say nothing of the card.  Waits for (a)'s PIM row first, so that
    the timed prefills share the card with nothing."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    while not pim_row.exists():
        check(time.perf_counter() - t0 < 300, "[launch] (a) wrote no PIM "
              "row in 300 s")
        time.sleep(0.2)
    shape = ShapeSpec("prefill_32k", "prefill", LAUNCH_SEQ, LAUNCH_BATCH)
    cells = {}
    for arch, kernel in LAUNCH_CELLS:
        cfg, model = _lm_model(arch, **LAUNCH_CUT)
        counts, kind, _, count_s = dryrun.count_cell(cfg, shape)
        row = dryrun.report(arch, cfg, shape, counts, kind,
                            "meta device, counted at its own depth").to_row()
        for key in ("useful_ratio", "roofline_fraction"):
            row.pop(key)
        bound_s = max(row["compute_ms"], row["memory_ms"]) / 1e3
        batch = _lm_inputs(cfg, LAUNCH_BATCH, LAUNCH_SEQ, 0, 5, "cuda")
        model.prefill(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(logits.float()).all()),
              f"[launch] (b) {arch} prefill logits not finite")
        check(launches[kernel] == cfg.n_layers,
              f"[launch] (b) {arch}: {launches[kernel]} {kernel} launches, "
              f"not {cfg.n_layers}")
        check(wall >= bound_s, f"[launch] (b) {arch}: the card took "
              f"{wall:.4f} s, under its row's bound {bound_s:.4f} s: the row "
              f"is miscounted {row}")
        counted = counts.args + counts.out + counts.temp
        cells[arch] = {"wall_s": wall, "bound_s": bound_s, "row": row,
                       "flops": counts.flops, "bytes": counts.bytes,
                       "count_s": count_s, "max_memory_allocated": peak,
                       "args_out_temp": counted, "launches": launches}
        log(f"[launch] (b) {arch} at {cfg.n_layers} layers, {LAUNCH_BATCH} "
            f"x {LAUNCH_SEQ} tokens, bf16: the card {wall:.4f} s >= its "
            f"row's bound {bound_s:.4f} s (compute {row['compute_ms']} ms, "
            f"memory {row['memory_ms']} ms; {counts.flops:.4e} FLOPs, "
            f"{counts.bytes:.4e} bytes; {wall / bound_s:.3f}x the bound); "
            f"max_memory_allocated {peak / 2**30:.3f} GiB beside args + out "
            f"+ temp {counted / 2**30:.3f} GiB; {launches[kernel]} {kernel} "
            "launches")
        del model, logits, cache
        torch.cuda.empty_cache()
    return cells


def _dp_problem(device):
    """The reference's scenario_compressed_dp problem on ``device``: (X, y,
    loss_fn)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16,)).astype(np.float32)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    y = X @ w_true + 0.01 * rng.normal(size=64).astype(np.float32)

    def loss_fn(p, batch):
        xb, yb = batch
        return ((xb @ p["w"] - yb) ** 2).mean()

    return (torch.tensor(X, device=device),
            torch.tensor(y.astype(np.float32), device=device), loss_fn)


def _dp_steps(device, states=None) -> tuple:
    """DP_STEPS steps of make_dp_compressed_step (AdamW at 0.05) on the
    process group, on ``device``: its own run from zeros, or with
    ``states`` each step from ``states[i]``.  Returns (the state before
    each step, each step's loss): a state is {w, m, v, r} on the CPU."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.parallel.compress import make_dp_compressed_step
    X, y, loss_fn = _dp_problem(device)
    opt = adamw(lambda s: torch.tensor(0.05, device=device),
                weight_decay=0.0)
    step = make_dp_compressed_step(loss_fn, opt)
    cur = {k: torch.zeros(16) for k in "wmvr"}
    before, losses = [], []
    for i in range(DP_STEPS):
        if states is not None:
            cur = states[i]
        before.append(cur)
        t = {k: v.to(device, copy=True) for k, v in cur.items()}
        p, o, r, loss = step({"w": t["w"]}, {"m": {"w": t["m"]},
                                             "v": {"w": t["v"]}},
                             {"w": t["r"]}, (X, y), i)
        cur = {"w": p["w"].cpu(), "m": o["m"]["w"].cpu(),
               "v": o["v"]["w"].cpu(), "r": r["w"].cpu()}
        losses.append(float(loss))
    return before, losses


def _quantize_inputs():
    """Exact .5 ties (a block whose scale is exactly 1), a zero block,
    seeded normals and a ragged last block."""
    import numpy as np
    rng = np.random.default_rng(3)
    ties = np.array([127.0, -126.5, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5] * 32,
                    np.float32)
    return np.concatenate([ties, np.zeros(256, np.float32),
                           rng.normal(size=256 * 40).astype(np.float32),
                           (rng.normal(size=77) * 1e3).astype(np.float32)])


def _launch_parallel() -> dict:
    """[launch] (c): repro_torch.parallel on a process group of one rank
    (NCCL for the card's tensors, gloo for the CPU's; a FileStore in a
    temporary directory): quantize_int8 on the card bitwise the CPU's;
    the compressed data-parallel step of the reference's
    scenario_compressed_dp problem, each of its 60 steps on the card from
    the CPU run's state before it (loss within DP_LOSS_TOL relative), the
    card's own 60 steps through the reference scenario's gate (below 0.05,
    within 0.05 of the CPU's); pipeline_apply at one stage equal to the
    stage applied in sequence, outputs and gradients; VA on 64 DPUs
    through ``PIMSystem(cfg, group=...)`` on the NCCL group (its vote and
    its gather of the blocks on the card) bitwise a run without the group:
    state, KernelReport and Timeline."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.compress import quantize_int8
    from repro_torch.parallel.pipeline import pipeline_apply
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            x = torch.from_numpy(_quantize_inputs())
            q_cpu, s_cpu = quantize_int8(x)
            q, s = quantize_int8(x.cuda())
            check(torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu),
                  "[launch] (c) quantize_int8 on the card differs from the "
                  "CPU's")
            cpu_before, cpu_loss = _dp_steps("cpu")
            _, card_loss = _dp_steps("cuda")
            _, forced = _dp_steps("cuda", cpu_before)
            rel = max(abs(a - b) / abs(b) for a, b in zip(forced, cpu_loss))
            check(rel <= DP_LOSS_TOL, f"[launch] (c) a step on the card from "
                  f"the CPU's state: loss {rel:.3e} relative off the CPU's")
            check(card_loss[-1] < 0.05
                  and abs(card_loss[-1] - cpu_loss[-1]) < 0.05,
                  f"[launch] (c) the card's run ended at {card_loss[-1]}, the "
                  f"CPU's at {cpu_loss[-1]}")
            gen = torch.Generator().manual_seed(11)
            w = (torch.randn(16, 16, generator=gen) / 4).cuda()
            xm = torch.randn(8, 4, 16, generator=gen).cuda()
            w.requires_grad_(True)
            got = pipeline_apply(lambda w_, x_: torch.tanh(x_ @ w_), w, xm)
            (g_pipe,) = torch.autograd.grad((got ** 2).sum(), [w])
            want = torch.tanh(xm @ w)
            (g_seq,) = torch.autograd.grad((want ** 2).sum(), [w])
            err = float((got - want).detach().abs().max())
            gerr = float((g_pipe - g_seq).abs().max() / g_seq.abs().max())
            check(err <= 1e-6 and gerr <= 1e-5, f"[launch] (c) pipeline_apply "
                  f"at one stage: outputs {err:.3e} off, gradients {gerr:.3e}")
            from repro_torch.core import compile_cache
            from repro_torch.core.host import PIMSystem
            alone = _system(_full_cfg(), "cuda")
            st, rep = _va(alone, 16, 0.02)
            one = _run_digests(st, rep, alone.timeline)
            grouped = PIMSystem(_full_cfg(), device="cuda",
                                group=dist.group.WORLD)
            v0 = compile_cache.stats()["votes"]
            st, rep = _va(grouped, 16, 0.02)
            votes = compile_cache.stats()["votes"] - v0
            bad = _digest_diff(_run_digests(st, rep, grouped.timeline), one)
            check(not bad and votes > 0, f"[launch] (c) VA through "
                  f"PIMSystem(group=) on the NCCL group: {bad} differ from "
                  f"the run without it ({votes} votes)")
        finally:
            dist.destroy_process_group()
    out = {"dp_step_loss_rel": rel, "card_last_loss": card_loss[-1],
           "cpu_last_loss": cpu_loss[-1],
           "free_rel": float(np.max(np.abs(np.subtract(card_loss, cpu_loss))
                                    / np.abs(cpu_loss))),
           "pipe_err": err, "pipe_grad_rel": gerr, "nccl_votes": votes,
           "seconds": time.perf_counter() - t0}
    log(f"[launch] (c) NCCL and gloo, one rank: quantize_int8 bitwise; "
        f"{DP_STEPS} compressed DP steps on the card from the CPU's states, "
        f"losses within {rel:.3e} relative; the card's own run ended at "
        f"{card_loss[-1]:.6f} (the CPU's {cpu_loss[-1]:.6f}; the free runs "
        f"{out['free_rel']:.3e} apart at most); pipeline_apply at one stage "
        f"{err:.3e} off in outputs, {gerr:.3e} in gradients; VA on 64 "
        f"DPUs through PIMSystem(group=) on NCCL ({votes} votes on the "
        "card) bitwise without it (state, KernelReport, Timeline); "
        f"{out['seconds']:.1f} s")
    return out


def _dryrun_cores() -> set:
    """The host cores (a) pins its dry-runs to: the upper half of this
    process's, so that [train], which runs beside them, keeps the lower
    half to itself."""
    cores = sorted(os.sched_getaffinity(0))
    return set(cores[len(cores) // 2:])


def start_dryruns() -> dict:
    """[launch] (a)'s dry-runs, each in a process of its own at the lowest
    CPU priority and pinned to :func:`_dryrun_cores`, started before
    [train] and collected by [launch]: the 16x16 mesh (every cell and the
    PIM cell), the 2x16x16 mesh for MP_ARCHS and its PIM cell, and the
    one-card rows (d) reads (every architecture and the PIM cell on the
    card); {name: (process, its directory)}, their start time under
    ``"t0"``."""
    import tempfile
    OUT_DIR.mkdir(exist_ok=True)
    cores = _dryrun_cores()

    def lowly():
        os.nice(19)
        os.sched_setaffinity(0, cores)

    out = Path(tempfile.mkdtemp(prefix="dryrun_", dir=OUT_DIR))
    procs = {"t0": time.perf_counter()}
    for name, flags in (
            ("sp", ["--single-pod", "--device", "cpu"]),
            ("mp", ["--multi-pod", "--with-pim", "--device", "cpu"]
             + [a for arch in MP_ARCHS for a in ("--arch", arch)]),
            ("1x1", ["--mesh", "1x1"])):
        d = out / name
        with open(out / f"{name}.out", "w") as so, \
                open(out / f"{name}.err", "w") as se:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
                 str(d), "--jobs", str(DRYRUN_JOBS[name])] + flags,
                env=dict(os.environ, PYTHONPATH=str(SRC)),
                preexec_fn=lowly, stdout=so, stderr=se), d)
        BACKGROUND.append(procs[name][0])
    return procs


def _check_mesh_rows(rows: list, mesh: str, archs) -> tuple:
    """(a)'s rows of ``mesh``: every (arch, shape) of ``archs`` OK or
    SKIP(policy), named for its mesh, collective_ms >= 0, the PIM cell's
    consensus priced; (the LM rows OK, the PIM row)."""
    from repro_torch.configs.base import SHAPES
    lm = [r for r in rows if r["arch"] in archs]
    check(sorted((r["arch"], r["shape"]) for r in lm)
          == sorted((a, sh) for a in archs for sh in SHAPES)
          and all(r["status"] in ("OK", "SKIP(policy)")
                  and r["mesh"] == mesh for r in lm),
          f"[launch] (a) {mesh} rows: "
          f"{[(r['arch'], r.get('shape'), r['status']) for r in lm]}")
    ok = [r for r in lm if r["status"] == "OK"]
    check(all(r["collective_ms"] >= 0 and "bytes_per_device" in r
              for r in ok), f"[launch] (a) {mesh}: a row without its "
          "collective or memory terms")
    (pim,) = [r for r in rows if r["arch"] not in archs]
    check(pim["status"] == "OK" and pim["mesh"] == mesh
          and pim["collective_bytes_per_cycle"].get("all-reduce", 0) > 0,
          f"[launch] (a) the {mesh} PIM cell: {pim}")
    return ok, pim


def _launch_reports(scripts_run: dict, rows: list, one_card: Path) -> str:
    """[launch] (d) (once (a)'s one-card rows are written): the offload
    planner's twin among [scripts]' golden runs, torch_run.py --suite lm
    reading the rows with no error row, the hillclimb twin equal to them;
    its log line."""
    import tempfile
    sr = _script_runs()
    runs = {r["key"]: r for r in scripts_run["runs"]}
    planner = runs.get("examples/pim_offload_planner")
    check(planner is not None
          and planner["launches"].get("cycle_step", 0) > 0,
          f"[launch] (d) the offload planner's twin was not among [scripts]' "
          f"golden runs, or launched no cycle_step: {planner}")
    rc, text = sr.run_main(sr.load_script(ROOT, "benchmarks/run.py",
                                          twin=True),
                           ["--suite", "lm", "--dryrun-dir", str(one_card)])
    name, _, table = text.splitlines()[0].split(",", 2)
    table = json.loads(table)
    check(rc == 0 and name == "lm_roofline" and len(table) == len(rows)
          and not any("error" in r for r in table),
          f"[launch] (d) torch_run.py --suite lm: exit {rc}, {text[-2000:]}")
    with tempfile.TemporaryDirectory() as tmp:
        rc, text = sr.run_main(
            sr.load_script(ROOT, "benchmarks/lm_hillclimb.py", twin=True),
            ["--dryrun-dir", str(one_card), "--out", tmp])
    diffs = [line.split(": ", 1)[1].split(" -> ")
             for line in text.splitlines() if " -> " in line]
    check(rc == 0 and len(diffs) == 15 and all(a == b for a, b in diffs),
          f"[launch] (d) torch_lm_hillclimb.py: exit {rc}, {text[-2000:]}")
    return (f"[launch] (d) the planner twin's golden run in [scripts] "
            f"({planner['wall_s']:.3f} s, {planner['launches']}); "
            f"torch_run.py --suite lm: {len(table)} rows, no error; "
            "torch_lm_hillclimb.py: exit 0, its 3 cells equal to the "
            "sweep's")


def phase_launch(scripts_run: dict, system_run: dict, procs: dict) -> dict:
    """[launch] (a) the dry-runs of :func:`start_dryruns` (``procs``,
    started before [train]) collected: the production meshes' sweep
    (16x16 whole, 2x16x16 for MP_ARCHS, each with its PIM cell) and the
    one-card rows (d) reads; (e) cycle_step's sharded cases and the
    full-system PIM cell through ``PIMSystem(group=)`` with their DPUs
    split over four ranks sharing the card, bitwise one-process runs, and
    (f) sharded serving on four ranks, both in the ranks' processes,
    started first and held until this process is done with the card: (c)
    the parallel modules on a process group, (b) a counted cell run for
    real (the card its own), (e)'s one-process case runs and (f)'s; then,
    while the ranks run, (d) the report scripts once the one-card rows
    are written: the offload planner's twin among [scripts]' golden runs,
    torch_run.py --suite lm reading the one-card rows, the hillclimb twin
    re-counting its cells equal to them.  The phase within
    LAUNCH_LIMIT_S."""
    from repro_torch.configs.base import ARCH_IDS
    t0 = time.perf_counter()
    one_card = procs["1x1"][1]
    tmpdir, ctx = _start_ranks()
    try:
        parallel = _launch_parallel()
        cells = _launch_cell(one_card / "pim-engine__fleet_sim__1x1.json")
        case_digests = _shard_case_digests()
        ref_walls = _serve_reference(tmpdir.name)
        _let_ranks_go(tmpdir, {"cases": case_digests,
                               "va": system_run["va"]["digests"]})
        done = {}
        for name in ("1x1", "sp", "mp"):
            proc, d = procs[name]
            proc.wait(timeout=max(1.0, LAUNCH_LIMIT_S
                                  - (time.perf_counter() - t0)))
            stdout = d.with_suffix(".out").read_text()
            stderr = d.with_suffix(".err").read_text()
            check(proc.returncode == 0, f"[launch] (a) the {name} dry-run "
                  f"exited {proc.returncode}:\n{stdout[-2000:]}"
                  f"{stderr[-3000:]}")
            done[name] = (_dryrun_rows(d), stdout.strip().splitlines()[-1],
                          time.perf_counter() - procs["t0"])
            if name == "1x1":
                report = _launch_reports(scripts_run, done[name][0],
                                         one_card)
        ranks = _finish_ranks(tmpdir, ctx, system_run["va"], ref_walls)
    except subprocess.TimeoutExpired as e:
        raise SmokeError(f"[launch] (a) a dry-run outlasted the phase's "
                         f"{LAUNCH_LIMIT_S} s: {e}") from e
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    rows, last, one_s = done["1x1"]
    lm = [r for r in rows if r["arch"] in ARCH_IDS]
    ok = [r for r in lm if r["status"] == "OK"]
    check(len(lm) == len(ARCH_IDS) * 4 and all(
        r["status"] in ("OK", "SKIP(policy)") and r["mesh"] == "1x1"
        for r in lm), f"[launch] (a) one-card rows: "
          f"{[(r['arch'], r.get('shape'), r['status']) for r in lm]}")
    (pim,) = [r for r in rows if r["arch"] not in ARCH_IDS]
    check(pim["status"] == "OK" and pim["cycle_step_launches"] == 1
          and pim["bytes_per_device"]["temp"] is not None,
          f"[launch] (a) the one-card PIM cell: {pim}")
    log(f"[launch] (a) python -m repro_torch.launch.dryrun --mesh 1x1 "
        f"(every architecture): {len(ok)} OK, "
        f"{len(lm) - len(ok)} SKIP(policy), the PIM cell "
        f"(state {pim['bytes_per_device']['args'] / 2**30:.3f} GiB, "
        f"{pim['cycle_step_launches']} cycle_step launch, temp "
        f"{pim['bytes_per_device']['temp'] / 2**20:.1f} MiB); collected "
        f"{one_s:.1f} s after its start (before [train]); its last line: "
        f"{last}")
    meshes = {}
    for name, mesh, archs in (("sp", "16x16", ARCH_IDS),
                              ("mp", "2x16x16", MP_ARCHS)):
        mrows, mlast, secs = done[name]
        mok, mpim = _check_mesh_rows(mrows, mesh, archs)
        meshes[mesh] = {"rows": mok, "pim": mpim, "done_s": secs}
        log(f"[launch] (a) python -m repro_torch.launch.dryrun "
            f"--{'multi' if name == 'mp' else 'single'}-pod: {len(mok)} OK "
            f"of {len(archs)} architectures x 4 shapes (the rest "
            f"SKIP(policy)), the PIM cell ({mpim['dpus_per_device']} DPUs a "
            f"rank, state {mpim['bytes_per_device']['args'] / 2**20:.2f} "
            f"MiB, {mpim['collective_bytes_per_cycle']} collective bytes a "
            f"cycle); collected {secs:.1f} s after its start; its last "
            f"line: {mlast}")
        for r in mok:
            gib = sum(r["bytes_per_device"].values()) / 2**30
            log(f"[launch] (a) {mesh} {r['arch']} x {r['shape']}: compute "
                f"{r['compute_ms']} ms, memory {r['memory_ms']} ms, "
                f"collective {r['collective_ms']} ms {r['coll']}, "
                f"bottleneck {r['bottleneck']}, {gib:.2f} GiB a device, "
                f"useful {r['useful_ratio']}")
    seconds = time.perf_counter() - t0
    log(report + f"; phase {seconds:.1f} s")
    check(seconds <= LAUNCH_LIMIT_S, f"[launch] took {seconds:.1f} s, over "
          f"its {LAUNCH_LIMIT_S} s")
    return {"rows": len(rows), "ok": len(ok), "pim": pim, "cells": cells,
            "parallel": parallel, "meshes": meshes, "ranks": ranks,
            "seconds": seconds}


MESH_ARCH = "qwen3-moe-30b-a3b"
#: depth: 1 of its 48 layers (PR 27-28's 2 took the phase to 89.4-94.6 s
#: of its 90, most of it the experts' gathers over gloo)
MESH_CUT = dict(n_layers=1)
#: the (data, model) mesh of the sharded step's four ranks on the one
#: card, and the one its checkpoint is restored onto
MESH_AXES = {"data": 2, "model": 2}
MESH_ELASTIC = {"data": 4, "model": 1}
MESH_ROWS, MESH_SEQ = 8, 1024
MESH_TOL = BWD_TOL["bfloat16"]
MESH_LR = 1e-3
MESH_SEED = 0
#: the phase's share of the smoke's 1,200 s
MESH_LIMIT_S = 90
#: optim.adamw's eps
ADAMW_EPS = 1e-8


def _flat(tree, prefix="") -> dict:
    """A nested dict's leaves keyed by their ``/``-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _mesh_replay(calls, axes, coord, device):
    """``moe.top_k`` for the rank at ``coord`` of a mesh of ``axes`` that
    returns what the one-process reference chose (``calls``: its top-k
    indices, call by call): top-k is discontinuous, and bf16 noise between
    a one-row and a two-row product could break a near tie the other way
    and move a token's whole gradient.  Each MoE layer's calls there are
    the router's, then one capacity selection for each (data slice, EP
    peer); a rank's, the router's on its rows, then its own peer's on its
    own slice."""
    import itertools
    dp, ep = axes["data"], axes["model"]
    per = 1 + dp * ep
    count = itertools.count()
    calls = [c.to(device) for c in calls]

    def top_k(probs, k):
        layer, kind = divmod(next(count), 2)
        idx = calls[layer * per + (0 if kind == 0 else
                                   1 + coord["data"] * ep + coord["model"])]
        if kind == 0:
            rows = probs.shape[0]
            idx = idx[coord["data"] * rows:(coord["data"] + 1) * rows]
        return probs.gather(-1, idx), idx

    return top_k


def _mesh_rank(rank, world, tmp, refs, cfg, device):
    """[mesh] rank ``rank`` of ``world`` (gloo, a FileStore in ``tmp``;
    started while the parent takes the reference step, whose results it
    then takes from the queue ``refs``, tensors mapped from the parent):
    its blocks of the reference's initial weights on a MESH_AXES mesh, the
    sharded step (counted and timed),
    its gradients and updates against the reference's, the (2, 2)
    save, the restore onto MESH_ELASTIC and as one rank, each bitwise
    against the whole saved leaves; ``tmp/rank<r>.json``."""
    # four ranks and the reference share the card: segments that grow in
    # place leave less of it reserved but unused (set before CUDA starts)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(SRC))
    if device == "cuda":
        _blocking_sync()
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import store
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import convert, moe
    from repro_torch.models.layers import cdtype
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import loop
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    top_k = moe.top_k
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        out = {"rank": rank}
        t0 = time.perf_counter()
        mesh = make_elastic_mesh(model_parallel=MESH_AXES["model"],
                                 device_type=device)
        check(par.mesh_axes(mesh) == MESH_AXES, f"[mesh] {mesh}")
        ranks = par.mesh_ranks(mesh)
        # while the parent takes its step: the same step at the family's
        # smoke width (a fresh process's first calls; a little memory)
        small = get_smoke_config(MESH_ARCH).replace(
            train_microbatches=cfg.train_microbatches)
        warm = Transformer(small, device=device)
        par.shard_module(warm, mesh, cdtype(small))
        loop.grads_and_metrics(warm, par.batch_rows(loop.to_device(
            SyntheticLM(small, DataConfig(64, 8, small.vocab_size))
            .batch_at(0), device), mesh), small.train_microbatches)
        del warm
        out["warmup_s"] = time.perf_counter() - t0
        ref = refs.get()
        t0 = time.perf_counter()
        # the reference's weights: the whole model from its seed, drawn
        # on the card, kept as this rank's blocks
        model = Transformer(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(MESH_SEED))
        par.shard_module(model, mesh, cdtype(cfg))
        if device == "cuda":
            torch.cuda.empty_cache()
        params = dict(model.named_parameters())
        opt = get_optimizer(cfg.optimizer, warmup_cosine(MESH_LR))
        state = {"params": model, "step": 0, "opt": opt.init(params)}
        rows = {k: v.to(device)
                for k, v in par.batch_rows(ref["batch"], mesh).items()}
        moe.top_k = _mesh_replay(ref["calls"], MESH_AXES, ranks.coord,
                                 device)
        # the initial blocks, on the host: each update is held against
        # the reference's
        init = {n: p.detach().to("cpu", copy=True)
                for n, p in params.items()}
        out["setup_s"] = time.perf_counter() - t0
        coll.reset_counts()
        from repro_torch.kernels.ssd_scan import ops as sops
        shapes = _record_shapes(fops, sops)
        for attr in ("launches", "launches_sm90", "launches_bwd",
                     "launches_bwd_sm90"):
            setattr(fops, attr, 0)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        metrics, grads = loop.grads_and_metrics(model, rows,
                                                cfg.train_microbatches)
        state, gnorm = loop.apply_gradients(state, grads, opt)
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        out["step_s"] = time.perf_counter() - t0
        out["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                       if device == "cuda" else 0)
        out["launches"] = {a: getattr(fops, a) for a in (
            "launches", "launches_sm90", "launches_bwd",
            "launches_bwd_sm90")}
        out["collectives"] = dict(coll.COUNTS)
        out["shapes"] = sorted(shapes)
        out["loss"] = float(metrics["loss"])
        out["grad_norm"] = float(gnorm)

        def block(whole, n):
            return par.shard(whole[n], model.shardings[n], mesh).to(
                device).float()

        def worst(mine, kind, slack=None):
            """(max over leaves of max |block - its reference block| (less
            ``slack``) over the reference leaf's largest |value|, that
            leaf)."""
            errs = {}
            for n in mine:
                want = block(ref[kind], n)
                d = (mine[n].float() - want).abs()
                if slack is not None:
                    d = (d - slack(n)).clamp_min(0)
                errs[n] = float(d.max()) / max(ref["max"][kind][n], 1e-30)
            n = max(errs, key=errs.get)
            return errs[n], n

        # AdamW's first step moves an element by -lr (r(x) + wd p), r(x) =
        # x / (|x| + eps), x its clipped gradient: by about lr against x's
        # sign, and steeply in x where x is within a few eps of 0 (or where
        # the two gradients' signs differ, both then within the gradient
        # check's tolerance of 0).  So each update is held to the
        # reference's, relative to its largest value (about lr), less what
        # the two gradients themselves put between them, lr |r(x) -
        # r(x_ref)|, and one unit in the last place of the updated weight
        # (an update is read as the difference of two float32 weights: at
        # an embedding's |p| ~ 2, 0.04 of lr); a missing or wrong update
        # fails wherever the gradients agree
        lr = float(warmup_cosine(MESH_LR)(1))
        out["loose"] = 0

        def ratio(g, gn):
            x = g * min(1.0, 1.0 / max(gn, 1e-9))  # clip_by_global_norm's
            return x / (x.abs() + ADAMW_EPS)

        def ulp(p):
            a = p.float().abs()
            return torch.nextafter(a, torch.full_like(a, float("inf"))) - a

        def slack(n):
            room = lr * (ratio(grads[n].float(), float(gnorm))
                         - ratio(block(ref["grads"], n),
                                 ref["grad_norm"])).abs()
            # elements the gradients leave beyond the tolerance
            out["loose"] += int((room > MESH_TOL * ref["max"]["update"][n])
                                .sum())
            return room + ulp(params[n].detach())

        out["grad_err"], out["grad_worst"] = worst(grads, "grads")
        out["update_err"], out["update_worst"] = worst(
            {n: p.detach() - init[n].to(device) for n, p in params.items()},
            "update", slack=slack)
        out["elements"] = sum(p.numel() for p in params.values())
        del grads, state["opt"], init

        ckpt = f"{tmp}/ckpt"
        coll.reset_counts()
        t0 = time.perf_counter()
        blocks = convert.jax_tree(dict(params), host=False)
        specs = convert.jax_specs(model)
        store.save(ckpt, 1, {"params": blocks}, shardings={"params": specs},
                   mesh=mesh)
        out["save_s"] = time.perf_counter() - t0
        out["save_collectives"] = dict(coll.COUNTS)
        del model, params, state
        like = {"params": convert.nest({
            k: np.empty(tuple(t.shape), np.float32)
            for k, t in _flat(convert.jax_like(
                {n: torch.empty(s, device="meta")
                 for n, s in ref["shapes"].items()})).items()})}
        mesh_b = make_elastic_mesh(model_parallel=MESH_ELASTIC["model"],
                                   device_type=device)
        specs_b = par.param_shardings(like["params"], mesh_b)
        t0 = time.perf_counter()
        restored, _ = store.restore(ckpt, like, shardings={
            "params": specs_b}, mesh=mesh_b, device=device)
        out["restore_elastic_s"] = time.perf_counter() - t0
        whole = None
        if rank == 0:
            t0 = time.perf_counter()
            whole, _ = store.restore(ckpt, like)
            out["restore_one_s"] = time.perf_counter() - t0
            whole = _flat(whole["params"])
        # each rank's blocks of both meshes against the saved leaves'
        # regions, rank 0's one-rank restore against the whole leaves (as
        # the file maps them; the tests hold that reader to numpy's, both
        # ways between the packages)
        coord_b = par.coordinate(mesh_b)
        specs, specs_b = _flat(specs), _flat(specs_b)
        blocks, restored = _flat(blocks), _flat(restored["params"])
        out["bitwise"] = {"mesh": 0, "elastic": 0, "one": 0, "leaves": 0}
        t0 = time.perf_counter()
        saved = store._members(str(Path(ckpt, "step_1", "shard_0.npz")))
        for path in blocks:
            w = saved[f"params/{path}"]
            out["bitwise"]["leaves"] += 1
            mine = blocks[path]() if callable(blocks[path]) else blocks[path]
            out["bitwise"]["mesh"] += np.array_equal(
                mine.cpu().numpy(), w[par.block_slices(
                    w.shape, specs[path], MESH_AXES, ranks.coord)])
            out["bitwise"]["elastic"] += np.array_equal(
                restored[path].cpu().numpy(), w[par.block_slices(
                    w.shape, specs_b[path], MESH_ELASTIC, coord_b)])
            out["saved_bytes"] = out.get("saved_bytes", 0) + w.nbytes
        out["bitwise"]["one"] = sum(
            whole is None or np.array_equal(whole[path],
                                            saved[f"params/{path}"])
            for path in blocks)
        out["compare_s"] = time.perf_counter() - t0
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        # let go of the parent's tensors (the replay holds its choices)
        # before the process ends
        moe.top_k = top_k
        dist.destroy_process_group()


def _mesh_run(cfg, device, rows, seq, world=4) -> dict:
    """[mesh]'s run: ``world`` ranks of :func:`_mesh_rank` started (they
    reach the card and join their group meanwhile), the one-process
    reference step (``moe_ep_plain`` under ``mesh_context(MESH_AXES)``,
    the experts' choices recorded), its results handed to the ranks (the
    ranks map its tensors; they take the card once its step is done);
    each rank's results, the reference's and the walls."""
    import tempfile
    import torch.multiprocessing as tmp_mp
    t_phase = time.perf_counter()
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    refs = tmp_mp.get_context("spawn").SimpleQueue()
    ranks_ctx = tmp_mp.start_processes(
        _mesh_rank, args=(world, tmp, refs, cfg, device), nprocs=world,
        join=False, start_method="spawn")
    try:
        # the reference's tensors stay alive until the ranks are done
        run, ref = _mesh_reference(cfg, device, rows, seq, refs, world)
        t0 = time.perf_counter()
        while not ranks_ctx.join():
            pass
        del ref
        run["ranks_s"] = time.perf_counter() - t0
        run["ranks"] = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                        for r in range(world)]
    except Exception as e:
        raise SmokeError(f"[mesh] {type(e).__name__}: {e}") from e
    finally:
        for p in ranks_ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
        tmpdir.cleanup()
    run["seconds"] = time.perf_counter() - t_phase
    return run


def _mesh_reference(cfg, device, rows, seq, refs, world) -> dict:
    """The one-process reference step of :func:`_mesh_run` (its results,
    its tensors): the tensors put on ``refs`` once for each of the
    ``world`` ranks."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.parallel import api as par
    from repro_torch.train import loop
    t_ref = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(MESH_SEED)
    model = Transformer(cfg, device=device, generator=gen)
    opt = get_optimizer(cfg.optimizer, warmup_cosine(MESH_LR))
    state = {"params": model, "step": 0,
             "opt": opt.init(dict(model.named_parameters()))}
    batch = loop.to_device(SyntheticLM(cfg, DataConfig(
        seq, rows, cfg.vocab_size)).batch_at(0), device)
    calls, top_k = [], moe.top_k
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    def record(probs, k):
        vals, idx = top_k(probs, k)
        calls.append(idx.detach().clone())
        return vals, idx

    moe.top_k = record
    t0 = time.perf_counter()
    try:
        with par.mesh_context(MESH_AXES):
            metrics, grads = loop.grads_and_metrics(model, batch,
                                                    cfg.train_microbatches)
            state, gnorm = loop.apply_gradients(state, grads, opt)
    finally:
        moe.top_k = top_k
    if device == "cuda":
        torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    # the updates, the gradients (bf16: 2e-2 of the largest value is 2^11
    # of its rounding), each leaf's largest |value|; the ranks map them
    # from this process (CUDA IPC on the card)
    update = {n: p.detach() - init.pop(n)
              for n, p in model.named_parameters()}
    ref = {"shapes": {n: tuple(u.shape) for n, u in update.items()},
           "grads": {n: g.to(torch.bfloat16) for n, g in grads.items()},
           "update": update, "batch": batch, "calls": calls,
           # the scale of each check: the gradient's largest |value|, the
           # update's
           "max": {"grads": {n: float(g.abs().max())
                             for n, g in grads.items()},
                   "update": {n: float(u.abs().max())
                              for n, u in update.items()}}}
    ref["grad_norm"] = float(gnorm)
    out = {"loss": float(metrics["loss"]), "grad_norm": float(gnorm),
           "ref_s": ref_s}
    del state, grads, model, metrics, gnorm
    if device == "cuda":
        torch.cuda.empty_cache()
    for _ in range(world):
        refs.put(ref)
    out["ref_total_s"] = time.perf_counter() - t_ref
    return out, ref


def phase_mesh() -> dict:
    """[mesh] sharded training on the card: four ranks (processes sharing
    the one card; gloo, which NCCL's one-rank-a-device rule leaves) on a
    (data 2, model 2) mesh take one step of qwen3-moe-30b-a3b at full
    width and 1 of its 48 layers (bf16 on float32 weights, AdamW, its 4
    microbatches, 8 x 1,024 tokens; random weights from a seed), each
    rank's parameters and moments its blocks by param_shardings, its
    rows by batch_sharding, its experts expert-parallel: every gradient
    and updated block, and the loss, within MESH_TOL of a one-process
    step on the card with moe_ep_plain in the EP group's place (the
    experts' choices replayed; each update against the reference's);
    the tensor-core flash forward and backward launched on every rank,
    as many times as the path runs them; the state saved from (2, 2) and
    restored onto (4, 1) and as one rank, bitwise; the step's wall, each
    rank's max_memory_allocated and collectives (count and bytes); the
    phase within MESH_LIMIT_S."""
    import torch
    from repro_torch.configs.base import get_config
    torch.cuda.empty_cache()
    cfg = get_config(MESH_ARCH).replace(**MESH_CUT)
    run = _mesh_run(cfg, "cuda", MESH_ROWS, MESH_SEQ)
    # a forward a layer and microbatch, and its recomputation; a backward
    fwd = cfg.n_layers * cfg.train_microbatches * (
        2 if cfg.remat == "block" else 1)
    bwd = cfg.n_layers * cfg.train_microbatches
    for r in run["ranks"]:
        rel = abs(r["loss"] - run["loss"]) / abs(run["loss"])
        check(rel <= MESH_TOL and r["grad_err"] <= MESH_TOL
              and r["update_err"] <= MESH_TOL,
              f"[mesh] rank {r['rank']}: loss {r['loss']} against "
              f"{run['loss']}, gradients {r['grad_err']:.3e} and updates "
              f"{r['update_err']:.3e} of their leaf's largest value")
        n = r["launches"]
        check(n["launches"] == n["launches_sm90"] == fwd
              and n["launches_bwd"] == n["launches_bwd_sm90"] == bwd,
              f"[mesh] rank {r['rank']} launched {n}, not {fwd} sm90 "
              f"forwards and {bwd} sm90 backwards")
        b = r["bitwise"]
        check(b["mesh"] == b["elastic"] == b["one"] == b["leaves"] > 0,
              f"[mesh] rank {r['rank']}: of {b['leaves']} leaves "
              f"{b['mesh']} of its (2, 2) blocks, {b['elastic']} of its "
              f"(4, 1) blocks and {b['one']} leaves restored as one rank "
              "bitwise the saved state's")
    r0 = run["ranks"][0]
    log(f"[mesh] {MESH_ARCH} at {MESH_CUT['n_layers']} layers, "
        f"{MESH_ROWS} x {MESH_SEQ} tokens, {cfg.train_microbatches} "
        f"microbatches, 4 ranks on one card, mesh {MESH_AXES}: loss "
        + ", ".join(f"{r['loss']:.6f}" for r in run["ranks"])
        + f" (one process: {run['loss']:.6f}); gradients within "
        + ", ".join(f"{r['grad_err']:.3e}" for r in run["ranks"])
        + f" (the worst leaf {r0['grad_worst']}), updates within "
        + ", ".join(f"{r['update_err']:.3e}" for r in run["ranks"])
        + f" (the worst leaf {r0['update_worst']}) of their reference "
        f"leaf's largest value (tolerance {MESH_TOL}, less one ulp of the "
        "updated weight and lr |r(x) - r(x_ref)|, r(x) = x / (|x| + eps) "
        "of the two clipped gradients; that term beyond the tolerance at "
        + ", ".join(f"{r['loose']} of {r['elements']}"
                    for r in run["ranks"]) + " elements)")
    log("[mesh] launches a rank (flash forward all / sm90, backward all / "
        "sm90): " + "; ".join(
            "rank {rank}: {launches} / {launches_sm90}, {launches_bwd} / "
            "{launches_bwd_sm90}".format(rank=r["rank"], **r["launches"])
            for r in run["ranks"]))
    log("[mesh] the step's wall " + ", ".join(
        f"{r['step_s']:.3f}" for r in run["ranks"]) + " s; "
        "max_memory_allocated " + ", ".join(
        f"{r['max_memory_allocated'] / 2**30:.2f}" for r in run["ranks"])
        + f" GiB; the flash kernel's shapes a rank {r0['shapes']}; "
        "collectives by rank (calls, MB handed to gloo, which stages CUDA "
        "tensors through host memory, host s in them): " + "; ".join(
            f"rank {r['rank']}: {_coll_text(r['collectives'])}"
            for r in run["ranks"])
        + "; rank 0's save: " + _coll_text(r0["save_collectives"]))
    log(f"[mesh] saved from (2, 2) ({r0['saved_bytes'] / 1e9:.2f} GB, "
        f"{r0['save_s']:.1f} s), restored onto (4, 1) "
        f"({r0['restore_elastic_s']:.1f} s) and as one rank by rank 0 "
        f"({r0['restore_one_s']:.1f} s): {r0['bitwise']['leaves']} leaves, "
        "every rank's blocks of both meshes and the one-rank restore bitwise "
        "the saved leaves (numpy's reader, "
        f"{r0['compare_s']:.1f} s); the ranks' warm-up "
        f"{r0['warmup_s']:.1f} s, set-up {r0['setup_s']:.1f} s; the "
        f"reference {run['ref_total_s']:.1f} s (its step "
        f"{run['ref_s']:.1f} s), the ranks after it {run['ranks_s']:.1f} "
        f"s, phase {run['seconds']:.1f} s (limit {MESH_LIMIT_S} s)")
    check(run["seconds"] <= MESH_LIMIT_S,
          f"[mesh] took {run['seconds']:.1f} s, over its {MESH_LIMIT_S} s")
    return run


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
    walls = {}                             # host seconds of each phase

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[fn.__name__.removeprefix("phase_")] = round(
            time.perf_counter() - t0, 1)
        return out

    try:
        timed(phase_build)
        err = timed(phase_kernels)
        lm_err = timed(phase_lm_kernels)
        step_run = timed(phase_step)
        step_err = step_run["max_abs_err"]
        timed(phase_golden)
        full = timed(phase_full_parity)
        main_run = timed(phase_main_path, args.scale)
        step_times = timed(
            phase_step_times, main_run.pop("launch_args"),
            n=max(1, min(100, main_run["launches"] - 11)))
        from repro_torch.core.compile_cache import dpu_bucket
        times = timed(phase_kernel_times, dpu_bucket(_full_cfg().n_dpus))
        work = timed(phase_workloads)
        simt_run = timed(phase_simt)
        system_run = timed(phase_system)
        cluster_run = timed(phase_cluster, work.pop("recordings"))
        scripts_run = timed(
            phase_scripts,
            next(r for r in work["full"] if r["workload"] == "VA"))
        timed(phase_lm_parity)
        lm_run = timed(phase_lm_main)
        lm_times = timed(phase_lm_kernel_times)
        dryruns = start_dryruns()
        train = timed(phase_train)
        launch = timed(phase_launch, scripts_run, system_run, dryruns)
        mesh = timed(phase_mesh)
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
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
        # [scripts]: the study twins in this process, engine_perf in its own
        "scripts_launches": scripts_run["launches"].get("cycle_step", 0)
        + scripts_run["engine_perf"]["launches"]["cycle_step"],
        # [launch] (a): the dry-run's PIM cell, in the dry-run's process
        "launch_launches": launch["pim"]["cycle_step_launches"],
        # [launch] (e): the full system's DPUs split over four ranks, each
        # rank's launches (the resident route: K-blocks and catch-ups)
        "launch_rank_launches": [r["pim"]["launches"]
                                 for r in launch["ranks"]["ranks"]],
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
            "routes": {r: v["ms"] for r, v in times["routes"].items()},
            "scripts_launches": scripts_run["launches"].get(name, 0)})
    replaces = {
        "flash_attention":
            ("src/repro/kernels/flash_attention/flash_attention.py:67",
             "flash_attention/csrc/flash_attention_sm90.cu"),
        "ssd_scan": ("src/repro/kernels/ssd_scan/ssd_scan.py:57",
                     "ssd_scan/csrc/ssd_scan.cu"),
        "ssd_scan_tc": ("src/repro/kernels/ssd_scan/ssd_scan.py:57",
                        "ssd_scan/csrc/ssd_scan_tc.cu")}
    # the scalar SSD kernel's launches on the main path: those of neither
    # route but the tensor-core one; flash's, llama3-8b's alone (the shape
    # its ms is timed at; each other family's are in its own entry below)
    lm = {r["arch"]: r for r in lm_run["runs"]}
    launched = dict(lm_run["launches"])
    launched["ssd_scan"] -= launched["ssd_scan_tc"]
    launched["flash_attention"] = lm["llama3-8b"]["launches"].get(
        "flash_attention", 0)
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
    # [launch] (b): the counted cell run for real
    cells = launch["cells"]
    flash["launch_launches"] = cells["llama3-8b"]["launches"][
        "flash_attention"]
    ssd_tc = next(k for k in kernels if k["name"] == "ssd_scan_tc")
    ssd_tc["launch_launches"] = cells["mamba2-130m"]["launches"][
        "ssd_scan_tc"]
    # [launch] (f): sharded serving, each rank's launches
    served = [r["serve"] for r in launch["ranks"]["ranks"]]
    flash["launch_rank_launches"] = [
        f["llama3-8b"]["launches"]["flash_sm90"] for f in served]
    ssd_tc["launch_rank_launches"] = [
        f["mamba2-130m"]["launches"]["ssd_scan_tc"] for f in served]
    # the shapes the ranks launch them at: each rank's heads (tensor
    # parallel on model), its rows
    flash["launch_rank_shapes"] = served[0]["llama3-8b"]["shapes"]
    ssd_tc["launch_rank_shapes"] = served[0]["mamba2-130m"]["shapes"]
    flash["launches_by_arch"] = {
        a: r["launches"].get("flash_attention", 0) for a, r in lm.items()}
    # [mesh]: the sharded qwen3-moe step's launches on each rank
    mesh_launches = [r["launches"] for r in mesh["ranks"]]
    # the same kernel at each other family's prefill shape: its launches
    # are those of that family's run
    src, csrc = replaces["flash_attention"]
    for name, (arch, shape) in FLASH_FAMILIES.items():
        key = f"flash_attention ({name})"
        r = lm_times[key]
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/kernels/{csrc}", "replaces": src,
            "launches": lm[arch]["launches"].get("flash_attention", 0),
            "max_abs_err": lm_err[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "arch": arch, "shape": shape})
        if arch == MESH_ARCH:
            kernels[-1]["mesh_launches"] = [
                m["launches_sm90"] for m in mesh_launches]
            kernels[-1]["mesh_shapes"] = mesh["ranks"][0]["shapes"]
    # the backward kernels: no Pallas kernel; they stand for jax.grad of
    # the jnp functions the forward kernels compute.  Launches: the
    # tensor-core routes', [train] (c)'s timed bf16 steps (llama3-8b's for
    # flash, mamba2-130m's for SSD); the scalar ones', the float32 training
    # paths (flash: (d)'s quickstart; SSD: (b)'s float32 mamba2-130m step)
    timed_runs = {r["arch"]: r for r in train["timed"]}
    parity_runs = {r["arch"]: r for r in train["parity"]}
    quick = train["quickstart"]["launches"]
    for name, src, csrc, launches in (
            ("flash_attention_bwd_sm90", "src/repro/models/attention.py:28",
             "flash_attention/csrc/flash_attention_bwd_sm90.cu",
             timed_runs["llama3-8b"]["launches"]["flash_attention_bwd_sm90"]),
            ("flash_attention_bwd", "src/repro/models/attention.py:28",
             "flash_attention/csrc/flash_attention_bwd.cu",
             quick["flash_attention_bwd"]),
            ("ssd_scan_bwd_tc", "src/repro/models/ssm.py:58",
             "ssd_scan/csrc/ssd_scan_bwd_tc.cu",
             timed_runs["mamba2-130m"]["launches"]["ssd_scan_bwd_tc"]),
            ("ssd_scan_bwd", "src/repro/models/ssm.py:58",
             "ssd_scan/csrc/ssd_scan_bwd.cu",
             parity_runs["mamba2-130m"]["launches_f32"]["ssd_scan_bwd"])):
        r = train["times"][name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{csrc}", "replaces": src,
            "launches": launches,
            "max_abs_err": train["max_abs_err"][name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "stands_for": "jax.value_and_grad of the jnp function (no "
                          "Pallas backward)", "shape": r["shape"],
            "kernels_ms": r["parts"]}
        if name == "flash_attention_bwd_sm90":
            w = train["times"]["flash_attention_bwd_sm90 (window)"]
            entry["window"] = {k: w[k] for k in (
                "shape", "ms", "parts", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}
            # every bf16 training step's launches, and the kernel at each
            # family's training shape
            entry["launches_by_arch"] = {
                a: r["launches"]["flash_attention_bwd_sm90"]
                for a, r in timed_runs.items()}
            entry["families"] = {
                fam: {"arch": arch, **{k: w[k] for k in (
                    "shape", "ms", "library_ms", "bound_ms", "bound_by")}}
                for fam, (arch, w) in _family_bwd_times(train).items()}
            entry["mesh_launches"] = [m["launches_bwd_sm90"]
                                      for m in mesh_launches]
            entry["mesh_shapes"] = mesh["ranks"][0]["shapes"]
        if name in ("flash_attention_bwd", "ssd_scan_bwd"):
            # the head-tiled kernels at the wide timing shape
            w = train["times"][f"{name} (wide)"]
            entry["wide"] = {k: w[k] for k in (
                "shape", "dtype", "ms", "parts", "plain_ms", "bound_ms",
                "bound_by")}
            entry["wide"]["max_abs_err"] = train["max_abs_err"][
                f"{name} (wide)"]
        kernels.append(entry)
    # the scalar flash backward at recurrentgemma-9b's attention in
    # float32 (its head-tiled pair): launched by (b)'s float32 step
    w = train["times"]["flash_attention_bwd (window, float32)"]
    kernels.append({
        "name": "flash_attention_bwd (window, float32)", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:28",
        "launches": parity_runs["recurrentgemma-9b"]["launches_f32"][
            "flash_attention_bwd"],
        "max_abs_err": train["max_abs_err"][
            "flash_attention_bwd (window, float32)"],
        "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": w["library_ms"],
        "stands_for": "jax.value_and_grad of the jnp function (no Pallas "
                      "backward)", "shape": w["shape"], "dtype": "float32",
        "kernels_ms": w["parts"], "arch": "recurrentgemma-9b"})
    # the scalar forwards in float32: at that shape (whole rows) and
    # head-tiled at the wide timing shapes
    fwd = {k: {f: train["times"][k][f] for f in (
        "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for k in ("flash_attention (window, float32)",
                  "flash_attention (wide)", "ssd_scan (wide)")}
    fwd["flash_attention (wide)"]["max_abs_err"] = lm_err[
        "flash_attention (wide)"]
    fwd["ssd_scan (wide)"]["max_abs_err"] = lm_err["ssd_scan (wide)"]
    flash["scalar"] = {"window_float32": fwd[
        "flash_attention (window, float32)"],
        "wide": fwd["flash_attention (wide)"]}
    next(k for k in kernels if k["name"] == "ssd_scan")["wide"] = fwd[
        "ssd_scan (wide)"]
    log("[report] training (bf16, f32 weights; card: " + card + "): "
        + "; ".join(
            f"{r['arch']} at {r['layers']} of {r['of_layers']} layers, "
            f"{r['batch']} x {r['seq']} tokens, {r['microbatches']} "
            f"microbatches: {r['step_s']:.4f} s a step, "
            f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gb']:.2f} GB"
            for r in train["timed"])
        + f"; quickstart {train['quickstart']['wall_s']:.2f} s")
    per_step = {a: r["launches"]["flash_attention_bwd_sm90"]
                // TRAIN_TIMED_STEPS for a, r in timed_runs.items()}
    log("[report] the flash backward (tensor-core route) at each family's "
        "training shape (card: " + card + "): " + "; ".join(
            f"{fam} ({arch}) {w['shape']}: {w['ms']:.4f} ms a launch "
            f"({per_step[arch]} launches a step of {arch}, all its shapes), "
            f"bound {w['bound_ms']:.4f} ms by {w['bound_by']}, SDPA's "
            f"backward {w['library_ms']:.4f} ms"
            for fam, (arch, w) in _family_bwd_times(train).items()))
    rs = train["restarts"]
    log(f"[report] launch/train.py twin: exit {rs['launch_rc']}, losses "
        f"{rs['launch_losses']}; run_with_restarts {rs['restarts']}: "
        f"{rs['params']} parameters bit-equal to the run without failures")
    log("[report] LM serving (bf16): " + "; ".join(
        f"{a} ({r['batch']} x {r['text'] + r['frontend']}) prefill "
        f"{r['prefill_tokens_per_s']:.1f} tokens/s (first "
        f"{r['prefill_first_s']:.3f} s, then {r['prefill_s']:.3f}), decode "
        f"{r['decode_ms_per_step']:.3f} ms/step, ServeEngine "
        f"{r['serve_wall_s']:.3f} s, peak {r['peak_gb']:.2f} GB"
        for a, r in lm.items()))
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
    par_run = launch["parallel"]
    meshes = launch["meshes"]
    log(f"[report] launch (card: {card}): the one-card dry-run "
        f"{launch['rows']} rows ({launch['ok']} OK); the production meshes "
        + ", ".join(f"{m} {len(v['rows'])} OK rows collected at "
                    f"{v['done_s']:.1f} s" for m, v in meshes.items())
        + "; (e) each rank's wall "
        + str([round(r["pim"]["wall_s"], 3) for r in launch["ranks"]["ranks"]])
        + f" s; at "
        f"{LAUNCH_CUT['n_layers']} layers, {LAUNCH_BATCH} x {LAUNCH_SEQ} "
        "tokens: " + "; ".join(
            f"{arch} {c['wall_s']:.4f} s on the card, its row's bound "
            f"{c['bound_s']:.4f} s ({c['wall_s'] / c['bound_s']:.3f}x), "
            f"max_memory_allocated {c['max_memory_allocated'] / 2**30:.3f} "
            f"GiB, counted args + out + temp "
            f"{c['args_out_temp'] / 2**30:.3f} GiB"
            for arch, c in launch["cells"].items())
        + f"; compressed DP steps {par_run['dp_step_loss_rel']:.3e} "
        f"relative; phase {launch['seconds']:.1f} s")
    log(f"[report] phase walls (s): {json.dumps(walls)}")
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
    ep = scripts_run["engine_perf"]
    log(f"[report] scripts: {len(scripts_run['runs'])} twin runs equal to "
        f"goldens.json in {scripts_run['seconds']:.1f} s; torch_engine_perf "
        f"cold {ep['cold_s']} s, warm {ep['warm_s']} s ({ep['speedup']}x), "
        "steady state " + ", ".join(
            f"{r['workload']}@{r['dpus']}"
            + ("" if r.get("event_skip", True) else " (no event skip)")
            + f" {r['run_s']} s, {r['kips']} KIPS, {r['steps_per_s']:.1f} "
            f"steps/s, set-up {r['outside_share']:.3f}"
            for r in ep["steady_state"]))
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
