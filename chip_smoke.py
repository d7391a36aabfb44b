#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--scale S]

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every CUDA kernel of the main path (sm_90a) from
             the sources in the checkout, into build/repro_torch/;
2. kernels — each kernel against its plain-torch version on the card,
             bitwise (tolerance 0), on edge cases and random int32;
3. golden  — VA on 4 DPUs (2 ranks, 2 channels), 8 tasklets, scale 0.02,
             seed 0 must give the JAX package's pre-refactor golden
             (tests/test_backend.py) exactly;
4. full    — one UPMEM rank of 64 DPUs, 16 tasklets, 2 MiB MRAM each
             (benchmarks/pim_figs.py simulation-rate study): (a) at scale
             0.02 the card and the CPU give identical KernelReport and
             Timeline; (b) VA at --scale (the main path) passes its numpy
             oracle, with every ALU call counted as a kernel launch;
5. report  — the kernels line (launches, times, bound), the card's name
             and power limit, and the result line.

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

#: NVIDIA H100 SXM data sheet: HBM3 rate, and the 32-bit non-tensor rate
#: (67 TFLOP/s float32; the guide's table lists no separate int32 rate)
HBM_BYTES_PER_S = 3.35e12
SCALAR32_OPS_PER_S = 67e12

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


def phase_build() -> float:
    from repro_torch.kernels import build
    from repro_torch.kernels.alu_exec.alu_exec import library
    t0 = time.perf_counter()
    library()
    secs = time.perf_counter() - t0
    log(f"[build] alu_exec: nvcc {build.BUILD_SECONDS['alu_exec']:.2f} s, "
        f"build+load {secs:.2f} s -> {build.build_dir()}")
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
    the kernel launch counts taken from this run alone."""
    import torch
    from repro_torch.core import compile_cache
    from repro_torch.kernels.alu_exec import ops
    cfg = _full_cfg()
    system = _system(cfg, "cuda")
    steps0 = compile_cache.stats()["steps"]
    ops.launches = 0                       # counts of the main path only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rep = _va(system, 16, scale)        # raises on an oracle mismatch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches
    steps = compile_cache.stats()["steps"] - steps0
    check(launches > 0, "alu_exec was never launched on the main path")
    check(launches == steps * cfg.superscalar,
          f"alu_exec launches {launches} != steps {steps} x superscalar "
          f"{cfg.superscalar}")
    res = {"scale": scale, "cycles": rep.cycles, "issued": rep.issued,
           "steps": steps, "launches": launches, "wall_s": wall,
           "kips": rep.issued / wall / 1e3,
           "cycles_per_s": rep.cycles / wall,
           "steps_per_s": steps / wall}
    log(f"[main] VA 64 DPUs x 16 tasklets scale {scale}: oracle ok; "
        f"{json.dumps(res)}")
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
        phase_golden()
        full = phase_full_parity()
        main_run = phase_main_path(args.scale)
        from repro_torch.core.compile_cache import dpu_bucket
        times = phase_kernel_times(dpu_bucket(_full_cfg().n_dpus))
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": "alu_exec", "route": "cuda",
        "source": "src/repro_torch/kernels/alu_exec/csrc/alu_exec.cu",
        "replaces": "src/repro/kernels/alu_exec/alu_exec.py:50",
        "launches": main_run["launches"], "max_abs_err": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None,
    }]
    log(f"[report] full-width cold launch {full['cold_s']:.3f} s, warm "
        f"{full['warm_s']:.3f} s; main path {main_run['kips']:.3f} KIPS, "
        f"{main_run['cycles_per_s']:.1f} simulated cycles/s; "
        f"smoke {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
