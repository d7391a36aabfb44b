#!/usr/bin/env python3
"""Where the tensor-core SSD route's time goes on the card.

At mamba2-130m's prefill shape (chip_smoke.py's SSD_MAIN: B 4, S 2048,
H 24, P 64, N 128, G 1, chunk 256, bf16) it

* times the route (``ssd_scan_tc_cuda``) and the scalar kernel
  (``ssd_scan_cuda``) between CUDA events, in turns (scalar, route,
  route, scalar);
* splits the route's device time into its four kernels
  (``torch.profiler``, 10 calls);
* builds ``csrc/ssd_scan_tc.cu`` a second time with ``-DSSD_TC_TIMING``
  (each CTA of ``ssd_chunk_state`` and ``ssd_chunk_scan`` records its SM
  and the ``%globaltimer`` at the ends of its phases) and reports, per
  kernel, the span, each phase's mean and 90th percentile over the
  CTAs, and how many CTAs an SM held at once; for ``ssd_chunk_scan``
  also the mean CTA time by query tile.

Phases: ``ssd_chunk_state`` 1 = dt, seg and wk, 2 = the loads and
products of the chunk's state; ``ssd_chunk_scan`` 1 = loading C and the
incoming state, 2 = the inter-chunk product, 3 = the key tiles, 4 = the
store of y.  Prints the card, then one JSON line per measurement.

    python3 tools/ssd_tc_profile.py

Needs a CUDA card and nvcc; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu"

#: chip_smoke.py's SSD_MAIN
B, S, H, G, P, N, CHUNK = 4, 2048, 24, 1, 64, 128, 256
#: the timing build's table (csrc: kTimingRows x 8, state CTAs from
#: kTimingState)
TIMING_ROWS, TIMING_STATE = 1 << 16, 1 << 15


def build_timing() -> ctypes.CDLL:
    from repro_torch.kernels import build as kb
    out = kb.build_dir() / "ablation" / "libssd_scan_tc_timing.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-DSSD_TC_TIMING", "-o",
           str(out), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the timing build:\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.ssd_scan_tc_launch.argtypes = ([ctypes.c_void_p] * 11
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.ssd_scan_tc_launch.restype = ctypes.c_int
    lib.ssd_scan_tc_timing_copy.argtypes = [ctypes.c_void_p]
    lib.ssd_scan_tc_timing_copy.restype = ctypes.c_int
    return lib


def events_ms(fn, n: int, warm: int = 3) -> float:
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


def phases(rows, marks: int) -> dict:
    """Span, CTA time, per-phase mean / p90 (µs) and CTAs an SM held at
    once, from the timing table's rows of one kernel."""
    import numpy as np
    t = rows[:, :marks].astype(np.int64)
    sm = rows[:, 7].astype(np.int64)
    out = {"ctas": len(rows),
           "span_us": float((t[:, -1].max() - t[:, 0].min()) / 1e3),
           "cta_us_mean": float((t[:, -1] - t[:, 0]).mean() / 1e3)}
    for k in range(1, marks):
        d = (t[:, k] - t[:, k - 1]) / 1e3
        out[f"phase{k}_us"] = [float(d.mean()),
                               float(np.percentile(d, 90))]
    held = []
    for s in np.unique(sm):
        ev = sorted([(a, 1) for a in t[sm == s, 0]]
                    + [(e, -1) for e in t[sm == s, -1]])
        cur = top = 0
        for _, step in ev:
            cur += step
            top = max(top, cur)
        held.append(top)
    out["ctas_per_sm"] = [float(np.mean(held)), int(max(held))]
    out["sms"] = len(held)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import ssd_scan
    if not torch.cuda.is_available():
        print("ssd_tc_profile: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(2) as pool:
        timing = pool.submit(build_timing)
        pool.submit(ssd_scan.library_tc).result()
        pool.submit(ssd_scan.library).result()
        timing = timing.result()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bf16 = torch.bfloat16
    x = normal((B, S, H, P), bf16)
    dt = torch.nn.functional.softplus(normal((B, S, H)))
    A = -torch.exp(normal((H,)))
    Bm, Cm = normal((B, S, G, N), bf16), normal((B, S, G, N), bf16)
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device="cuda")
    args = (x, dt, A, Bm, Cm, y, state, CHUNK)

    runs = {"scalar": [], "tc": []}
    for name in ("scalar", "tc", "tc", "scalar"):
        fn = ssd_scan.ssd_scan_tc_cuda if name == "tc" \
            else ssd_scan.ssd_scan_cuda
        runs[name].append(events_ms(lambda: fn(*args),
                                    n=100 if name == "tc" else 10))
    print(json.dumps({"ms": runs}), flush=True)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssd_scan.ssd_scan_tc_cuda(*args)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        us = float(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)))
        if us > 0 and "ssd_" in e.key:
            name = e.key.split("ssd_", 1)[1].split("(", 1)[0].split("<")[0]
            kernels[f"ssd_{name}"] = us / e.count
    print(json.dumps({"kernel_us": kernels}), flush=True)

    nc = S // CHUNK
    scratch = (torch.empty((B, H, nc, N, P), device="cuda"),
               torch.empty((B, H, nc, 2, N, P), dtype=bf16, device="cuda"),
               torch.empty((B, H, nc, 2, CHUNK), device="cuda"),
               torch.empty((B, G, nc, CHUNK, CHUNK), device="cuda"))
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, y, state, *scratch)]
    for _ in range(4):      # the last launch's marks are read
        err = timing.ssd_scan_tc_launch(
            *ptrs, B, S, H, G, N, P, CHUNK,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"timing build launch failed: {err}")
    torch.cuda.synchronize()
    table = np.zeros((TIMING_ROWS, 8), np.uint64)
    if timing.ssd_scan_tc_timing_copy(ctypes.c_void_p(table.ctypes.data)):
        raise RuntimeError("cannot read the timing table")
    qtiles = CHUNK // 64
    scan = table[:nc * qtiles * H * B]  # CTAs in launch order, x fastest
    scan_res = phases(scan, 5)
    qt = np.arange(len(scan)) % qtiles
    cta = (scan[:, 4].astype(np.int64) - scan[:, 0].astype(np.int64)) / 1e3
    scan_res["cta_us_by_query_tile"] = [float(cta[qt == k].mean())
                                        for k in range(qtiles)]
    print(json.dumps({"ssd_chunk_scan": scan_res}), flush=True)
    state_res = phases(table[TIMING_STATE:TIMING_STATE + nc * H * B], 3)
    print(json.dumps({"ssd_chunk_state": state_res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
