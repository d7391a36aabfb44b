#!/usr/bin/env python3
"""The two backward routes of flash attention and of the SSD scan on the
card: checked, then timed route by route and kernel by kernel.

1. Builds the four backward libraries at once (one nvcc each) and prints
   the ptxas registers and spills of the tensor-core ones.
2. ``--check``: each tensor-core backward (``FlashAttention`` /
   ``SsdScan`` on the ``"sm90"`` / ``"tc"`` route, one counted backward
   pass) against autograd of its plain version at a few shapes (bf16,
   |err| / max |plain| within 2e-2), and two runs bitwise equal.
3. Times, at the training shapes of ``chip_smoke.py`` (FLASH_TRAIN:
   llama3-8b's B 1, S 4,096, H 32, KV 8, D 128, causal; the same at
   recurrentgemma-9b's B 1, H 16, KV 1, D 256, window 2,048; SSD_TRAIN:
   mamba2-130m's B 4, S 4,096, H 24, P 64, N 128, chunk 256; bf16), each
   route whole and each of its kernels alone (the launchers' ``parts``
   mask, the scratch of a whole run kept), between CUDA events over
   back-to-back launches, in turns (scalar, tensor-core, tensor-core,
   scalar); flash beside SDPA's backward (autograd of
   ``scaled_dot_product_attention``, not used by the port).

Prints the card, then one JSON line per measurement (also written to
``chiprun_out/bwd_tc_profile.json``).

    python3 tools/bwd_tc_profile.py [--check] [--skip-scalar]

Needs a CUDA card and nvcc; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FLASH_TRAIN = dict(b=1, s=4096, h=32, kv=8, dk=128, dv=128, causal=True,
                   window=0)
FLASH_WINDOW = dict(b=1, s=4096, h=16, kv=1, dk=256, dv=256, causal=True,
                    window=2048)
SSD_TRAIN = dict(b=4, s=4096, h=24, g=1, p=64, n=128, chunk=256)
#: --check's shapes: (B, S, H, KV, Dk, Dv, causal, window) and
#: (B, S, H, G, P, N, chunk)
FLASH_CHECK = [(2, 1000, 4, 2, 128, 128, True, 0),
               (2, 256, 4, 2, 192, 128, True, 0),
               (2, 256, 4, 2, 256, 256, True, 0),
               (2, 1024, 4, 2, 128, 128, True, 300),
               (2, 512, 4, 2, 128, 128, False, 0),
               (2, 512, 16, 2, 128, 128, True, 0),
               (2, 128, 4, 4, 64, 64, True, 0),
               (1, 300, 4, 1, 64, 128, True, 100)]
SSD_CHECK = [(2, 300, 4, 1, 64, 64, 128), (2, 1000, 6, 3, 64, 128, 256),
             (1, 512, 4, 2, 128, 128, 256), (1, 256, 4, 2, 16, 16, 64),
             (1, 100, 2, 1, 64, 128, 256), (2, 200, 4, 2, 128, 16, 64),
             (1, 1024, 4, 1, 64, 128, 256)]
TOL = 2e-2
OUT = ROOT / "chiprun_out" / "bwd_tc_profile.json"


def emit(rows: list, **row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def event_ms(fn, n: int, warm: int = 2) -> float:
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


def in_turns(fns: dict, n: int) -> dict:
    """Mean ms of each named call, timed a, b, b, a (two passes each)."""
    names = list(fns)
    order = names + names[::-1]
    got = {k: [] for k in names}
    for k in order:
        got[k].append(event_ms(fns[k], n))
    return {k: sum(v) / len(v) for k, v in got.items()}


def build(rows: list):
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    libs = {"flash_attention_sm90": fa.library_sm90,
            "flash_attention_bwd": fa.library_bwd,
            "flash_attention_bwd_sm90": fa.library_bwd_sm90,
            "ssd_scan_tc": ss.library_tc, "ssd_scan_bwd": ss.library_bwd,
            "ssd_scan_bwd_tc": ss.library_bwd_tc}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futs = {k: pool.submit(f) for k, f in libs.items()}
        built, failed = {}, {}
        for k, f in futs.items():
            try:
                built[k] = f.result()
            except RuntimeError as e:
                failed[k] = str(e)[-6000:]
    emit(rows, phase="build", seconds=round(time.perf_counter() - t0, 2),
         built=sorted(built), failed=sorted(failed))
    for k, msg in failed.items():
        print(f"--- {k} ---\n{msg}", flush=True)
    for k in ("flash_attention_bwd_sm90", "ssd_scan_bwd_tc"):
        if k not in built:
            continue
        log = kb.build_log(built[k])
        for part in log.split("Compiling entry function '")[1:]:
            regs = re.search(r"Used (\d+) registers", part)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", part)
            emit(rows, phase="ptxas", lib=k, kernel=part.split("'", 1)[0],
                 registers=int(regs.group(1)) if regs else None,
                 spill_stores=int(sp.group(1)) if sp else None,
                 spill_loads=int(sp.group(2)) if sp else None)
        warn = [ln for ln in log.splitlines() if "C75" in ln
                or "serialized" in ln]
        if warn:
            emit(rows, phase="ptxas", lib=k, warnings=warn[:20])
    if failed:
        raise SystemExit(1)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def normal(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def flash_inputs(gen, b, s, h, kv, dk, dv, dtype, **_):
    return [normal(gen, (b, s, n, d), dtype)
            for n, d in ((h, dk), (kv, dk), (kv, dv))]


def ssd_inputs(gen, b, s, h, g, p, n, dtype, **_):
    import torch
    x = normal(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device="cuda") - 1.0) * 0.25
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    Bm = normal(gen, (b, s, g, n), dtype)
    Cm = normal(gen, (b, s, g, n), dtype)
    return [x, dt.float(), A.float(), Bm, Cm]


def check(rows: list, gen):
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    bf16, bad = torch.bfloat16, []
    for b, s, h, kv, dk, dv, causal, window in FLASH_CHECK:
        q, k, v = (t.requires_grad_() for t in flash_inputs(
            gen, b, s, h, kv, dk, dv, bf16))
        out = fops.flash_attention(q, k, v, causal=causal, window=window)
        do = normal(gen, out.shape, bf16)
        before = fops.launches_bwd_sm90
        got = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
        again = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = (max(errs) <= TOL and same
              and fops.launches_bwd_sm90 - before == 2)
        bad += [] if ok else [("flash", s, h, kv, dk, dv, causal, window)]
        emit(rows, phase="check", kernel="flash_attention_bwd_sm90",
             shape=[b, s, h, kv, dk, dv, causal, window], errs=errs,
             deterministic=same, ok=ok)
    for b, s, h, g, p, n, chunk in SSD_CHECK:
        ins = [t.requires_grad_() for t in ssd_inputs(gen, b, s, h, g, p, n,
                                                      bf16)]
        for with_state in (True, False):
            y, state = sops.ssd_scan(*ins, chunk=chunk)
            dy = normal(gen, y.shape, bf16)
            dst = normal(gen, state.shape, torch.float32)
            outs, grads = ((y, state), (dy, dst)) if with_state else (
                (y,), (dy,))
            before = sops.launches_bwd_tc
            got = torch.autograd.grad(outs, ins, grads, retain_graph=True)
            again = torch.autograd.grad(outs, ins, grads)
            torch.cuda.synchronize()
            want = ssd_scan_bwd_ref(*ins, dy, dst if with_state else None,
                                    chunk=chunk)
            errs = [rel_err(gr, w) for gr, w in zip(got, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = (max(errs) <= TOL and same
                  and sops.launches_bwd_tc - before == 2)
            bad += [] if ok else [("ssd", b, s, h, g, p, n, chunk,
                                   with_state)]
            emit(rows, phase="check", kernel="ssd_scan_bwd_tc",
                 shape=[b, s, h, g, p, n, chunk], final_state=with_state,
                 errs=errs, deterministic=same, ok=ok)
    return bad


def time_flash(rows: list, gen, shape: dict, scalar: bool):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    bf16 = torch.bfloat16
    q, k, v = flash_inputs(gen, dtype=bf16, **shape)
    b, s, h = shape["b"], shape["s"], shape["h"]
    causal, window = shape["causal"], shape["window"]
    out = torch.empty((b, s, h, shape["dv"]), dtype=bf16, device="cuda")
    lse = torch.empty((b, h, s), device="cuda")
    fa.flash_attention_sm90_cuda(q, k, v, out, causal, window, lse)
    do = normal(gen, out.shape, bf16)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    args = (q, k, v, out, do, lse, *grads, causal, window)
    routes = {"sm90": fa.flash_attention_bwd_sm90_cuda}
    if scalar and max(shape["dk"], shape["dv"]) <= 192:
        routes["scalar"] = fa.flash_attention_bwd_cuda
    scratch = {r: f(*args) for r, f in routes.items()}
    n = 20
    whole = in_turns({r: (lambda f=f: f(*args)) for r, f in routes.items()},
                     n if "scalar" not in routes else 3)
    for r, f in routes.items():
        parts = {p: event_ms(lambda: f(*args, parts=p, scratch=scratch[r]),
                             n if r == "sm90" else 3) for p in (1, 2)}
        emit(rows, phase="time", kernel=f"flash_attention_bwd ({r})",
             shape=shape, ms=whole[r], dq_ms=parts[1], dkdv_ms=parts[2])
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = None
    if window > 0:
        i = torch.arange(s, device="cuda")
        mask = ((i[None, :] <= i[:, None])
                & (i[:, None] - i[None, :] < window))
    ot = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    dot = do.transpose(1, 2)
    emit(rows, phase="time", kernel="sdpa_backward", shape=shape,
         ms=event_ms(lambda: torch.autograd.grad(
             ot, (qt, kt, vt), dot, retain_graph=True), n))


def time_ssd(rows: list, gen, scalar: bool):
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    sh = SSD_TRAIN
    bf16 = torch.bfloat16
    args = ssd_inputs(gen, dtype=bf16, **sh)
    y = torch.empty_like(args[0])
    state = torch.empty((sh["b"], sh["h"], sh["n"], sh["p"]), device="cuda")
    states = ss.ssd_scan_tc_cuda(*args, y, state, sh["chunk"])
    dy = normal(gen, y.shape, bf16)
    full = (*args, dy, states, None, sh["chunk"])
    nc = -(-sh["s"] // sh["chunk"])
    sc = torch.empty((sh["b"], sh["h"], nc, sh["n"], sh["p"]), device="cuda")
    st = ss.scratch_bwd_tc(args[0], args[3], sh["chunk"])
    routes = {"tc": (ss.ssd_scan_bwd_tc_cuda, st,
                     {"ssd_chunk_cb": 1, "ssd_bwd_chunk_state": 2,
                      "ssd_bwd_state_pass": 4, "ssd_bwd_keys": 8,
                      "ssd_bwd_queries": 16, "ssd_bwd_finish": 32})}
    if scalar:
        routes["scalar"] = (ss.ssd_scan_bwd_cuda, sc,
                            {"ssd_bwd_state_pass": 1, "ssd_bwd_chunk": 2})
    for f, scr, _ in routes.values():
        f(*full, scratch=scr)
    whole = in_turns({r: (lambda f=f, scr=scr: f(*full, scratch=scr))
                      for r, (f, scr, _) in routes.items()}, 10)
    for r, (f, scr, parts) in routes.items():
        emit(rows, phase="time", kernel=f"ssd_scan_bwd ({r})", shape=sh,
             ms=whole[r], parts={
                 name: event_ms(lambda: f(*full, parts=p, scratch=scr), 10)
                 for name, p in parts.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--skip-scalar", action="store_true",
                    help="time the tensor-core routes alone")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bwd_tc_profile: needs a CUDA card", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; {card}", flush=True)
    rows = []
    try:
        build(rows)
        gen = torch.Generator(device="cuda").manual_seed(0)
        bad = check(rows, gen) if args.check else []
        time_flash(rows, gen, FLASH_TRAIN, not args.skip_scalar)
        time_flash(rows, gen, FLASH_WINDOW, False)
        time_ssd(rows, gen, not args.skip_scalar)
    finally:
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    if bad:
        print(f"bwd_tc_profile: FAIL {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
