#!/usr/bin/env python3
"""Where the tensor-core flash-attention kernel's time goes on the card.

Builds ``csrc/flash_attention_sm90.cu`` once as the library builds it and
once for each ablation, with one ``-DFLASH_SM90_SKIP_*`` switch or more
(the source's header lists them; each leaves one part of the kernel out,
so its outputs are wrong on purpose), all nvcc runs at once.  Then, at
llama3-8b's prefill shape (chip_smoke.py's FLASH_MAIN) and its
non-causal twin, times every build between CUDA events, in turns (all
builds, then all again in reverse order), with
``scaled_dot_product_attention`` beside them.  Prints the card, one JSON
line per shape, the nvcc warnings of each build (a ``C75xx`` warning
means ptxas serialised the wgmma pipeline) and, for the library's own
build, each kernel instance's registers and spilled bytes (``-Xptxas
-v``).

    python3 tools/flash_sm90_ablation.py

Needs a CUDA card and nvcc; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "src/repro_torch/kernels/flash_attention/csrc"
       / "flash_attention_sm90.cu")

#: build name -> the parts it leaves out
ABLATIONS = {
    "full": (),
    "no_pingpong": ("PINGPONG",),
    "no_store": ("STORE",),
    "no_softmax": ("SOFTMAX",),
    "products_and_loads": ("SOFTMAX", "STORE"),
    "loads_only": ("SOFTMAX", "STORE", "QK", "PV"),
}
#: (B, S, H, KV, D, causal): FLASH_MAIN and its non-causal twin
SHAPES = ((4, 1024, 32, 8, 128, True), (4, 1024, 32, 8, 128, False))


def build(name: str, parts) -> tuple:
    from repro_torch.kernels import build as kb
    out = kb.build_dir() / "ablation" / f"libflash_sm90_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-Xptxas", "-v",
           *[f"-DFLASH_SM90_SKIP_{p}" for p in parts], "-o", str(out),
           str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    warnings = sorted(set(re.findall(r"\((C\d+)\)", proc.stderr)))
    fn = ctypes.CDLL(str(out)).flash_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, warnings, instances(proc.stderr)


def instances(ptxas: str) -> dict:
    """'Dk/Dv' -> [registers at entry, spill-store bytes] of each kernel
    instance, from ``-Xptxas -v``'s report."""
    res, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function .*kernelILi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = res.setdefault(f"{m[1]}/{m[2]}", [None, None])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None:
            cur[1] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[0] = int(m[1])
    return res


def event_ms(fn, n: int = 50, warm: int = 5) -> float:
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


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_sm90_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        built = dict(zip(ABLATIONS, pool.map(lambda kv: build(*kv),
                                             ABLATIONS.items())))
    gen = torch.Generator(device="cuda").manual_seed(6)
    print(json.dumps({"card": card, "nvcc_warnings": {
        name: w for name, (_, w, _) in built.items()},
        "registers_spill_bytes": built["full"][2]}), flush=True)
    for b, s, h, kv, d, causal in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, s, h, kv, d, d, int(causal), 0, d ** -0.5, None,
                     stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        ms = {name: [] for name in built}
        for order in (list(built), list(reversed(built))):
            for name in order:
                ms[name].append(event_ms(lambda: call(built[name][0])))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        print(json.dumps({"shape": dict(B=b, S=s, H=h, KV=kv, D=d,
                                        causal=causal),
                          "ms": ms, "sdpa_ms": sdpa}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
