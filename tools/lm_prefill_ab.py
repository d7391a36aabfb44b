#!/usr/bin/env python3
"""llama3-8b's prefill and decode times on the card, this checkout against
another, and with or without the [lm] checks that chip_smoke.py runs
before its [lm] main path.

Each run is a process of its own.  It puts a checkout's ``src`` and root
first on ``sys.path``, optionally runs that checkout's
``chip_smoke.phase_lm_kernels`` and ``phase_lm_parity`` (``before``),
then builds llama3-8b at full width and depth in bf16 with random
weights from seed 3 (as chip_smoke.py's [lm] main path does) and times,
on the host clock around work that ends in a synchronize: the first
prefill of 4 x 1,024 tokens (what the main path reports), ``--repeats``
more, one after ``torch.cuda.empty_cache()``, and 32 greedy decode
steps past the prefill.  Prints one JSON line per run, with the card's
SM clock, temperature and power draw read before the model is built.

    python3 tools/lm_prefill_ab.py --other DIR   # DIR: another checkout

runs, in this order: other, this, this + before, this, other, other +
before.  Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPT, BATCH, DECODE_STEPS = 1024, 4, 32
#: (checkout: "this" or "other", run the [lm] checks before?)
ORDER = (("other", False), ("this", False), ("this", True),
         ("this", False), ("other", False), ("other", True))


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def one(root: Path, before: bool, repeats: int) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    res = {"root": str(root), "before": before}
    if before:
        import chip_smoke
        t = _timed(chip_smoke.phase_lm_kernels)
        t += _timed(chip_smoke.phase_lm_parity)
        res["before_s"] = t
    res["reserved_gb_before"] = torch.cuda.memory_reserved() / 1e9
    res["card"] = _smi("name,power.limit,clocks.sm,temperature.gpu,"
                       "power.draw")
    cfg = get_config("llama3-8b")
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4), device="cuda")
    prefill = lambda: model.prefill({"tokens": tokens})     # noqa: E731
    res["prefill_first_s"] = _timed(prefill)
    res["prefill_warm_s"] = [_timed(prefill) for _ in range(repeats)]
    torch.cuda.empty_cache()
    res["prefill_after_empty_cache_s"] = _timed(prefill)
    logits, cache = model.prefill({"tokens": tokens})
    cache = {k: F.pad(v, (0, 0, 0, 0, 0, DECODE_STEPS))
             if torch.is_tensor(v) else v for k, v in cache.items()}

    def decode():
        nonlocal logits, cache
        for _ in range(DECODE_STEPS):
            logits, cache = model.decode_step(cache, logits.argmax(-1))

    res["decode_ms_per_step"] = _timed(decode) / DECODE_STEPS * 1e3
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other checkout's root")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--before", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one.resolve(), args.before,
                             args.repeats)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("lm_prefill_ab: needs a CUDA card", file=sys.stderr)
        return 1
    roots = {"this": ROOT, "other": args.other.resolve()}
    rc = 0
    for which, before in ORDER:
        cmd = [sys.executable, __file__, "--one", str(roots[which]),
               "--repeats", str(args.repeats)] + (["--before"] * before)
        out = subprocess.run(cmd, capture_output=True, text=True,
                             env=os.environ.copy())
        line = (out.stdout.strip().splitlines() or [""])[-1]
        if out.returncode != 0 or not line.startswith("{"):
            print(f"lm_prefill_ab: {which} (before={before}) failed:\n"
                  f"{out.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(json.dumps({"checkout": which, **json.loads(line)}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
