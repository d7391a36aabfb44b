#!/usr/bin/env python3
"""Where the LM serving path's time goes on the card (PyTorch/CUDA port).

Builds llama3-8b and mamba2-130m at full width and depth in bf16 with
seeded random weights (as chip_smoke.py), and for each times a prefill
of 4 prompts (1024 tokens for llama3-8b, 2048 for mamba2-130m) and a
window of 8 greedy decode steps past it: once bare (host clock around
work that ends in a synchronize), once under ``torch.profiler`` tracing
the device only.  From the trace it takes the union of the device's
kernel and copy intervals over the span from its first to its last
device event (busy share; the rest is idle) and the 8 kernels that take
the most device time.  Prints one JSON line per phase.

    python3 tools/torch_lm_profile.py

Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (arch, prompt tokens) of chip_smoke.py's LM main path, 4 prompts each
PATHS = (("llama3-8b", 1024), ("mamba2-130m", 2048))
DECODE_STEPS = 8
TOP = 8


def profile_phase(fn) -> dict:
    """Bare wall ms of ``fn()``, then its device trace's busy share and
    top kernels (``fn`` runs to a synchronize in both)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch_step_profile import busy_us
    fn()                                    # warm: allocator, libraries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        raise RuntimeError("the trace holds no device event")
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    busy = busy_us(spans, lo, hi) / 1e3

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    kernels = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                     key=dev_us, reverse=True)
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_ms,
            "device_window_ms": (hi - lo) / 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / ((hi - lo) / 1e3),
            "device_events": len(spans),
            "top_kernels_ms": {e.key[:70]: [dev_us(e) / 1e3, e.count]
                               for e in kernels[:TOP]}}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_lm_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    for arch, prompt in PATHS:
        cfg = get_config(arch)
        model = Transformer(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(3))
        toks = torch.randint(0, cfg.vocab_size, (4, prompt), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(4))
        prefill = profile_phase(lambda: model.prefill({"tokens": toks}))
        _, cache = model.prefill({"tokens": toks})
        if cfg.family == "dense":  # room for the decoded tokens
            cache = {k: F.pad(v, (0, 0, 0, 0, 0, DECODE_STEPS))
                     if torch.is_tensor(v) else v for k, v in cache.items()}
        nxt = toks[:, -1]

        def decode():
            c = dict(cache)
            for _ in range(DECODE_STEPS):
                logits, c = model.decode_step(c, nxt)
            return logits

        step = profile_phase(decode)
        for name in ("wall_ms", "profiled_wall_ms", "device_window_ms",
                     "device_busy_ms"):
            step[name] /= DECODE_STEPS
        step["device_events"] /= DECODE_STEPS
        step["top_kernels_ms"] = {k: [ms / DECODE_STEPS,
                                      n / DECODE_STEPS]
                                  for k, (ms, n) in
                                  step["top_kernels_ms"].items()}
        for phase, res in (("prefill 4 x %d" % prompt, prefill),
                           ("decode step (per step, batch 4)", step)):
            print(json.dumps({"arch": arch, "phase": phase,
                              "card": torch.cuda.get_device_name(0), **res}))
        del model, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
