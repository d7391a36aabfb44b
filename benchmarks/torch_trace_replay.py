"""Trace-replay smoke on the PyTorch/CUDA port: bit-exactness + the
>=10x replay speedup gate (benchmarks/trace_replay.py's smoke and gate on
``repro_torch``; the live run simulates on the CUDA card, through the
``cycle_step`` kernel, unless ``--device cpu`` asks for the CPU).

:func:`smoke` records one live BFS run, replays it under the unchanged
config, asserts the replayed ``Timeline`` is bit-exact vs. the live one,
and times both (one run beforehand, so the live side measures
steady-state simulation, not the kernels' build).  :func:`check` is the CI
gate: replay must be at least ``MIN_SPEEDUP``x faster than live
simulation, and the HBM-PIM native MAC path must pass its numpy oracle
(GEMVS on ``backend="hbmpim"`` raises on any mismatch).

    python benchmarks/torch_trace_replay.py [--check] [--device cpu]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import trace  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.workloads import get  # noqa: E402

MIN_SPEEDUP = 10.0


def smoke(scale: float = 0.05, n_threads: int = 8, device=None):
    cfg = DPUConfig(n_dpus=8, n_ranks=2, n_channels=2)
    get("BFS").run(PIMSystem(cfg, device=device), n_threads, scale=scale,
                   seed=0)  # warm

    t0 = time.perf_counter()
    system = PIMSystem(cfg, device=device)
    rec = trace.record(system)
    get("BFS").run(system, n_threads, scale=scale, seed=0)
    system.sync()
    t_live = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = trace.replay(rec.records)
    t_replay = time.perf_counter() - t0

    live, rep = system.timeline, res.timeline
    exact = (live.events == rep.events and live.total == rep.total
             and live.elapsed == rep.elapsed)
    if not exact:
        raise AssertionError(
            f"replay not bit-exact: live total={live.total!r} "
            f"elapsed={live.elapsed!r} vs replay total={rep.total!r} "
            f"elapsed={rep.elapsed!r}")
    return {
        "n_commands": res.n_commands,
        "t_live_s": t_live,
        "t_replay_s": t_replay,
        "speedup": round(t_live / max(t_replay, 1e-9), 1),
        "bit_exact": True,
    }


def check(scale: float = 0.05, device=None):
    """CI gate: replay speedup floor + HBM-PIM numerics oracle."""
    row = smoke(scale, device=device)
    if row["speedup"] < MIN_SPEEDUP:
        raise AssertionError(
            f"trace replay only {row['speedup']}x faster than live "
            f"simulation (gate: >= {MIN_SPEEDUP}x)")
    cfg = DPUConfig(n_dpus=4, n_ranks=2, n_channels=2, backend="hbmpim")
    get("GEMVS").run(PIMSystem(cfg, device=device), 8, scale=scale,
                     seed=0)  # oracle inside
    row["hbmpim_oracle"] = "ok"
    return row


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--check", action="store_true",
                    help="fail unless replay beats live simulation by "
                         f">= {MIN_SPEEDUP}x and the HBM-PIM oracle passes")
    ap.add_argument("--device", default=None,
                    help="torch device of the live run (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args()
    print(json.dumps(check(args.scale, args.device) if args.check
                     else smoke(args.scale, device=args.device)))
