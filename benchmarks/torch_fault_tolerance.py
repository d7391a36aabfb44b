"""Availability/goodput under DPU fault injection: the recovery-policy
case study, on the PyTorch/CUDA port (benchmarks/fault_tolerance.py's
sweep, smoke and gate on ``repro_torch``; every system simulates on the
CUDA card unless ``--device cpu`` asks for the CPU).

A fleet of 8 worker DPUs must deliver a fixed batch of ``--launches``
HST-S kernel launches while a :class:`FaultPlan` permanently kills DPUs
at ``--rates`` (per DPU per launch, swept 0 -> 5%).  Three recovery
policies compete:

* **fail-stop** — any fault aborts the batch; the work completed before
  the first death is all the useful work delivered (the remainder is
  charged at its ideal price with zero yield).
* **remap** — :func:`repro_torch.faults.remap.launch_with_remap` re-executes
  dead lanes' shards on survivors every launch; the batch always
  completes, at the price of the recovery launches.
* **spare** — 2 spare DPUs are provisioned; lost shards remap onto
  spares and the assignment is *promoted* (the spare keeps the shard),
  so later launches pay no recovery cost until spares run out (then it
  degrades to remap).

For each (policy, rate): ``goodput`` = useful kernel-seconds delivered /
(kernel-seconds spent + ideal price of work never delivered), and
``availability`` = fraction of trials that completed the whole batch.
Every completed launch is checked against the HST-S numpy oracle —
degraded execution must stay *correct*, not just fast.

    python benchmarks/torch_fault_tolerance.py [--scale 0.03] [--device cpu]
    python benchmarks/torch_fault_tolerance.py --check   # CI gate
    python benchmarks/torch_fault_tolerance.py --smoke   # BFS smoke
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.faults import DpuFaultError, FaultPlan, kill_dpu  # noqa: E402
from repro_torch.faults.remap import launch_with_remap  # noqa: E402

WORKERS = 8
SPARES = 2
NT = 8
POLICIES = ("fail-stop", "remap", "spare")


def _cfg(n_dpus: int) -> DPUConfig:
    return DPUConfig(n_dpus=n_dpus, n_tasklets=NT, mram_bytes=1 << 21)


def _host_data(scale: float, seed: int):
    # WORKERS shards of HST-S work, regardless of how many physical
    # lanes the policy provisions
    w = wl.get("HST-S")
    hd = w.host_data(_cfg(WORKERS), scale=scale, seed=seed)
    return w, hd


def _check_shards(hd, mem_shards: np.ndarray):
    if not hd.check(mem_shards):
        raise AssertionError("HST-S oracle mismatch under faults")


def _ref_seconds(binary, hd, scale: float, device=None) -> float:
    """Ideal (fault-free) kernel seconds of one batch launch."""
    system = PIMSystem(_cfg(WORKERS), device=device)
    _, rep = system.launch("HST-S", binary, hd.args, hd.mram, n_threads=NT)
    return rep.kernel_seconds


def _trial(policy: str, rate: float, trial: int, launches: int,
           binary, hd, ref: float, device=None) -> Dict[str, float]:
    total = WORKERS + (SPARES if policy == "spare" else 0)
    plan = FaultPlan(seed=7919 * trial + 13, p_dpu_permanent=rate)
    system = PIMSystem(
        _cfg(total), faults=plan,
        recovery="raise" if policy == "fail-stop" else "remap",
        device=device)
    assign = list(range(WORKERS))          # shard j -> physical lane
    spare_pool = list(range(WORKERS, total))
    M = hd.mram.shape[1]
    completed = 0
    for _ in range(launches):
        args_full = np.zeros((total, hd.args.shape[1]), np.int32)
        mram_full = np.zeros((total, M), np.int32)
        for shard, lane in enumerate(assign):
            args_full[lane] = hd.args[shard]
            mram_full[lane] = hd.mram[shard]
        lanes = sorted(assign)
        try:
            if policy == "fail-stop":
                st, _ = system.launch("HST-S", binary, args_full, mram_full,
                                      n_threads=NT,
                                      dpus=None if total == WORKERS
                                      else lanes)
            else:
                st, _ = launch_with_remap(
                    system, "HST-S", binary, args_full, mram_full,
                    n_threads=NT, dpus=lanes,
                    spares=[s for s in spare_pool
                            if system.active_mask[s]])
        except DpuFaultError:
            break  # batch aborted (fail-stop fault / no survivors)
        row_of = {lane: i for i, lane in enumerate(lanes)}
        mem = np.stack([np.asarray(st["mram"])[row_of[assign[s]]]
                        for s in range(WORKERS)])
        _check_shards(hd, mem)
        completed += 1
        if policy == "spare":
            # promote: a shard whose lane died keeps its spare for the
            # NEXT launches — the recovery cost is paid once
            for shard in range(WORKERS):
                if not system.active_mask[assign[shard]]:
                    live = [s for s in spare_pool if system.active_mask[s]]
                    if live:
                        assign[shard] = live[0]
                        spare_pool.remove(live[0])
    useful = completed * ref
    spent = system.timeline.total
    undelivered = (launches - completed) * ref
    denom = spent + undelivered
    return {
        "completed": completed,
        "goodput": useful / denom if denom > 0 else 1.0,
        "available": 1.0 if completed == launches else 0.0,
    }


def sweep(scale: float, rates: List[float], trials: int, launches: int,
          device=None) -> List[Dict]:
    w, hd = _host_data(scale, seed=0)
    binary = w.build(NT).binary(_cfg(WORKERS).iram_instrs)
    ref = _ref_seconds(binary, hd, scale, device)
    rows = []
    for rate in rates:
        for policy in POLICIES:
            res = [_trial(policy, rate, t, launches, binary, hd, ref,
                          device) for t in range(trials)]
            rows.append({
                "policy": policy, "rate": rate,
                "goodput": float(np.mean([r["goodput"] for r in res])),
                "availability": float(np.mean([r["available"]
                                               for r in res])),
                "completed": float(np.mean([r["completed"] for r in res])),
            })
    return rows


def smoke(scale: float = 0.08, device=None) -> Dict:
    """CI fault-injection smoke: a small BFS with one killed DPU must
    still pass its oracle via remap."""
    cfg = DPUConfig(n_dpus=4, n_tasklets=NT, mram_bytes=1 << 21)
    system = PIMSystem(cfg, faults=FaultPlan(events=(kill_dpu(1, 0),)),
                       device=device)
    wl.get("BFS").run(system, n_threads=NT, scale=scale)  # oracle inside
    assert not system.active_mask[1] and len(system.active_dpus) == 3
    return {"ok": True, "active_dpus": system.active_dpus,
            "faults": len(system.fault_log)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.03)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[0.0, 0.01, 0.02, 0.05])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="CI gate: remap goodput must beat fail-stop at "
                         "a 2%% fault rate")
    ap.add_argument("--smoke", action="store_true",
                    help="BFS-with-a-killed-DPU fault-injection smoke")
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    if args.smoke:
        print("fault_smoke,", smoke(device=args.device))
        return 0
    rates = [0.0, 0.02] if args.check else args.rates
    rows = sweep(args.scale, rates, args.trials, args.launches, args.device)
    print(f"{'policy':>10} {'rate':>6} {'goodput':>9} {'avail':>7} "
          f"{'completed':>9}")
    for r in rows:
        print(f"{r['policy']:>10} {r['rate']:>6.3f} {r['goodput']:>9.4f} "
              f"{r['availability']:>7.2f} {r['completed']:>9.2f}")
    if args.check:
        by = {(r["policy"], r["rate"]): r for r in rows}
        zero_ok = all(by[(p, 0.0)]["goodput"] == 1.0
                      and by[(p, 0.0)]["availability"] == 1.0
                      for p in POLICIES)
        remap, stop = by[("remap", 0.02)], by[("fail-stop", 0.02)]
        gate = remap["goodput"] > stop["goodput"]
        print(f"check: zero-rate ideal = {zero_ok}, remap goodput "
              f"{remap['goodput']:.4f} > fail-stop {stop['goodput']:.4f} "
              f"= {gate}")
        return 0 if (gate and zero_ok) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
