#!/usr/bin/env python3
"""Write src/repro_torch/workloads/goldens.json from the JAX package.

Runs the workloads of ``repro.workloads.ALL`` that each configuration of
``repro_torch.workloads.goldens.CONFIGS`` holds (g4: 4 DPUs x 8 tasklets;
g64: 64 DPUs x 16 tasklets; s4, s4ac, h4: g4 on the SIMT engine and the
HBM-PIM compat target; c4: GEMVS on the HBM-PIM command path; fig11/*:
Fig. 11's five designs), the remap scenario (``goldens.REMAP``: HST-S
on g4 with one DPU killed at the first launch) and the cluster
(``goldens.CLUSTER``: benchmarks/cluster_load.py's system and tenant mix
with measured profiles, each policy at each fault rate) on the JAX
package, and
records each run with ``goldens.run_entry``, the function the port's
tests and ``chip_smoke.py`` compare with (a run that raises is recorded
by its exception and the digest of its capped state).  The card's
machine has no JAX, so this runs on a CPU with JAX installed:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_workload_goldens.py
        [--only KEY ... | --only cluster]

``--only`` writes only those configurations (``cluster``: the cluster
goldens; no remap scenario either way) into
the existing file, under a lock, and leaves every other entry as it was:
several ``--only`` runs may go at once.
"""
from __future__ import annotations

import argparse
import fcntl
import json
import sys
import time

import repro.workloads as wl
from repro import cluster
from repro.core import compile_cache
from repro.core.config import DPUConfig
from repro.core.host import PIMSystem
from repro.faults.model import FaultPlan, kill_dpu
from repro_torch.workloads import goldens


def _config(key: str) -> dict:
    f, t, s, seed = goldens.CONFIGS[key]
    return {"dpu_config": f, "threads": t, "scale": s, "seed": seed}


def _entries(key: str) -> dict:
    out = {}
    for name in goldens.workloads_of(key, wl.ALL):
        t0 = time.perf_counter()
        out[name] = e = goldens.run_entry(wl, DPUConfig, PIMSystem,
                                          compile_cache, key, name)
        what = e.get("raises") or f"{e['cycles']} cycles, {e['issued']} issued"
        print(f"{key} {name}: {what} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def _cluster() -> dict:
    t0 = time.perf_counter()

    def run(policy, rate):
        return goldens.run_cluster(cluster, DPUConfig, PIMSystem, FaultPlan,
                                   policy, rate)

    out = goldens.cluster_entries(run)
    out["config"] = goldens.CLUSTER
    for key, rep in out["runs"].items():
        print(f"cluster {key}: {rep['metrics']['completed']} of "
              f"{rep['metrics']['jobs']} jobs, goodput {rep['goodput']}",
              flush=True)
    print(f"cluster ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def _write(out: dict):
    with open(goldens.PATH, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", metavar="KEY",
                    choices=sorted(goldens.CONFIGS) + ["cluster"],
                    help="write only these configurations")
    args = ap.parse_args(argv)
    if args.only:
        new = {key: _cluster() if key == "cluster" else _entries(key)
               for key in args.only}
        with open(goldens.PATH.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            out = goldens.load()
            for key, entries in new.items():
                if key == "cluster":
                    out["cluster"] = entries
                    continue
                out["configs"][key] = _config(key)
                out["entries"][key] = entries
            _write(out)
        print(f"wrote {', '.join(args.only)} into {goldens.PATH}")
        return 0
    out = {"configs": {k: _config(k) for k in goldens.CONFIGS},
           "entries": {k: _entries(k) for k in goldens.CONFIGS}}
    rep, system, st = goldens.run_remap(wl, DPUConfig, PIMSystem, FaultPlan,
                                        kill_dpu)
    out["remap"] = goldens.remap_entry(rep, system, st)
    print(f"remap {goldens.REMAP}: {out['remap']['fault_log']}", flush=True)
    out["cluster"] = _cluster()
    _write(out)
    print(f"wrote {goldens.PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
