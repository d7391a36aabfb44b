#!/usr/bin/env python3
"""Write src/repro_torch/workloads/goldens.json from the JAX package.

Runs every workload of ``repro.workloads.ALL`` at each configuration of
``repro_torch.workloads.goldens.CONFIGS`` (g4: 4 DPUs x 8 tasklets; g64:
64 DPUs x 16 tasklets; scale 0.02, seed 0) and the remap scenario
(``goldens.REMAP``: HST-S on g4 with one DPU killed at the first launch)
on the JAX package, and records each run with ``goldens.entry``, the
function the port's tests and ``chip_smoke.py`` compare with.  The card's
machine has no JAX, so this runs on a CPU with JAX installed:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_workload_goldens.py
"""
from __future__ import annotations

import json
import sys
import time

import repro.workloads as wl
from repro.core.config import DPUConfig
from repro.core.host import PIMSystem
from repro.faults.model import FaultPlan, kill_dpu
from repro_torch.workloads import goldens


def main() -> int:
    out = {"configs": {k: {"dpu_config": f, "threads": t, "scale": s,
                           "seed": seed}
                       for k, (f, t, s, seed) in goldens.CONFIGS.items()},
           "entries": {}}
    for key in goldens.CONFIGS:
        out["entries"][key] = {}
        for name in sorted(wl.ALL):
            t0 = time.perf_counter()
            rep, system, st = goldens.run_config(wl, DPUConfig, PIMSystem,
                                                 key, name)
            out["entries"][key][name] = goldens.entry(rep, system, st)
            print(f"{key} {name}: {rep.cycles} cycles, {rep.issued} issued "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    rep, system, st = goldens.run_remap(wl, DPUConfig, PIMSystem, FaultPlan,
                                        kill_dpu)
    out["remap"] = goldens.remap_entry(rep, system, st)
    print(f"remap {goldens.REMAP}: {out['remap']['fault_log']}", flush=True)
    with open(goldens.PATH, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {goldens.PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
