#!/usr/bin/env python3
"""Measure the cluster's job profiles at a wide rank on the port and write
them as JSON.

``chip_smoke.py`` [cluster] (b) runs the four-tenant cluster on 8 ranks
of 32 DPUs with profiles measured on one 32-DPU, 8-tasklet, 2 MiB rank
at scale 0.375 (BFS, HST-S, SSORT through ``cycle_step``, each under its
numpy oracle).  This writes those profiles (``goldens.profile_steps``
of each kind) to ``--out``, so that the CPU tests can feed both
packages' ``PimCluster(profiles=...)`` the same recorded command
streams (``tests/test_torch_cluster_wide.py``) without re-running the
workloads at that size, which the CPU cannot do in a test's time.

    python3 tools/torch_cluster_profiles.py \\
        [--out tests/data/cluster_profiles_wide.json] [--device cuda]

Runs on the CUDA card unless ``--device cpu`` asks for the CPU (SSORT
at this size takes hours there).  Imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: [cluster] (b)'s reference rank (chip_smoke.py CLUSTER_FULL_SYSTEM /
#: CLUSTER_FULL_SCALE): 32 DPUs, 8 tasklets, 2 MiB, scale 0.375, seed 0
RANK = dict(n_dpus=32, n_threads=8, scale=0.375, seed=0, mram_bytes=1 << 21)
OUT = ROOT / "tests" / "data" / "cluster_profiles_wide.json"


def measure(device=None) -> dict:
    """Each kind's profile at :data:`RANK` on ``device``, as
    ``goldens.profile_steps`` holds it, with its wall seconds."""
    from repro_torch.cluster import measure_profile
    from repro_torch.workloads import goldens
    out = {"rank": RANK, "profiles": {}, "wall_s": {}}
    for kind in goldens.CLUSTER_KINDS:
        t0 = time.perf_counter()
        prof = measure_profile(kind, device=device, **RANK)
        out["wall_s"][kind] = time.perf_counter() - t0
        out["profiles"][kind] = goldens.profile_steps(prof)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    got = measure(args.device)
    wall = got.pop("wall_s")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"out": args.out, "wall_s": wall,
                      "steps": {k: len(v) for k, v
                                in got["profiles"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
