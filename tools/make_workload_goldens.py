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
package, and the entry points (``script_runs.SCRIPT_RUNS``: the
benchmark and example scripts' printed lines at the arguments
``chip_smoke.py`` [scripts] runs their twins at, wall-clock numbers
masked; ``script_runs.ENGINE_PERF``: benchmarks/engine_perf.py's modeled
rows; ``script_runs.QUICKSTART``: examples/quickstart.py's printed lines,
its initial parameters into tests/data/quickstart_init.npz and the
batches it took into tests/data/quickstart_data.npz), and
records each run with ``goldens.run_entry``, the function the port's
tests and ``chip_smoke.py`` compare with (a run that raises is recorded
by its exception and the digest of its capped state).  The card's
machine has no JAX, so this runs on a CPU with JAX installed:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_workload_goldens.py
        [--only KEY ... | --only cluster | --only scripts |
         --only quickstart | --script KEY ...]

``--only`` writes only those configurations (``cluster``: the cluster
goldens; ``scripts``: the entry points'; ``quickstart``: the quickstart's
lines and initial parameters; no remap scenario either way)
into
the existing file, under a lock, and leaves every other entry as it was:
several ``--only`` runs may go at once.  ``--script`` writes only those
runs of ``script_runs.SCRIPT_RUNS`` into the scripts entry.
"""
from __future__ import annotations

import argparse
import fcntl
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import repro.workloads as wl  # noqa: E402
from repro import cluster  # noqa: E402
from repro.core import compile_cache  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.host import PIMSystem  # noqa: E402
from repro.faults.model import FaultPlan, kill_dpu  # noqa: E402
from repro_torch.workloads import goldens  # noqa: E402
import script_runs  # noqa: E402


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


def script_entry(path: str, argv: list) -> dict:
    """The golden of one entry point's run on the JAX package: its exit
    code and its printed lines, wall-clock numbers masked (a run.py suite
    traced and checked, as ``chip_smoke.py`` runs its twin)."""
    import tempfile
    from repro import obs
    with tempfile.TemporaryDirectory() as td:
        try:
            rc, text = script_runs.run_main(
                script_runs.load_script(ROOT, path),
                script_runs.script_argv(path, argv, td))
        finally:
            obs.set_default_tracer(None)   # --trace sets it process-wide
    name = " ".join([Path(path).stem] + list(argv))
    return {"script": path, "argv": list(argv), "rc": rc,
            "lines": script_runs.masked_lines(text, name)}


def engine_perf_entry(key: str) -> dict:
    """benchmarks/engine_perf.py's row ``key`` of
    ``script_runs.ENGINE_PERF`` on the JAX package, wall-clock values
    masked."""
    fn, args, kw = script_runs.ENGINE_PERF[key]
    mod = script_runs.load_script(ROOT, "benchmarks/engine_perf.py")
    return script_runs.modeled(getattr(mod, fn)(*args, **kw),
                               script_runs.wall_keys("engine_perf"))


def _script_task(kind: str, key: str) -> tuple:
    """One golden of :func:`_scripts` (run in a worker process)."""
    t0 = time.perf_counter()
    entry = (script_entry(*script_runs.SCRIPT_RUNS[key]) if kind == "runs"
             else engine_perf_entry(key))
    return entry, time.perf_counter() - t0


def _scripts(keys=None) -> dict:
    """The entry points' goldens, four runs at a time (each in a process
    of its own: the runs are independent, and the fault studies alone
    take the JAX package minutes on the CPU); with ``keys``, only those
    runs of ``script_runs.SCRIPT_RUNS``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    tasks = [("runs", k) for k in keys or script_runs.SCRIPT_RUNS] \
        + ([("engine_perf", k) for k in script_runs.ENGINE_PERF]
           if keys is None else [])
    # the fault studies and the figs suite take longest: start them first
    tasks.sort(key=lambda t: not any(w in t[1] for w in ("fault", "figs")))
    out = {"runs": {}, "engine_perf": {}}
    with ProcessPoolExecutor(
            max_workers=4,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {t: pool.submit(_script_task, *t) for t in tasks}
        for (kind, key), fut in futures.items():
            out[kind][key], secs = fut.result()
            e = out[kind][key]
            if kind == "engine_perf":
                print(f"scripts engine_perf {key}: {e} ({secs:.1f} s)",
                      flush=True)
                continue
            print(f"scripts {key}: exit {e['rc']}, {len(e['lines'])} lines "
                  f"({secs:.1f} s)", flush=True)
            if e["rc"] != 0 or any('"error": ' in ln for ln in e["lines"]):
                print("\n".join(e["lines"][-8:]), flush=True)
    return out


def quickstart_init(path):
    """Write examples/quickstart.py's initial parameters (``init_params``
    of its configuration, which is its twin's ``config()``, at its key) to
    ``path`` as an npz keyed by leaf path."""
    import dataclasses

    import jax
    import numpy as np
    from repro.configs.base import ArchConfig
    from repro.models import transformer as T
    twin = script_runs.load_script(ROOT, QUICKSTART_PATH, twin=True)
    cfg = ArchConfig(**dataclasses.asdict(twin.config()))
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    np.savez(path, **{"/".join(str(k.key) for k in p): np.asarray(v)
                      for p, v in leaves})


QUICKSTART_PATH = script_runs.QUICKSTART["script"]


def _quickstart() -> dict:
    """examples/quickstart.py's golden lines, its initial parameters
    written to ``script_runs.QUICKSTART["init"]`` and the batches its data
    pipeline gave it (tokens and labels, (steps, batch, seq) int32, by
    step) to ``script_runs.QUICKSTART["data"]``."""
    import numpy as np
    from repro.data.pipeline import SyntheticLM
    t0 = time.perf_counter()
    quickstart_init(ROOT / script_runs.QUICKSTART["init"])
    taken = {}
    batch_at = SyntheticLM.batch_at

    def recording(self, step):
        taken[step] = b = batch_at(self, step)
        return b

    SyntheticLM.batch_at = recording
    try:
        rc, text = script_runs.run_main(
            script_runs.load_script(ROOT, QUICKSTART_PATH), [])
    finally:
        SyntheticLM.batch_at = batch_at
    steps = sorted(taken)
    assert steps == list(range(len(steps))), steps
    np.savez_compressed(
        ROOT / script_runs.QUICKSTART["data"],
        **{k: np.stack([taken[i][k] for i in steps]) for k in taken[0]})
    print(f"quickstart: exit {rc} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return dict(script_runs.QUICKSTART, rc=rc, lines=text.splitlines())


def _write(out: dict):
    with open(goldens.PATH, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", metavar="KEY",
                    choices=sorted(goldens.CONFIGS) + ["cluster",
                                                       "scripts",
                                                       "quickstart"],
                    help="write only these configurations")
    ap.add_argument("--script", nargs="+", metavar="KEY",
                    choices=sorted(script_runs.SCRIPT_RUNS),
                    help="write only these runs of SCRIPT_RUNS")
    args = ap.parse_args(argv)
    if args.script:
        new = _scripts(args.script)["runs"]
        with open(goldens.PATH.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            out = goldens.load()
            out["scripts"]["runs"].update(new)
            _write(out)
        print(f"wrote {', '.join(args.script)} into {goldens.PATH}")
        return 0
    if args.only:
        made = {"cluster": _cluster, "scripts": _scripts,
                "quickstart": _quickstart}
        new = {key: made[key]() if key in made else _entries(key)
               for key in args.only}
        with open(goldens.PATH.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            out = goldens.load()
            for key, entries in new.items():
                if key in made:
                    out[key] = entries
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
    out["scripts"] = _scripts()
    out["quickstart"] = _quickstart()
    _write(out)
    print(f"wrote {goldens.PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
