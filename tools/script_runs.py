"""The entry points' golden runs and the masks that compare them.

A study script is benchmarks/<x>.py or examples/<x>.py on the JAX
package; its twin on the port is the same path with ``torch_`` before
the file name, and takes the same arguments (``--device`` apart).
``tools/make_workload_goldens.py --only scripts`` runs the scripts of
:data:`SCRIPT_RUNS` and :data:`ENGINE_PERF` on the JAX package and
writes what they model into ``goldens.json``; ``chip_smoke.py``
[scripts] runs the twins on the card against it, and the
``tests/test_torch_scripts_*.py`` run both on the CPU.  Every side masks
the wall-clock numbers here, so that what is left compares exactly.

This module imports neither package: :func:`load_script` loads the
script its caller names, and the caller decides which package runs.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import inspect
import io
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: each entry point's wall-clock keys: seconds and rates read off the
#: host's clock.  Every other key a script returns or prints is modeled,
#: and the port's equals the reference's exactly.  ``run`` is
#: benchmarks/run.py's CSV column; a row of run.py is masked with the
#: keys of the script its bench calls (:func:`bench_scripts`).
WALL_KEYS = {
    "engine_perf": ("cold_s", "warm_s", "speedup", "run_s", "compile_s",
                    "kips", "warm_kips", "cycles_per_s",
                    "warm_cycles_per_s", "subset_warm_s"),
    "pathfind_arch": ("replay_speedup",),
    "trace_replay": ("t_live_s", "t_replay_s", "speedup"),
    "pim_figs": ("wall_s", "kips", "cycles_per_s"),
    "run": ("us_per_call",),
    # the step lines' ms and tok/s, run_with_restarts' stragglers (its
    # StepMonitor times the steps) and the median step
    "launch_train": ("ms", "tok/s", "stragglers", "median step"),
    # its StepMonitor times each unit, but prints nothing of it
    "pim_design_sweep": (),
}
#: keys only the port's rows have, left out of a comparison with the
#: reference's (torch_engine_perf.py's driver steps, and its wall-clock
#: steps per second, K-step loop seconds and set-up share)
PORT_KEYS = {"engine_perf": ("steps", "steps_per_s", "loop_s",
                             "outside_share")}
#: wall-clock numbers in printed lines: script -> regex whose groups are
#: masked (the rest of a script's printed lines is modeled)
WALL_TEXT = {"pim_arch_compare": r"records, ([0-9.]+)s wall",
             "serve_lm": r"tokens\) in ([0-9.]+)s on",
             # every group is masked: WALL_KEYS["launch_train"] in order
             "launch_train": r" ([0-9]+) ms \(([0-9,]+) tok/s\)$|"
                             r"'stragglers': ([0-9]+)\}; median step "
                             r"([0-9]+) ms$"}
#: what a masked wall-clock value reads as
MASK = "*"

#: the entry points' golden runs: key -> (the reference's script, its
#: arguments).  A run.py suite is traced (:func:`script_argv`) and
#: checked, but for the overload suite: its trace check fails in the
#: reference too (a resumed cluster's journaled steps have no spans), so
#: it runs traced without ``--check``.  The scripts' defaults, but where
#: the JAX package takes too long on the CPU: the fault studies (their
#: HST-S launches, ~3 s each there whatever the scale) at scale 0.01, the
#: plain sweep at one trial (the check keeps three: only the third has a
#: fault at 2%), and run.py's figs suite at scale 0.01.
SCRIPT_RUNS = {
    **{f"examples/{name}": (f"examples/{name}.py", [])
       for name in ("pim_characterize", "pim_comm_pathfind",
                    "pim_arch_compare", "pim_async_pipeline",
                    "pim_sample_sort", "pim_design_sweep",
                    "pim_offload_planner")},
    "fault_tolerance": ("benchmarks/fault_tolerance.py",
                        ["--scale", "0.01", "--trials", "1"]),
    "fault_tolerance --smoke": ("benchmarks/fault_tolerance.py",
                                ["--smoke"]),
    "fault_tolerance --check": ("benchmarks/fault_tolerance.py",
                                ["--check", "--scale", "0.01"]),
    "overlap_scaling": ("benchmarks/overlap_scaling.py", []),
    "rank_overlap": ("benchmarks/rank_overlap.py", []),
    **{f"run --suite {suite}": (
        "benchmarks/run.py", ["--suite", suite]
        + (["--scale", "0.01"] if suite in ("figs", "faults") else [])
        + ([] if suite == "overload" else ["--check"]))
       for suite in ("figs", "comm", "overlap", "faults", "cluster",
                     "overload", "pathfind")},
}
#: benchmarks/engine_perf.py's golden rows: its launch probe and subset
#: launches at their default scale, BS on one DPU with and without event
#: skipping at scale 1.0 (``torch_engine_perf.py --scale 1.0`` runs them
#: all; its VA rows have no reference at that width)
ENGINE_PERF = {
    "launch": ("launch_latency", ("VA", 0.005), {}),
    "subset_reuse": ("subset_reuse", ("VA", 0.005), {}),
    "BS event_skip=False": ("steady_state", ("BS", 1.0),
                            dict(n_dpus=1, event_skip=False)),
    "BS event_skip=True": ("steady_state", ("BS", 1.0),
                           dict(n_dpus=1, event_skip=True)),
}


def script_argv(path: str, argv: list, trace_dir) -> list:
    """The arguments a golden run of :data:`SCRIPT_RUNS` takes on either
    side: ``argv``, and for a benchmarks/run.py suite ``--trace
    <trace_dir>/run_<suite>.trace.json`` (a checked suite's printed lines
    then end with the check; a mismatch is part of the golden, as the
    reference prints it)."""
    if not path.endswith("run.py"):
        return list(argv)
    suite = argv[argv.index("--suite") + 1]
    return list(argv) + ["--trace", str(Path(trace_dir)
                                        / f"run_{suite}.trace.json")]


def wall_keys(*scripts: str) -> tuple:
    """The wall-clock keys of ``scripts`` together."""
    return tuple(k for s in scripts for k in WALL_KEYS.get(s, ()))


def modeled(value, wall: tuple, drop: tuple = ()):
    """``value`` (a script's rows: dicts and lists, nested) with the value
    of every key in ``wall`` replaced by :data:`MASK` and every key in
    ``drop`` left out."""
    if isinstance(value, dict):
        return {k: MASK if k in wall else modeled(v, wall, drop)
                for k, v in value.items() if k not in drop}
    if isinstance(value, (list, tuple)):
        return [modeled(v, wall, drop) for v in value]
    return value


@functools.lru_cache(maxsize=None)
def bench_scripts() -> dict:
    """benchmarks/torch_run.py's bench name -> the script whose function
    makes its rows (the registry's own, :func:`torch_run.bench_scripts`;
    the bench names are run.py's)."""
    return load_script(ROOT, "benchmarks/run.py", twin=True).bench_scripts()


def masked_lines(text: str, script: str) -> list:
    """The lines ``script`` printed, its wall-clock numbers masked: the
    groups of :data:`WALL_TEXT`; for ``run``, each CSV row's
    ``us_per_call`` and the wall keys of the script behind its bench
    (:func:`bench_scripts`).  Lines that start with ``#`` (run.py's trace
    and check notes, which name files) are left out."""
    name = script.split()[0]
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        if name == "run" and line.count(",") >= 2 and "[" in line:
            bench, _, rows = line.split(",", 2)
            line = f"{bench},{MASK}," + json.dumps(modeled(
                json.loads(rows), wall_keys(bench_scripts().get(bench))))
        elif name in WALL_TEXT:
            m = re.search(WALL_TEXT[name], line)
            if m:
                spans = [m.span(i) for i in range(1, len(m.groups()) + 1)
                         if m.group(i) is not None]
                for a, b in reversed(spans):
                    line = line[:a] + MASK + line[b:]
        out.append(line)
    return out


def run_main(module, argv: list) -> tuple:
    """Run ``module.main`` (a script loaded as a module) on ``argv`` with
    its standard output captured; returns ``(exit code, stdout)``.  A
    ``main()`` that takes no arguments (the reference's) gets ``argv``
    through ``sys.argv``."""
    buf = io.StringIO()
    saved = sys.argv
    try:
        with contextlib.redirect_stdout(buf):
            try:
                if inspect.signature(module.main).parameters:
                    rc = module.main(argv)
                else:
                    sys.argv = [module.__file__] + list(argv)
                    rc = module.main()
            except SystemExit as e:          # a message exits 1
                rc = 1 if isinstance(e.code, str) else (e.code or 0)
                if isinstance(e.code, str):
                    print(f"SystemExit: {e.code}")
    finally:
        sys.argv = saved
    return (rc if isinstance(rc, int) else 0), buf.getvalue()


def load_script(root, path: str, twin: bool = False):
    """The script at ``path`` under ``root`` (its ``torch_`` twin if
    ``twin``) loaded as a module, its ``main()`` not run."""
    p = Path(root) / path
    if twin:
        p = p.with_name("torch_" + p.name)
    spec = importlib.util.spec_from_file_location(p.stem, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: examples/quickstart.py's golden run: the twin starts from the
#: reference's initial parameters (an npz of its tree) and, on a machine
#: whose numpy draws other Zipf samples for the data pipeline (the card's),
#: takes the batches the reference took (``data``: its tokens and labels a
#: step), both written beside the golden lines by
#: ``make_workload_goldens.py --only quickstart``
QUICKSTART = {"script": "examples/quickstart.py",
              "init": "tests/data/quickstart_init.npz",
              "data": "tests/data/quickstart_data.npz"}
#: how far the twin's printed loss and gradient norm may be from the
#: reference's: the lines round them to 3 and 2 decimals, and 120 float32
#: steps in another order of sums on another device move the last digit
QUICKSTART_TOL = {"loss": 5e-3, "gnorm": 2e-2}
_STEP_LINE = re.compile(r"step +(\d+) loss ([0-9.]+) gnorm ([0-9.]+)$")
_FINAL_LINE = re.compile(r"final loss ([0-9.]+) ")


def quickstart_departures(got: list, want: list) -> list:
    """What keeps the twin's quickstart lines ``got`` from the
    reference's ``want``: each step's loss and gnorm beyond
    :data:`QUICKSTART_TOL`, the final loss beyond its loss tolerance, any
    other line not equal (the served completions among them)."""
    if len(got) != len(want):
        return [f"{len(got)} lines, the reference printed {len(want)}"]
    out = []
    for g, w in zip(got, want):
        mg, mw = _STEP_LINE.match(g), _STEP_LINE.match(w)
        fg, fw = _FINAL_LINE.match(g), _FINAL_LINE.match(w)
        if mg and mw and mg[1] == mw[1]:
            if (abs(float(mg[2]) - float(mw[2])) > QUICKSTART_TOL["loss"]
                    or abs(float(mg[3]) - float(mw[3]))
                    > QUICKSTART_TOL["gnorm"]):
                out.append(f"{g!r} != {w!r}")
        elif fg and fw:
            if abs(float(fg[1]) - float(fw[1])) > QUICKSTART_TOL["loss"]:
                out.append(f"{g!r} != {w!r}")
        elif g != w:
            out.append(f"{g!r} != {w!r}")
    return out


def quickstart_losses(lines: list) -> list:
    """The losses the quickstart printed, in order (its steps', then the
    final one)."""
    return [float(m[2]) for m in map(_STEP_LINE.match, lines) if m] + [
        float(m[1]) for m in map(_FINAL_LINE.match, lines) if m]
