"""Benchmark harness on the PyTorch/CUDA port: one function per paper
table/figure (benchmarks/run.py's registry, the same bench names, suites
and caps, calling the ``torch_*`` twins; every system simulates on the
CUDA card unless ``--device cpu`` asks for the CPU).

Prints ``name,us_per_call,derived`` CSV rows (one per figure/design point).
``--scale`` grows datasets toward the paper's Table II sizes; default runs
the suite at CI scale in a few minutes.  ``--suite`` selects a family
(``figs`` paper figures, ``comm`` interconnect/collectives, ``overlap``
async-pipeline, ``lm`` serving roofline (the rows of the port's one-card
dry-run, ``python -m repro_torch.launch.dryrun``, in ``--dryrun-dir``,
read by benchmarks/lm_roofline.py), ``faults`` fault-injection
availability/goodput, ``cluster`` multi-tenant cluster runtime,
``all``); ``--only`` further filters by substring — a filter matching
nothing is an error listing the valid bench names, not a silent no-op.

``--trace PATH`` runs the selected benches under a process-wide
:class:`repro_torch.obs.Tracer` (every :class:`PIMSystem` any suite builds
attaches automatically) and writes the combined Chrome-trace JSON to
PATH plus a ``RunProfile`` counters snapshot next to it
(``<PATH minus .json>.counters.json``) — open the trace in
``ui.perfetto.dev``, render the counters with ``python -m
repro_torch.obs.report``.  ``--check`` (requires ``--trace``) gates on
trace/timeline consistency: every system's per-phase span sums must
match its timeline busy totals, or the run exits nonzero.

    python benchmarks/torch_run.py [--scale 0.05] [--device cpu] \\
        [--suite comm] [--only fig11] [--trace run.trace.json] [--check] \\
        [--dryrun-dir reports/torch_dryrun]

A bench that raises becomes an ``error`` row (as in the reference), so a
caller that needs every bench to pass reads the rows for ``error``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

#: suite families selectable via --suite (benches declare theirs inline)
SUITE_NAMES = ("figs", "comm", "overlap", "lm", "faults", "cluster",
               "overload", "pathfind")


def _emit(name: str, wall_s: float, rows):
    derived = json.dumps(rows, default=float)
    print(f"{name},{wall_s * 1e6:.0f},{derived}")


def lm_roofline_table(dryrun_dir: str) -> list:
    """The rows of the port's dry-run in ``dryrun_dir``, through
    benchmarks/lm_roofline.py (which imports neither package); raises
    when there are none."""
    from benchmarks import lm_roofline
    rows = lm_roofline.table(dryrun_dir)
    if "error" in rows[0]:
        raise FileNotFoundError(
            f"no dry-run rows in {dryrun_dir}; run python -m "
            f"repro_torch.launch.dryrun --out {dryrun_dir}")
    return rows


def registry(scale: float, device=None,
             dryrun_dir: str = "reports/torch_dryrun") -> dict:
    """bench name -> (suite, thunk, standalone caps): every bench of the
    port at ``scale`` on ``device``, the LM roofline read from
    ``dryrun_dir``; a thunk runs its bench and returns its rows."""
    from benchmarks import torch_cluster_load as cluster_load
    from benchmarks import torch_comm_scaling as comm_scaling
    from benchmarks import torch_fault_tolerance as fault_tolerance
    from benchmarks import torch_overlap_scaling as overlap_scaling
    from benchmarks import torch_overload as overload
    from benchmarks import torch_pathfind_arch as pathfind_arch
    from benchmarks import torch_pim_figs as pim_figs
    from benchmarks import torch_rank_overlap as rank_overlap
    from benchmarks import torch_trace_replay as trace_replay

    char = None

    def need_char():
        nonlocal char
        if char is None:
            char = pim_figs.characterize(scale, device=device)
        return char

    # single registry: bench name -> (suite, thunk, standalone caps) —
    # caps are the flags the bench's OWN script supports when run
    # directly (python benchmarks/<module>.py --smoke/--check), shown
    # by --list so CI wiring is discoverable
    benches = {
        "fig5_util": ("figs", lambda: pim_figs.fig5_utilization(need_char(), scale), ()),
        "fig6_breakdown": ("figs", lambda: pim_figs.fig6_breakdown(need_char(), scale), ()),
        "fig7_tlp_hist": ("figs", lambda: pim_figs.fig7_tlp_hist(need_char(), scale), ()),
        "fig8_tlp_ts": ("figs", lambda: pim_figs.fig8_tlp_timeseries(need_char(), scale), ()),
        "fig9_instr_mix": ("figs", lambda: pim_figs.fig9_instr_mix(need_char(), scale), ()),
        "fig10_scaling": ("figs", lambda: pim_figs.fig10_strong_scaling(scale, device), ()),
        "comm_scaling": ("comm", lambda: comm_scaling.comm_strong_scaling(scale, device=device), ()),
        "comm_micro": ("comm", lambda: comm_scaling.collective_microbench(scale, device=device), ()),
        "overlap_scaling": ("overlap", lambda: overlap_scaling.overlap_strong_scaling(scale, device=device), ()),
        "overlap_depth": ("overlap", lambda: overlap_scaling.overlap_depth_sweep(scale, device=device), ()),
        "rank_overlap": ("overlap", lambda: rank_overlap.rank_overlap(scale, device=device), ()),
        "rank_contention": ("overlap", lambda: rank_overlap.contention_sweep(scale, device=device), ()),
        "rank_calibration": ("overlap", lambda: rank_overlap.contention_calibration(scale, device), ()),
        "fig11_simt": ("figs", lambda: pim_figs.fig11_simt(scale, device), ()),
        "fig12_ilp": ("figs", lambda: pim_figs.fig12_ilp(scale, device=device), ()),
        "fig13_mram_bw": ("figs", lambda: pim_figs.fig13_mram_bw(scale, device=device), ()),
        "fig15_cache": ("figs", lambda: pim_figs.fig15_cache_vs_scratchpad(scale, device), ()),
        "mmu_overhead": ("figs", lambda: pim_figs.mmu_overhead(scale, device), ()),
        "simulation_rate": ("figs", lambda: pim_figs.simulation_rate(scale, device), ()),
        "lm_roofline": ("lm", lambda: lm_roofline_table(dryrun_dir), ()),
        "fault_smoke": ("faults", lambda: [fault_tolerance.smoke(device=device)],
                        ("--smoke", "--check")),
        "fault_tolerance": ("faults", lambda: fault_tolerance.sweep(
            scale, rates=[0.0, 0.02, 0.05], trials=2, launches=4,
            device=device),
            ("--smoke", "--check")),
        "cluster_smoke": ("cluster", lambda: [cluster_load.smoke(device)],
                          ("--smoke", "--check")),
        "cluster_load": ("cluster", lambda: cluster_load.load_table(
            scale, device=device), ("--smoke", "--check")),
        "overload_chaos": ("overload", lambda: overload.chaos_table(
            scale, device=device), ("--smoke", "--check")),
        "overload_hedge": ("overload", lambda: overload.hedge_rows(
            scale, device), ("--smoke", "--check")),
        "overload_resume": ("overload", lambda: [overload.smoke(device)],
                            ("--smoke", "--check")),
        "pathfind_arch": ("pathfind", lambda: pathfind_arch.compare(
            scale, device=device), ()),
        "pathfind_replay_sweep": ("pathfind",
                                  lambda: pathfind_arch.replay_sweep(
                                      scale, device=device), ()),
        "trace_replay_smoke": ("pathfind", lambda: [trace_replay.smoke(
            scale, device=device)], ("--check",)),
    }
    return benches


def bench_scripts() -> dict:
    """bench name -> the script whose function makes the bench's rows
    (``"pim_figs"`` for benchmarks/torch_pim_figs.py), read off the
    modules :func:`registry`'s thunks call; ``None`` for a bench of this
    file."""
    out = {}
    for name, (_, thunk, _) in registry(0.0, "cpu").items():
        mods = [c.cell_contents for c in thunk.__closure__ or ()
                if inspect.ismodule(c.cell_contents)]
        out[name] = mods[0].__name__.rsplit(".torch_", 1)[1] if mods else None
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--suite", default="all",
                    choices=("all",) + SUITE_NAMES)
    ap.add_argument("--only", default=None)
    ap.add_argument("--list", action="store_true",
                    help="print every registered bench (grouped by suite) "
                         "and exit without running anything")
    ap.add_argument("--dryrun-dir", default="reports/torch_dryrun")
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the run to PATH "
                         "(plus a RunProfile counters snapshot next to it)")
    ap.add_argument("--check", action="store_true",
                    help="with --trace: fail unless every system's "
                         "per-phase span sums match its timeline totals")
    args = ap.parse_args(argv)
    device = args.device
    if args.check and not args.trace:
        ap.error("--check requires --trace")

    tracer = profile = None
    if args.trace:
        from repro_torch import obs
        tracer = obs.Tracer()
        obs.set_default_tracer(tracer)
        # construct before the benches run: the compile-cache baseline is
        # taken here, so the snapshot reports this run's delta
        profile = obs.RunProfile(name=f"bench:{args.suite}")

    benches = registry(args.scale, device, args.dryrun_dir)
    bad = {k for k, (s, _, _) in benches.items() if s not in SUITE_NAMES}
    assert not bad, f"benches with unknown suite: {bad}"
    if args.list:
        for suite in SUITE_NAMES:
            members = sorted(k for k, (s, _, _) in benches.items()
                             if s == suite)
            print(f"{suite}:")
            for name in members:
                caps = benches[name][2]
                suffix = f"  [{' '.join(caps)}]" if caps else ""
                print(f"  {name}{suffix}")
        return
    selected = {k: fn for k, (suite, fn, _) in benches.items()
                if args.suite in ("all", suite)}
    if args.only:
        selected = {k: v for k, v in selected.items() if args.only in k}
    if not selected:
        # a typo'd --only used to "run" zero benches and exit 0 — make it
        # an error that names what would have matched
        valid = ", ".join(sorted(benches))
        raise SystemExit(
            f"no benchmark matches --suite {args.suite!r}"
            + (f" --only {args.only!r}" if args.only else "")
            + f"; valid names: {valid}")

    from repro_torch.core.carry import resolve_device
    resolve_device(device)        # raises without a card unless cpu

    for name, fn in selected.items():
        t0 = time.time()
        try:
            rows = fn()
        except Exception as e:  # noqa: BLE001
            rows = [{"error": f"{type(e).__name__}: {e}"}]
        _emit(name, time.time() - t0, rows)

    if tracer is not None:
        tracer.finalize()
        tracer.save(args.trace)
        for system in tracer.systems:
            profile.record_system(system)
        profile.record_compile_cache()
        counters_path = os.path.splitext(args.trace)[0] + ".counters.json"
        profile.save(counters_path)
        print(f"# trace: {args.trace}  counters: {counters_path}")
        if args.check:
            errors = tracer.validate()
            if errors:
                raise SystemExit("trace/timeline mismatch:\n"
                                 + "\n".join(errors))
            print(f"# check: OK ({len(tracer.systems)} systems consistent)")


if __name__ == "__main__":
    main()
