#!/usr/bin/env python3
"""Hold the rows of a benchmarks/torch_pim_figs.py run (on the card, say)
to benchmarks/pim_figs.py's on the JAX package, study by study.

    python3 benchmarks/torch_pim_figs.py --scale 0.05 > figs.jsonl  # card
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/compare_pim_figs.py \\
        figs.jsonl --scale 0.05                                      # JAX

Runs each study the file holds rows of on the JAX package (CPU) and
prints ``<study> SAME`` or ``<study> DIFF`` with the first row that
differs; the simulation rate is compared by its instruction counts (its
other fields are wall-clock).  Exits 1 if any study differs.  Imports
the JAX package on purpose: it never runs on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import pim_figs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", help="torch_pim_figs.py's output")
    ap.add_argument("--scale", type=float, default=0.05)
    args = ap.parse_args(argv)
    got = {}
    with open(args.rows) as f:
        for line in f:
            if line.startswith("{"):
                row = json.loads(line)
                if "bench" in row:
                    got.setdefault(row.pop("study"), []).append(row)
    s = args.scale
    with tempfile.TemporaryDirectory() as tmp:
        char = {}

        def need_char():
            if not char:
                char.update(pim_figs.characterize(
                    s, cache_path=str(Path(tmp) / "char.json")))
            return char

        studies = {
            "fig5_util": lambda: pim_figs.fig5_utilization(need_char(), s),
            "fig6_breakdown": lambda: pim_figs.fig6_breakdown(need_char(), s),
            "fig7_tlp_hist": lambda: pim_figs.fig7_tlp_hist(need_char(), s),
            "fig8_tlp_ts": lambda: pim_figs.fig8_tlp_timeseries(need_char(),
                                                                s),
            "fig9_instr_mix": lambda: pim_figs.fig9_instr_mix(need_char(), s),
            "fig10_scaling": lambda: pim_figs.fig10_strong_scaling(s),
            "fig11_simt": lambda: pim_figs.fig11_simt(s),
            "fig12_ilp": lambda: pim_figs.fig12_ilp(s),
            "fig13_mram_bw": lambda: pim_figs.fig13_mram_bw(s),
            "fig15_cache": lambda: pim_figs.fig15_cache_vs_scratchpad(s),
            "mmu_overhead": lambda: pim_figs.mmu_overhead(s),
            "simulation_rate": lambda: pim_figs.simulation_rate(s),
        }
        bad = 0
        for name, rows in got.items():
            want = json.loads(json.dumps(studies[name](), default=float))
            if name == "simulation_rate":
                want = [r["instructions"] for r in want]
                rows = [r["instructions"] for r in rows]
            same = want == rows
            bad += not same
            print(f"{name} {len(rows)} rows {'SAME' if same else 'DIFF'}",
                  flush=True)
            if not same:
                first = next((w, g) for w, g in zip(want + [None] * len(rows),
                                                    rows + [None] * len(want))
                             if w != g)
                print(f"  want {first[0]}\n  got  {first[1]}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
