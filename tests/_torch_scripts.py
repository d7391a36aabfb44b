"""Helpers of the tests that hold the entry-point twins
(benchmarks/torch_*.py, examples/torch_*.py) against their originals on
the CPU: load a script or its twin as a module, give both packages the
same cheap stand-in workloads, run a ``main`` and mask its wall-clock
numbers (tools/script_runs.py, the same masks chip_smoke.py uses).

A CPU step of the port costs ~2 ms, and a step is about one instruction
of one DPU: BFS, GEMVS, SSORT and HST-S take 20 s to minutes at any
scale (their floors), so where a script runs them the tests stand a
cheaper workload of the same interface in for them, in both packages
alike.  The scripts' own code (systems, fabrics, sweeps, tables) runs
unchanged; the engine under each workload is held elsewhere
(test_torch_workloads*.py, the goldens).
"""
import sys
from pathlib import Path

import repro.workloads as ref_wl
import repro_torch.workloads as pt_wl

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import script_runs  # noqa: E402
#: workload -> the cheap one run in its place (RED: ~1,200 steps at
#: scale 0.001; HST-L: ~3,500, with an inter-DPU exchange like HST-S's)
STAND_IN = {"BFS": "HST-L", "GEMVS": "RED", "SSORT": "HST-L",
            "HST-S": "HST-L", "BS": "RED", "GEMV": "RED"}


def load(path: str, twin: bool = False):
    """benchmarks/<x>.py or examples/<x>.py (its torch_ twin if
    ``twin``) as a module."""
    return script_runs.load_script(ROOT, path, twin)


def stand_in(monkeypatch, mapping=None):
    """Both registries' ``get``, and ``get`` wherever a loaded module
    imported it by name, return the :data:`STAND_IN` workload (or
    ``mapping``'s) in place of the one asked for."""
    mapping = STAND_IN if mapping is None else mapping
    for pkg in (ref_wl, pt_wl):
        def get(name, _all=pkg.ALL):
            return _all[mapping.get(name, name)]
        orig = pkg.get
        for mod in list(sys.modules.values()):
            if getattr(mod, "get", None) is orig:
                monkeypatch.setattr(mod, "get", get)


def main_lines(path: str, argv, name: str = None) -> tuple:
    """Run the script's ``main`` and its twin's (``--device cpu``) on
    ``argv``; returns both ``(exit code, masked lines)``."""
    name = name or Path(path).stem
    out = []
    for twin in (False, True):
        mod = load(path, twin)
        rc, text = script_runs.run_main(
            mod, list(argv) + (["--device", "cpu"] if twin else []))
        out.append((rc, script_runs.masked_lines(text, name)))
    return tuple(out)


def rows_modeled(rows, script: str):
    """A script's rows with its wall-clock values masked and the port's
    own keys left out."""
    return script_runs.modeled(rows, script_runs.wall_keys(script),
                               script_runs.PORT_KEYS.get(script, ()))
