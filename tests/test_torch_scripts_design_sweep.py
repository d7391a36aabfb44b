"""The fleet-scale design sweep's twin, examples/torch_pim_design_sweep.py,
against examples/pim_design_sweep.py on the CPU: the grid scheduled by
``WorkRebalancer``, each unit timed by ``StepMonitor``, the speed-up
table and the verdict print the reference's lines exactly.

Scale: 0.001, and the six workloads stand in as two (VA for VA, TS and
HST-S; RED for RED, BS and GEMV, as tests/_torch_scripts.py's stand-ins
do for the other twins) run once for each design: a CPU step of the port
costs ~1 ms, and the whole grid (36 units, GEMV alone ~65,000 steps at
any scale) would take the port over 15 minutes on the CPU.  The runs are
deterministic, so a unit whose
(design, stand-in) ran already takes that run's report; the 12 that run
cost ~45 s.  The card runs the whole sweep at its default scale against
goldens.json (chip_smoke.py [scripts])."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from _torch_scripts import main_lines  # noqa: E402

SCALE = "0.001"
STAND_IN = {"VA": "VA", "TS": "VA", "HST-S": "VA", "RED": "RED",
            "BS": "RED", "GEMV": "RED"}


class _Once:
    """A workload whose ``run`` runs once for each (system config,
    threads, scale) and returns that run's result after."""

    def __init__(self, workload, cache):
        self._w, self._cache = workload, cache

    def __getattr__(self, name):
        return getattr(self._w, name)

    def run(self, system, n_threads, scale):
        key = (self._w.name, repr(dataclasses.astuple(system.cfg)),
               n_threads, scale)
        if key not in self._cache:
            self._cache[key] = self._w.run(system, n_threads, scale=scale)
        return self._cache[key]


def test_design_sweep_lines_match(monkeypatch):
    runs = {}
    for pkg in (ref_wl, pt_wl):
        cache = {}
        monkeypatch.setattr(
            pkg, "get", lambda name, _all=pkg.ALL, _c=cache: _Once(
                _all[STAND_IN[name]], _c))
        runs[pkg.__name__] = cache
    ref, got = main_lines("examples/pim_design_sweep.py", ["--scale", SCALE])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert lines[0] == ("36 work units over 4 workers; makespan(model) = "
                        "14.0 (naive contiguous = 24.0)")
    assert [line.split()[0] for line in lines[3:9]] == [
        "base", "ilp(D+R)", "ilp(D+R+S)", "ilp+700MHz", "bw_x2",
        "ilp+bw_x2"]
    assert lines[-1].startswith("pathfinding verdict: ")
    # six designs x two stand-ins ran in each package
    assert [len(c) for c in runs.values()] == [12, 12]
