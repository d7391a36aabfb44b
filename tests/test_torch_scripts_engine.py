"""benchmarks/torch_engine_perf.py against benchmarks/engine_perf.py on
the CPU: the launch probe, the subset launches and a steady-state row
give the reference's modeled fields (cycles, issued, the compile cache's
misses and hits: one driver build per shape bucket, a hit per relaunch,
none new for subsets sharing a DPU bucket), the wall-clock ones masked;
``--json`` writes only where it is told.  VA at scale 0.001 (a CPU step
of the port costs ~2 ms)."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import load, rows_modeled  # noqa: E402

from repro.core import compile_cache as ref_cache  # noqa: E402
from repro_torch.core import compile_cache as pt_cache  # noqa: E402

SCALE = 0.001
#: the counters both caches keep (the port's also counts ``steps``)
COUNTERS = ("entries", "hits", "misses", "launches")


def _both(fn, *args, **kw):
    """``fn`` of engine_perf and of its twin (on the CPU), each after its
    package's cache was cleared; returns (reference row, its counters,
    twin row, its counters)."""
    out = []
    for twin, cache in ((False, ref_cache), (True, pt_cache)):
        cache.clear()
        row = getattr(load("benchmarks/engine_perf.py", twin), fn)(
            *args, **dict(kw, device="cpu") if twin else kw)
        stats = cache.stats()
        out += [row, {k: stats[k] for k in COUNTERS}]
    return out


def test_launch_latency_and_subset_reuse_match():
    ref, ref_c, got, got_c = _both("launch_latency", "VA", SCALE,
                                   warm_reps=1)
    assert rows_modeled(got, "engine_perf") == \
        rows_modeled(ref, "engine_perf")
    assert got_c == ref_c == {"entries": 1, "hits": 1, "misses": 1,
                              "launches": 2}
    assert got["cold_s"] > 0 and got["warm_s"] > 0
    ref, ref_c, got, got_c = _both("subset_reuse", "VA", SCALE, n_dpus=4)
    assert rows_modeled(got, "engine_perf") == \
        rows_modeled(ref, "engine_perf")
    assert got["new_compiles"] == 0 and sorted(got["subset_warm_s"]) == [3, 4]
    assert got_c == ref_c


def test_steady_state_matches_without_event_skip():
    """The knob the BS rows sweep (``event_skip``), on VA: every cycle a
    step.  The twin's own keys: the driver's steps, the wall inside its
    K-step loops and the set-up share outside them."""
    ref, ref_c, got, got_c = _both("steady_state", "VA", SCALE, n_dpus=1,
                                   event_skip=False)
    assert rows_modeled(got, "engine_perf") == \
        rows_modeled(ref, "engine_perf")
    assert got_c == ref_c
    # every cycle a step, and the steps of the last block past the end
    assert got["cycles"] <= got["steps"] < \
        got["cycles"] + pt_cache.STEPS_PER_CHECK
    assert 0 < got["loop_s"] <= got["run_s"] + 1e-3
    assert 0.0 <= got["outside_share"] < 1.0


def test_json_is_written_only_where_asked(tmp_path, monkeypatch):
    """main()'s report goes to --json's path and nowhere else, names its
    device, and --check passes on it; its rows are the functions' (held
    above), stubbed here: VA on 1, 4, 16 and 64 DPUs, BS on one with and
    without event skipping."""
    twin = load("benchmarks/engine_perf.py", twin=True)
    calls = []

    def row(name, *a, **kw):
        calls.append((name, kw.get("n_dpus"), kw.get("event_skip")))
        return {"workload": name, "cold_s": 2.0, "warm_s": 1.0,
                "speedup": 2.0, "new_compiles": 0}

    monkeypatch.setattr(twin, "launch_latency", row)
    monkeypatch.setattr(twin, "subset_reuse", row)
    monkeypatch.setattr(twin, "steady_state", row)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "perf.json"
    report = twin.main(["--device", "cpu", "--json", str(out), "--check"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["perf.json"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert report["device"] == {"type": "cpu"}
    assert calls == [("VA", None, None), ("VA", None, None),
                     ("VA", 1, None), ("VA", 4, None), ("VA", 16, None),
                     ("VA", 64, None), ("BS", 1, False), ("BS", 1, True)]
