"""The benchmark twins benchmarks/torch_{comm_scaling,fault_tolerance}.py
against their originals
on the CPU: the same rows, and the same printed lines with the
wall-clock numbers masked.  Each sweep is cut to its smallest points
that still reach every branch, at scale 0.001, and the costliest
workloads have cheap stand-ins (tests/_torch_scripts.py); the engine
itself is held elsewhere.  The other benchmark twins are in
test_torch_scripts_{engine,overlap,pathfind}.py."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import load, main_lines, stand_in  # noqa: E402

SCALE = 0.001


def test_comm_scaling_rows_match():
    """HST-L over one rank on both fabrics (the inter-DPU exchange gives
    the direct-vs-host row) and the collective microbenchmark over one
    and two ranks."""
    ref = load("benchmarks/comm_scaling.py")
    twin = load("benchmarks/comm_scaling.py", twin=True)
    kw = dict(workloads=("HST-L",), ranks=(1,))
    got = twin.comm_strong_scaling(SCALE, device="cpu", **kw)
    assert got == ref.comm_strong_scaling(SCALE, **kw)
    assert [r["fabric"] for r in got] == ["host", "direct", "direct_vs_host"]
    got = twin.collective_microbench(0.01, ranks=(1, 2), device="cpu")
    assert got == ref.collective_microbench(0.01, ranks=(1, 2))
    assert len(got) == 4 and all(r["bench"] == "comm_micro" for r in got)


def test_fault_tolerance_main_and_smoke_match(monkeypatch):
    """The sweep's table at a fault rate high enough to kill DPUs in one
    launch (every policy's branch: the fail-stop abort, remap, spare
    promotion), and the killed-DPU smoke."""
    stand_in(monkeypatch, mapping={"HST-S": "RED", "BFS": "RED"})
    ref, got = main_lines("benchmarks/fault_tolerance.py",
                          ["--scale", str(SCALE), "--rates", "0.3",
                           "--trials", "1", "--launches", "1"])
    assert got == ref and ref[0] == 0
    assert [line.split()[0] for line in ref[1][1:]] == [
        "fail-stop", "remap", "spare"]
    ref_m = load("benchmarks/fault_tolerance.py")
    twin = load("benchmarks/fault_tolerance.py", twin=True)
    got = twin.smoke(SCALE, device="cpu")
    assert got == ref_m.smoke(SCALE)
    assert got == {"ok": True, "active_dpus": [0, 2, 3], "faults": 1}
