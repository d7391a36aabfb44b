"""The architecture-pathfinding twins against their originals on the CPU:
benchmarks/torch_pathfind_arch.py's rows (compare() on the scalar DPU,
the SIMT DPU 4 wide and the HBM-PIM all-bank target; the replay sweep)
and examples/torch_pim_arch_compare.py's printed lines, with the
wall-clock numbers masked and its bit-exact replay asserts kept.  RED
stands in for GEMVS and BFS (tests/_torch_scripts.py), at scale 0.001."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import load, main_lines, rows_modeled, stand_in  # noqa: E402

SCALE = 0.001
ARCHS = ("mimd-scalar", "mimd-simt", "hbmpim")


def test_pathfind_arch_rows_match(monkeypatch):
    stand_in(monkeypatch, mapping={"GEMVS": "RED", "BFS": "RED"})
    ref = load("benchmarks/pathfind_arch.py")
    twin = load("benchmarks/pathfind_arch.py", twin=True)
    got = twin.compare(SCALE, device="cpu")
    assert rows_modeled(got, "pathfind_arch") == \
        rows_modeled(ref.compare(SCALE), "pathfind_arch")
    assert [(r["arch"], r["workload"]) for r in got] == [
        (a, w) for a in ARCHS for w in ("GEMVS", "BFS")]
    got = twin.replay_sweep(SCALE, device="cpu")
    assert rows_modeled(got, "pathfind_arch") == \
        rows_modeled(ref.replay_sweep(SCALE), "pathfind_arch")
    assert len(got) == 9 and all(r["replay_speedup"] > 0 for r in got)


def test_pim_arch_compare_lines_match(monkeypatch):
    stand_in(monkeypatch, mapping={"GEMVS": "RED", "BFS": "RED"})
    ref, got = main_lines("examples/pim_arch_compare.py",
                          ["--scale", str(SCALE)])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert [line.split()[0] for line in lines[2:5]] == list(ARCHS)
    assert any(line.startswith("live run: ") and "*s wall" in line
               for line in lines)
    assert lines[-1] == "unchanged-config replay: bit-exact vs live timeline"
