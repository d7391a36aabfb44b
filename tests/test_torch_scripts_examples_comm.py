"""The communication example twins against their originals on the CPU:
examples/torch_pim_comm_pathfind.py (strong scaling on the host-bounce
and the direct fabric) and examples/torch_pim_sample_sort.py (the three
fabrics) print the reference's lines exactly, their gates included.
HST-L, which exchanges between DPUs, stands in for BFS and SSORT
(tests/_torch_scripts.py), at scale 0.001."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import main_lines, stand_in  # noqa: E402

SCALE = "0.001"


def test_pim_comm_pathfind_lines_match(monkeypatch):
    stand_in(monkeypatch)
    ref, got = main_lines("examples/pim_comm_pathfind.py",
                          ["--ranks", "1", "--scale", SCALE])
    assert got == ref and ref[0] == 0
    assert [line.split()[2] for line in ref[1][2:4]] == ["host", "direct"]
    assert ref[1][-1].startswith("All configurations: direct PIM-PIM "
                                 "fabric strictly reduces")


def test_pim_sample_sort_lines_match(monkeypatch):
    stand_in(monkeypatch)
    ref, got = main_lines("examples/pim_sample_sort.py", ["--scale", SCALE])
    assert got == ref and ref[0] == 0
    assert [line.split()[0] for line in ref[1][2:5]] == [
        "host", "direct", "hier"]
