"""The overlap twins against their originals on the CPU:
benchmarks/torch_overlap_scaling.py (the pipelined sweep, its table and
gate, the prefetch-depth sweep; RED stands in for VA, at scale 0.001,
tests/_torch_scripts.py) and benchmarks/torch_rank_overlap.py
(engine-free: its defaults whole) give the same rows and printed
lines."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import load, main_lines, stand_in  # noqa: E402

SCALE = 0.001


def test_overlap_scaling_rows_and_main_match(monkeypatch):
    """The pipelined sweep on two ranks (RED in VA's place), its printed
    table and gate, and the prefetch-depth sweep there."""
    stand_in(monkeypatch, mapping={"VA": "RED"})
    argv = ["--scale", str(SCALE), "--ranks", "2", "--batches", "2",
            "--workloads", "VA"]
    ref, got = main_lines("benchmarks/overlap_scaling.py", argv)
    assert got == ref and ref[0] == 0
    assert "strictly below" in ref[1][-1]
    ref_m = load("benchmarks/overlap_scaling.py")
    twin = load("benchmarks/overlap_scaling.py", twin=True)
    kw = dict(ranks=2, depths=(1, 2), n_batches=1)
    got = twin.overlap_depth_sweep(SCALE, device="cpu", **kw)
    assert got == ref_m.overlap_depth_sweep(SCALE, **kw)
    assert [r["buffers"] for r in got] == [1, 2]


def test_rank_overlap_main_and_rows_match():
    """Engine-free: every row and line at the script's defaults."""
    ref, got = main_lines("benchmarks/rank_overlap.py", [])
    assert got == ref and ref[0] == 0
    assert any(line.startswith("best fit 1.67 == shipped default 1.67")
               for line in ref[1])
    ref_m = load("benchmarks/rank_overlap.py")
    twin = load("benchmarks/rank_overlap.py", twin=True)
    for fn in ("rank_overlap", "contention_sweep", "contention_calibration"):
        assert getattr(twin, fn)(0.5, device="cpu") == \
            getattr(ref_m, fn)(0.5), fn
