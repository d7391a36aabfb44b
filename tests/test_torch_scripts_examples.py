"""The single-DPU and pipeline example twins against their originals on
the CPU: examples/torch_pim_characterize.py (threads 1-16 on one DPU) and
examples/torch_pim_async_pipeline.py (the engine-free queue demo, then
the pipelined VA batches) print the reference's lines exactly.  RED
stands in for the workloads (tests/_torch_scripts.py), at scale 0.001;
the communication examples are in test_torch_scripts_examples_comm.py,
the architecture comparison in test_torch_scripts_pathfind.py."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_scripts import main_lines, stand_in  # noqa: E402

SCALE = "0.001"


def test_pim_characterize_lines_match():
    ref, got = main_lines("examples/pim_characterize.py",
                          ["--workload", "RED", "--scale", SCALE])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert [line.split()[0] for line in lines[1:6]] == [
        f"threads={t:2d}".split()[0] for t in (1, 2, 4, 8, 16)]
    assert lines[-1].startswith("TLP time series")


def test_pim_async_pipeline_lines_match(monkeypatch):
    stand_in(monkeypatch, mapping={"VA": "RED"})
    ref, got = main_lines("examples/pim_async_pipeline.py",
                          ["--scale", SCALE, "--batches", "2"])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert lines[0].startswith("== 1. raw queues") and \
        any(line.startswith("serialized sum") for line in lines)
    assert any(line.startswith("Pipelined end-to-end beats") for line in lines)
