"""The single-DPU and pipeline example twins against their originals on
the CPU: examples/torch_pim_characterize.py (threads 1-16 on one DPU) and
examples/torch_pim_async_pipeline.py (the engine-free queue demo, then
the pipelined VA batches) and examples/torch_pim_offload_planner.py (the
TPU estimate beside the simulated GEMV, the embedding gathers) print the
reference's lines exactly.  RED stands in for the workloads
(tests/_torch_scripts.py), at scale 0.001;
the communication examples are in test_torch_scripts_examples_comm.py,
the architecture comparison in test_torch_scripts_pathfind.py."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
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


class _AtScale:
    """A workload run at :data:`SCALE` whatever scale it is asked for (the
    planner sizes its GEMVs by the model width)."""

    def __init__(self, workload):
        self.workload = workload

    def run(self, system, n_threads, scale, **kw):
        return self.workload.run(system, n_threads, scale=float(SCALE), **kw)


def test_pim_offload_planner_lines_match(monkeypatch):
    for pkg in (ref_wl, pt_wl):
        monkeypatch.setattr(pkg, "get",
                            lambda name, _all=pkg.ALL: _AtScale(_all["RED"]))
    ref, got = main_lines("examples/pim_offload_planner.py", [])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert lines[0].split()[:3] == ["op", "TPU(est)", "PIM(sim)"]
    assert [line.split()[0] for line in lines[1:5]] == [
        "gemv", "gemv", "embed", "embed"]
    assert lines[-1].startswith("finding (matches paper")
