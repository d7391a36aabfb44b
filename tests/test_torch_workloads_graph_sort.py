"""The port's BFS (one launch per level, frontiers merged through the
port's comm) and SSORT (two launches, reads N_DPUS, alltoall) against
the JAX package on the CPU: identical KernelReport, Timeline and final
state, at 2 DPUs and the smallest size each allows.  NW, the other graph
workload, has a file of its own."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


@pytest.mark.parametrize("name,threads", [("BFS", 16), ("SSORT", 4)])
def test_report_timeline_state_match_reference(name, threads):
    _same_run(name, _small_cfg(threads), threads, scale=0.001)
