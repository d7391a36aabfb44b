"""The port's GEMV against the JAX package on the CPU: identical
KernelReport, Timeline and final state at 2 DPUs and its smallest size
(96 rows of 64 a DPU, ~63,000 instructions a DPU whatever the tasklet
count; 16 tasklets issue nearly every cycle).  A file of its own: it is
the slowest linear-algebra case on the CPU."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


def test_report_timeline_state_match_reference():
    _same_run("GEMV", _small_cfg(16), 16, scale=0.001)
