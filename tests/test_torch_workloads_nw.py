"""The port's NW (Needleman-Wunsch: one launch per anti-diagonal of
16 x 16 tiles, tile borders through the host) against the JAX package
on the CPU: identical KernelReport, Timeline and final state, at 2 DPUs
and its smallest size (2 x 2 tiles, 3 launches; one tasklet a tile)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


def test_report_timeline_state_match_reference():
    _same_run("NW", _small_cfg(1), 1, scale=0.001)
