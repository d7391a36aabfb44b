"""SSORT on the port's HBM-PIM compat target against the JAX package on
the CPU (tests/test_hbmpim.py's third compat workload; ~90 s here, so in
a file of its own)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_hbmpim import _cfg, _same_workload  # noqa: E402


@pytest.mark.parametrize("wl_name", ["SSORT"])
def test_workloads_run_unmodified_allbank(wl_name):
    _, rep = _same_workload(wl_name, _cfg(backend="hbmpim"), 8, 0.02, 0)
    assert rep.cycles > 0
