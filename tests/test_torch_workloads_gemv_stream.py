"""The port's GEMVS against the JAX package on the CPU: its MIMD path
(GEMV's kernel under its own name) and its HBM-PIM path (the native CRF
command stream, on either HBM-PIM backend) give identical KernelReport,
Timeline and final state."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


def test_mimd_path_matches_reference():
    system = _same_run("GEMVS", _small_cfg(16), 16, scale=0.001)
    assert system.timeline.kernel > 0


@pytest.mark.parametrize("backend", ["hbmpim", "hbmpim_cmd"])
def test_hbmpim_path_names_its_roadmap_item(backend):
    """Both HBM-PIM backends take the all-bank CRF path (MAC command
    streams through launch_commands), as in the reference."""
    system = _same_run("GEMVS", _small_cfg(16, backend=backend), 16,
                       scale=0.001)
    assert system.reports and all(r.name.startswith("GEMVS[x")
                                  for r in system.reports)
