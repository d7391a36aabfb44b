"""The port's GEMVS against the JAX package on the CPU: its MIMD path
(GEMV's kernel under its own name) gives identical KernelReport,
Timeline and final state; its HBM-PIM path names the module it waits
for."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.workloads as pt_wl  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


def test_mimd_path_matches_reference():
    system = _same_run("GEMVS", _small_cfg(16), 16, scale=0.001)
    assert system.timeline.kernel > 0


@pytest.mark.parametrize("backend", ["hbmpim", "hbmpim_cmd"])
def test_hbmpim_path_names_its_roadmap_item(backend):
    system = PIMSystem(_small_cfg(16, backend=backend), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="modules still to port: core/hbmpim.py"):
        pt_wl.get("GEMVS").run(system, 16, scale=0.001)
