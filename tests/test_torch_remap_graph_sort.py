"""The port's remap recovery on the multi-kernel workloads against the
JAX package on the CPU: BFS (one launch per level) and SSORT (its merge
launch reads N_DPUS, so a re-executed shard needs the ``ndpus_reg``
override) with a DPU killed mid-workload give identical reports, fault
logs, Timelines and states, and pass their oracles."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.faults import FaultPlan as RefPlan  # noqa: E402
from repro.faults import kill_dpu as ref_kill  # noqa: E402
from repro_torch.faults import FaultPlan as PtPlan  # noqa: E402
from repro_torch.faults import kill_dpu as pt_kill  # noqa: E402
from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


@pytest.mark.parametrize("name,threads,dead,launch", [
    ("BFS", 16, 1, 0),
    ("SSORT", 4, 1, 1),
])
def test_killed_dpu_remap_matches_reference(name, threads, dead, launch):
    plans = {"faults": (RefPlan(events=(ref_kill(dead, launch),)),
                        PtPlan(events=(pt_kill(dead, launch),)))}
    pt_sys = _same_run(name, _small_cfg(threads), threads, scale=0.001,
                       **plans)
    assert not pt_sys.active_mask[dead]
    assert any(r.kind == "permanent" and dead in r.dpus
               for r in pt_sys.fault_log)
