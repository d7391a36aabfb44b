"""The port's remap recovery on HST-S against the JAX package on the
CPU: with DPU 1 dead from the first launch its shard runs on the
survivor and the histogram merge re-roots; reports, fault logs,
Timelines and states are identical and the oracle passes in both."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.faults import FaultPlan as RefPlan  # noqa: E402
from repro.faults import kill_dpu as ref_kill  # noqa: E402
from repro_torch.faults import FaultPlan as PtPlan  # noqa: E402
from repro_torch.faults import kill_dpu as pt_kill  # noqa: E402
from test_torch_workloads import _same_run, _small_cfg  # noqa: E402


def test_killed_dpu_remap_matches_reference():
    plans = {"faults": (RefPlan(events=(ref_kill(1, 0),)),
                        PtPlan(events=(pt_kill(1, 0),)))}
    # one tasklet: HST-S's per-tasklet bins make it cheapest there
    pt_sys = _same_run("HST-S", _small_cfg(1), 1, scale=0.001, **plans)
    assert not pt_sys.active_mask[1]
    assert any(r.kind == "permanent" and 1 in r.dpus
               for r in pt_sys.fault_log)
