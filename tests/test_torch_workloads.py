"""The port's host runtime and streaming workloads (repro_torch.core.host,
repro_torch.workloads) against the JAX package: identical KernelReport,
Timeline and final state, in both queue modes, and the VA-scalar golden
reproduced on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro.faults.model import FaultPlan as RefFaultPlan  # noqa: E402
from repro_torch.core.carry import config_from  # noqa: E402
from repro_torch.core.host import PIMSystem as PtSystem  # noqa: E402
from repro_torch.faults.model import FaultPlan as PtFaultPlan  # noqa: E402

#: tests/test_backend.py GOLDENS["VA-scalar"] (pre-refactor JAX package)
GOLDEN_VA = (5336, 11488, 4.131521235521236e-05, 1.5245714285714286e-05)

TIMELINE = ("h2d", "kernel", "d2h", "inter_dpu", "retry", "shed", "events",
            "elapsed", "total", "end_to_end", "goodput")


def _assert_report(ref, got):
    for f in dataclasses.fields(ref):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(r, np.ndarray):
            assert r.dtype == g.dtype and r.tobytes() == g.tobytes(), f.name
        else:
            assert r == g, (f.name, r, g)


def _assert_timeline(ref, got):
    for name in TIMELINE:
        assert getattr(ref, name) == getattr(got, name), name


def _assert_state(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].tobytes() == np.asarray(got[k]).tobytes(), k


def _cfg():
    return DPUConfig(n_dpus=4, n_ranks=2, n_channels=2, n_tasklets=8,
                     mram_bytes=1 << 16)


def _small_cfg(n_tasklets, n_dpus=2, mram_bytes=1 << 16, **kw):
    """The parity files' system: 2 DPUs on one rank and channel."""
    return DPUConfig(n_dpus=n_dpus, n_ranks=1, n_channels=1,
                     n_tasklets=n_tasklets, mram_bytes=mram_bytes, **kw)


def _same_run(name, cfg, threads, scale, seed=0, **fault_kw):
    """Run workload ``name`` on both packages' CPU systems of ``cfg``
    (``fault_kw``: each package's ``faults=`` plan and ``recovery=``, as
    ``(ref, port)`` pairs) and assert identical KernelReport, Timeline,
    final state and fault log; returns the port's system."""
    ref_kw = {k: v[0] for k, v in fault_kw.items()}
    pt_kw = {k: v[1] for k, v in fault_kw.items()}
    ref_sys = RefSystem(cfg, **ref_kw)
    ref_st, ref_rep = ref_wl.get(name).run(ref_sys, threads, scale=scale,
                                           seed=seed)
    pt_sys = PtSystem(config_from(cfg), device="cpu", **pt_kw)
    pt_st, pt_rep = pt_wl.get(name).run(pt_sys, threads, scale=scale,
                                        seed=seed)
    _assert_report(ref_rep, pt_rep)
    _assert_timeline(ref_sys.timeline, pt_sys.timeline)
    _assert_state(ref_st, pt_st)
    assert [(f.kind, f.dpus, f.launch) for f in ref_sys.fault_log] == \
        [(f.kind, f.dpus, f.launch) for f in pt_sys.fault_log]
    return pt_sys


@pytest.mark.parametrize("mode", ["inorder", "async"])
@pytest.mark.parametrize("name", ["VA", "RED", "SEL", "UNI"])
def test_report_timeline_state_match_reference(name, mode):
    cfg = _cfg()
    ref_sys = RefSystem(cfg, mode=mode)
    ref_st, ref_rep = ref_wl.get(name).run(ref_sys, 8, scale=0.006, seed=1)
    pt_sys = PtSystem(config_from(cfg), mode=mode, device="cpu")
    pt_st, pt_rep = pt_wl.get(name).run(pt_sys, 8, scale=0.006, seed=1)
    if mode == "async":
        ref_sys.sync()
        pt_sys.sync()
        assert pt_sys.timeline.elapsed is not None
    _assert_report(ref_rep, pt_rep)
    _assert_timeline(ref_sys.timeline, pt_sys.timeline)
    _assert_state(ref_st, pt_st)


def test_va_scalar_golden_on_cpu():
    system = PtSystem(config_from(DPUConfig(n_dpus=4, n_ranks=2,
                                            n_channels=2)), device="cpu")
    _, rep = pt_wl.get("VA").run(system, 8, scale=0.02, seed=0)
    assert (rep.cycles, rep.issued, system.timeline.total,
            system.timeline.kernel) == GOLDEN_VA


def test_transient_faults_retry_like_reference():
    """The fault path of PIMSystem.launch (retry, backoff, fault log)."""
    cfg = _cfg()
    plan = dict(seed=5, p_dpu_transient=0.1, flips_per_launch=0.5)
    ref_sys = RefSystem(cfg, faults=RefFaultPlan(**plan), recovery="raise")
    pt_sys = PtSystem(config_from(cfg), faults=PtFaultPlan(**plan),
                      recovery="raise", device="cpu")
    ref_st, ref_rep = ref_wl.get("RED").run(ref_sys, 8, scale=0.006)
    pt_st, pt_rep = pt_wl.get("RED").run(pt_sys, 8, scale=0.006)
    assert ref_sys.fault_log, "the plan should fault at least once"
    assert [f.kind for f in ref_sys.fault_log] == \
        [f.kind for f in pt_sys.fault_log]
    _assert_report(ref_rep, pt_rep)
    _assert_timeline(ref_sys.timeline, pt_sys.timeline)
    _assert_state(ref_st, pt_st)


def test_registry_equals_reference():
    assert sorted(pt_wl.ALL) == sorted(ref_wl.ALL)
    assert len(pt_wl.ALL) == 18
    assert pt_wl.CACHEABLE == ref_wl.CACHEABLE
    for name in ref_wl.ALL:
        assert type(pt_wl.get(name)).__name__ == type(ref_wl.get(name)).__name__
