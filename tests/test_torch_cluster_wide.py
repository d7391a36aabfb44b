"""The cluster at chip_smoke.py [cluster] (b)'s width (8 ranks of 32
DPUs, the four-tenant mix of benchmarks/cluster_load.py, 2 spare ranks)
on both packages, fed the same job profiles: the ones the card measured
on a 32-DPU, 8-tasklet rank at scale 0.375
(tests/data/cluster_profiles_wide.json, written by
tools/torch_cluster_profiles.py; [cluster] (b) holds its own measurement
against it).  Both policies at 0 and 2% permanent DPU faults give equal
reports, and the reference's own policy explains why fault_aware
completes fewer jobs there than first_fit: ``health_floor`` (0.5) retires
a 32-DPU rank once 17 of its DPUs are dead, so every rank and spare is
retired while a third of the fleet still works, and the jobs left fail
as unplaceable (a 4-DPU rank retires only at 3 of 4 dead)."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.cluster as ref_cluster  # noqa: E402
from repro.core.config import DPUConfig as RefConfig  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro.faults.model import FaultPlan as RefPlan  # noqa: E402

import repro_torch.cluster as pt_cluster  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.faults.model import FaultPlan  # noqa: E402
from repro_torch.workloads import goldens  # noqa: E402

DATA = Path(__file__).with_name("data") / "cluster_profiles_wide.json"
#: chip_smoke.py CLUSTER_FULL_SYSTEM
SYSTEM = dict(n_dpus=256, n_ranks=8, n_channels=4, mram_bytes=1 << 20)
PACKAGES = {"repro": (ref_cluster, RefConfig, RefSystem, RefPlan, {}),
            "repro_torch": (pt_cluster, DPUConfig, PIMSystem, FaultPlan,
                            {"device": "cpu"})}


def _profiles(cluster) -> dict:
    rec = json.loads(DATA.read_text())
    assert rec["rank"] == dict(n_dpus=32, n_threads=8, scale=0.375, seed=0,
                               mram_bytes=1 << 21)
    return {kind: cluster.JobProfile(kind, tuple(
        cluster.JobStep(phase, seconds=sec, bytes_per_dpu=per_dpu,
                        nbytes=nbytes, label=label)
        for phase, label, sec, per_dpu, nbytes in steps))
        for kind, steps in rec["profiles"].items()}


def _run(package: str, policy: str, rate: float, dpus_per_rank: int = 32):
    """(cluster, report, system) of one run of goldens.CLUSTER's mix on
    ``package`` at 8 ranks of ``dpus_per_rank`` DPUs."""
    cluster, config_cls, system_cls, plan_cls, kw = PACKAGES[package]
    c = goldens.CLUSTER
    tenants = [cluster.TenantSpec(**t) for t in c["tenants"]]
    jobs = cluster.poisson_stream(tenants, horizon=c["horizon"],
                                  seed=c["seed"])
    faults = (plan_cls(seed=c["fault_seed"], p_dpu_permanent=rate)
              if rate > 0 else None)
    system = system_cls(config_cls(**dict(
        SYSTEM, n_dpus=SYSTEM["n_ranks"] * dpus_per_rank)), mode=c["mode"],
        faults=faults, **kw)
    cl = cluster.PimCluster(system, policy=policy,
                            spare_ranks=c["spare_ranks"],
                            profiles=_profiles(cluster))
    return cl, cl.run(jobs), system


def _report(rep) -> dict:
    return json.loads(json.dumps(goldens.cluster_report(rep)))


@pytest.mark.parametrize("rate", goldens.CLUSTER["rates"])
@pytest.mark.parametrize("policy", goldens.CLUSTER["policies"])
def test_wide_cluster_matches_reference(policy, rate):
    got = _report(_run("repro_torch", policy, rate)[1])
    want = _report(_run("repro", policy, rate)[1])
    assert got == want
    assert got["metrics"]["jobs"] == 105
    if rate == 0:
        assert got["metrics"]["completed"] == 105


def test_fault_aware_retires_every_rank_while_dpus_live():
    """At 2% the reference's fault_aware retires all 8 ranks (the 2
    spares promoted and retired too) with DPUs still alive, and each job
    it fails is unplaceable; first_fit, blind to health, runs on the
    degraded ranks and completes more.  At 4-DPU ranks the same stream
    keeps fault_aware ahead (its ranks retire later)."""
    cl, rep, system = _run("repro", "fault_aware", 0.02)
    failed = [o for o in rep.outcomes if o.status == "failed"]
    assert sorted(cl.retired) == list(range(8)) and not cl.schedulable
    assert failed and {o.reason for o in failed} == {"unplaceable"}
    first_fit = _run("repro", "first_fit", 0.02)[1]
    done = {"fault_aware": rep.metrics()["completed"],
            "first_fit": first_fit.metrics()["completed"]}
    # the card's [cluster] (b) run: 14 of 105 (first_fit 39), all 8 ranks
    # retired after 58 kernel launches with 81 of 256 DPUs alive
    assert done == {"fault_aware": 14, "first_fit": 39}, done
    assert int(system.active_mask.sum()) == 81
    narrow = {p: _run("repro", p, 0.02, dpus_per_rank=4)[1]
              .metrics()["completed"] for p in done}
    assert narrow["fault_aware"] > narrow["first_fit"], narrow
