"""The port's cluster runtime (``repro_torch.cluster``: arrivals,
placement, preemption, fault-driven rescheduling, leases, SLO metrics)
against the JAX package, on the CPU.

Every scenario of tests/test_cluster.py runs through both packages on
the same seeded streams and fault plans; every ``ClusterReport`` field
and metric (``goldens.cluster_report``) must be identical (tolerance
0).  The measured profiles (``measure_profile``: the real workload on a
reference rank) are held against the JAX package in
tests/test_torch_cluster_profiles.py; the cluster goldens
(``goldens.CLUSTER``) here, and on the card in ``chip_smoke.py``
[cluster]."""
import dataclasses
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.cluster as j_cluster  # noqa: E402
import repro.faults.model as j_faults  # noqa: E402
from repro.core.config import DPUConfig as JDPUConfig  # noqa: E402
from repro.core.host import PIMSystem as JPIMSystem  # noqa: E402
from repro.serve.pim_pool import PimDecodePool as JPool  # noqa: E402
import repro_torch.cluster as t_cluster  # noqa: E402
import repro_torch.faults.model as t_faults  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.serve.pim_pool import PimDecodePool  # noqa: E402
from repro_torch.workloads import goldens  # noqa: E402
from repro_torch.workloads.goldens import cluster_report  # noqa: E402

JAX = SimpleNamespace(cl=j_cluster, faults=j_faults, cfg=JDPUConfig,
                      pool=JPool,
                      system=lambda cfg, **kw: JPIMSystem(cfg, **kw))
PORT = SimpleNamespace(cl=t_cluster, faults=t_faults, cfg=DPUConfig,
                       pool=PimDecodePool,
                       system=lambda cfg, **kw: PIMSystem(cfg, device="cpu",
                                                          **kw))


def both(fn):
    """``fn(package)`` for the JAX package and the port: must be equal;
    returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


def _sys(p, D=32, ranks=8, chans=4, mode="async", faults=None):
    return p.system(p.cfg(n_dpus=D, n_ranks=ranks, n_channels=chans,
                          mram_bytes=1 << 20), mode=mode, faults=faults)


def _tenants(p):
    return [
        p.cl.TenantSpec("graph", rate_hz=400.0, kinds=("BFS",), n_ranks=2,
                        priority=1, slo_seconds=0.05),
        p.cl.TenantSpec("sort", rate_hz=300.0, kinds=("SSORT", "HST-S")),
        p.cl.TenantSpec("lm", rate_hz=200.0, kinds=("lm_decode",), size=6,
                        n_ranks=2, priority=2, slo_seconds=0.02),
    ]


def _jobs(js):
    return [dataclasses.astuple(j) for j in js]


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11, 12])
def test_poisson_stream_identical(seed):
    got = both(lambda p: _jobs(p.cl.poisson_stream(_tenants(p), horizon=0.05,
                                                   seed=seed)))
    assert [j[0] for j in got] == list(range(len(got)))


def test_poisson_stream_per_tenant_streams_independent():
    def run(p):
        base = p.cl.poisson_stream(_tenants(p)[:2], horizon=0.05, seed=3)
        more = p.cl.poisson_stream(_tenants(p), horizon=0.05, seed=3)
        key = lambda js: sorted((j.tenant, j.arrival, j.kind, j.size)  # noqa
                                for j in js)
        assert key(j for j in more if j.tenant != "lm") == key(base)
        return _jobs(more)
    both(run)


def test_trace_roundtrip(tmp_path):
    def run(p):
        jobs = p.cl.poisson_stream(_tenants(p), horizon=0.03, seed=5)
        path = tmp_path / f"{p is PORT}.jsonl"
        p.cl.save_trace(str(path), jobs)
        assert p.cl.trace_stream(str(path)) == jobs
        return path.read_bytes()
    both(run)


@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_spec_validation(p):
    for make in (lambda: p.cl.JobSpec(jid=0, tenant="t", kind="NOPE",
                                      arrival=0.0),
                 lambda: p.cl.JobSpec(jid=0, tenant="t", kind="BFS",
                                      arrival=0.0, size=0.0),
                 lambda: p.cl.TenantSpec("t", rate_hz=0.0),
                 lambda: p.cl.TenantSpec("t", rate_hz=1.0, kinds=("BFS",),
                                         kind_weights=(1.0, 2.0))):
        with pytest.raises(ValueError):
            make()


# ---------------------------------------------------------------------------
# the full cluster run
# ---------------------------------------------------------------------------

def _report(p, mode, faults=None, policy="fault_aware", horizon=0.05):
    jobs = p.cl.poisson_stream(_tenants(p), horizon=horizon, seed=7)
    return cluster_report(p.cl.PimCluster(
        _sys(p, mode=mode, faults=faults(p) if faults else None),
        policy=policy, spare_ranks=2).run(jobs))


@pytest.mark.parametrize("policy", ["first_fit", "best_fit", "fault_aware"])
def test_fault_free_identical_and_goodput_exactly_one(policy):
    a = both(lambda p: _report(p, "async", policy=policy))
    b = both(lambda p: _report(p, "inorder", policy=policy))
    assert a == b
    m = a["metrics"]
    assert m["failed"] == 0 and m["completed"] == m["jobs"]
    assert a["goodput"] == 1.0 and 0.0 < a["utilization"] <= 1.0


def test_under_faults_identical_across_modes():
    mk = lambda p: p.faults.FaultPlan(seed=3, p_dpu_permanent=0.02)  # noqa
    assert both(lambda p: _report(p, "inorder", faults=mk)) \
        == both(lambda p: _report(p, "async", faults=mk))


def test_fault_aware_beats_first_fit_goodput_at_2pct():
    mk = lambda p: p.faults.FaultPlan(seed=1, p_dpu_permanent=0.02)  # noqa
    fa = both(lambda p: _report(p, "async", faults=mk, horizon=0.08))
    ff = both(lambda p: _report(p, "async", faults=mk, policy="first_fit",
                                horizon=0.08))
    assert ff["goodput"] < fa["goodput"] < 1.0


def test_first_fit_and_unplaceable():
    def run(p):
        jobs = [p.cl.JobSpec(jid=0, tenant="a", kind="BFS", arrival=0.0,
                             n_ranks=2),
                p.cl.JobSpec(jid=1, tenant="b", kind="BFS", arrival=0.0,
                             n_ranks=3),
                p.cl.JobSpec(jid=2, tenant="c", kind="BFS", arrival=0.0,
                             n_ranks=99)]
        return cluster_report(p.cl.PimCluster(_sys(p),
                                              policy="first_fit").run(jobs))
    rep = both(run)
    assert [a[2] for a in rep["admissions"]] == [[0, 1], [2, 3, 4]]
    assert rep["outcomes"][2][6] == "failed"


@pytest.mark.parametrize("preemption", [True, False])
def test_preemption_at_step_boundary(preemption):
    def run(p):
        jobs = [p.cl.JobSpec(jid=0, tenant="batch", kind="SSORT",
                             arrival=0.0, size=4.0, n_ranks=8, priority=0),
                p.cl.JobSpec(jid=1, tenant="urgent", kind="HST-S",
                             arrival=1e-4, n_ranks=4, priority=5)]
        return cluster_report(p.cl.PimCluster(
            _sys(p), policy="first_fit", preemption=preemption).run(jobs))
    rep = both(run)
    preempts = rep["outcomes"][0][14]
    assert (preempts >= 1) if preemption else preempts == 0


def _rank0_kill_plan(p, D=16, ranks=4, at_launch=2):
    per = D // ranks
    return p.faults.FaultPlan(events=tuple(p.faults.kill_dpu(d, at_launch)
                                           for d in range(per)))


@pytest.mark.parametrize("policy", ["fault_aware", "first_fit"])
def test_lm_replica_on_a_dying_rank(policy):
    def run(p):
        jobs = [p.cl.JobSpec(jid=0, tenant="lm", kind="lm_decode",
                             arrival=0.0, size=6, n_ranks=1)]
        system = _sys(p, D=16, ranks=4, chans=2,
                      faults=_rank0_kill_plan(p))
        rep = p.cl.PimCluster(system, policy=policy).run(jobs)
        return cluster_report(rep), system.timeline.events
    rep, _ = both(run)
    status, reschedules = rep["outcomes"][0][6], rep["outcomes"][0][13]
    if policy == "fault_aware":
        assert status == "completed" and reschedules == 1
    else:
        assert status == "failed" and rep["goodput"] == 0.0


def test_fault_aware_placement_skips_degraded_rank():
    def run(p):
        system = _sys(p, D=16, ranks=4, chans=2,
                      faults=_rank0_kill_plan(p, at_launch=0))
        jobs = [p.cl.JobSpec(jid=0, tenant="a", kind="HST-S", arrival=0.0),
                p.cl.JobSpec(jid=1, tenant="a", kind="HST-S", arrival=1e-3)]
        return cluster_report(p.cl.PimCluster(
            system, policy="fault_aware").run(jobs))
    rep = both(run)
    assert all(0 not in ranks for jid, _, ranks in rep["admissions"]
               if jid == 1)


@pytest.mark.parametrize("policy", ["fault_aware", "first_fit"])
def test_spare_promotion_only_under_fault_aware(policy):
    def run(p):
        plan = p.faults.FaultPlan(events=tuple(p.faults.kill_dpu(d, 0)
                                               for d in range(4)))
        jobs = [p.cl.JobSpec(jid=j, tenant="a", kind="HST-S", arrival=0.0)
                for j in range(6)]
        return cluster_report(p.cl.PimCluster(
            _sys(p, D=20, ranks=5, faults=plan), policy=policy,
            spare_ranks=1).run(jobs))
    rep = both(run)
    on_spare = any(4 in ranks for _, _, ranks in rep["admissions"])
    assert on_spare == (policy == "fault_aware")


# ---------------------------------------------------------------------------
# serving leases
# ---------------------------------------------------------------------------

def test_lease_release_relocate():
    def run(p):
        cluster = p.cl.PimCluster(_sys(p, D=16, ranks=4, chans=2),
                                  policy="fault_aware")
        lease = cluster.lease("svc", n_ranks=2)
        out = [lease.ranks, lease.pool.ranks, lease.pool.tick()]
        moved = cluster.relocate(lease)
        out += [lease.active, moved.active, moved.ranks]
        cluster.release(moved)
        wide = cluster.lease("svc", n_ranks=4)
        out.append(wide.ranks)
        cluster.release(wide)
        with pytest.raises(p.faults.DpuFaultError):
            cluster.lease("svc", n_ranks=5)
        out.append(cluster_report(cluster.report))
        return out, cluster.system.timeline.events
    out, events = both(run)
    assert out[0] == (0, 1) and out[6] == (0, 1, 2, 3)
    assert events and events[0][0] == "kernel"


def test_lease_double_and_stale_release():
    def run(p):
        cluster = p.cl.PimCluster(_sys(p, D=16, ranks=4, chans=2),
                                  policy="first_fit")
        a = cluster.lease("a", n_ranks=2)
        cluster.release(a)
        cluster.release(a)
        b = cluster.lease("b", n_ranks=2)
        cluster.release(a)
        with pytest.raises(p.faults.DpuFaultError):
            cluster.lease("c", n_ranks=3)
        cluster.release(b)
        return cluster.lease("d", n_ranks=4).ranks
    assert both(run) == (0, 1, 2, 3)


def test_pool_healthy_fraction_is_subset_scoped():
    def run(p):
        s = _sys(p, D=16, ranks=4, chans=2)
        s.active_mask[8:] = False
        pool, fleet = p.pool(s, ranks=[0, 1]), p.pool(s)
        out = [pool.healthy_fraction, fleet.healthy_fraction]
        s.active_mask[0:2] = False
        return out + [pool.healthy_fraction]
    assert both(run) == [1.0, 0.5, 0.75]


def test_single_shot_policy_and_profiles():
    def run(p):
        cluster = p.cl.PimCluster(_sys(p), policy="first_fit")
        cluster.run([])
        with pytest.raises(RuntimeError):
            cluster.run([])
        with pytest.raises(ValueError):
            p.cl.PimCluster(_sys(p), policy="round_robin")
        profs = p.cl.synthetic_profiles()
        return {k: [dataclasses.astuple(s) for s in v.plan(2.0)]
                for k, v in profs.items()}
    assert set(both(run)) == {"BFS", "HST-S", "SSORT"}


def test_measure_profile_runs_on_the_systems_device(monkeypatch):
    """A cluster measures its profiles on its own system's device, and the
    cache keys on the device."""
    from repro_torch.cluster import scheduler
    seen = []

    def fake_run(self, system, n_threads, scale, seed):
        seen.append(system.device)
        system.timeline.add("kernel", 1e-4, "X")
        return {}, None

    from repro_torch.workloads.base import Workload
    monkeypatch.setattr(Workload, "run", fake_run)
    monkeypatch.setattr(scheduler, "_MEASURED_CACHE", {})
    cluster = t_cluster.PimCluster(_sys(PORT), profiles="measured",
                                   profile_scale=0.01)
    prof = cluster._profile("HST-S")
    assert [str(d) for d in seen] == ["cpu"] * 3
    assert prof.steps[0].seconds == 1e-4
    assert {k[-1] for k in scheduler._MEASURED_CACHE} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_cluster.measure_profile("HST-S", n_dpus=4, scale=0.01)


# ---------------------------------------------------------------------------
# the cluster goldens (chip_smoke.py [cluster] (a))
# ---------------------------------------------------------------------------

def _golden_profiles(gold):
    return {k: t_cluster.JobProfile(k, tuple(
        t_cluster.JobStep(phase, seconds, per, nbytes, label)
        for phase, label, seconds, per, nbytes in steps))
        for k, steps in gold["profiles"].items()}


@pytest.mark.parametrize("key", [goldens.cluster_key(p, r)
                                 for r in goldens.CLUSTER["rates"]
                                 for p in goldens.CLUSTER["policies"]])
def test_cluster_golden_from_its_profiles(key):
    """The port's cluster run of goldens.CLUSTER, fed the golden measured
    profiles, equals the JAX package's run in goldens.json."""
    gold = goldens.load()["cluster"]
    policy, rate = key.split("@")
    c = goldens.CLUSTER
    jobs = t_cluster.poisson_stream([t_cluster.TenantSpec(**kw)
                                     for kw in c["tenants"]],
                                    horizon=c["horizon"], seed=c["seed"])
    faults = (t_faults.FaultPlan(seed=c["fault_seed"],
                                 p_dpu_permanent=float(rate))
              if float(rate) > 0 else None)
    system = PIMSystem(DPUConfig(**c["system"]), mode=c["mode"],
                       faults=faults, device="cpu")
    rep = t_cluster.PimCluster(system, policy=policy,
                               spare_ranks=c["spare_ranks"],
                               profiles=_golden_profiles(gold)).run(jobs)
    got = json.loads(json.dumps(goldens.cluster_report(rep)))
    assert got == gold["runs"][key]


def test_cluster_golden_bfs_profile_measured_on_cpu():
    """BFS measured at goldens.CLUSTER's rank (4 DPUs, 8 tasklets, scale
    0.05) on the CPU equals its golden profile (HST-S and SSORT at that
    size take 90-120 s each on the CPU: the card holds them, chip_smoke.py
    [cluster] (a))."""
    from repro_torch.cluster import scheduler
    gold = goldens.load()["cluster"]["profiles"]["BFS"]
    c = goldens.CLUSTER
    prof = scheduler.measure_profile(
        "BFS", n_dpus=c["system"]["n_dpus"] // c["system"]["n_ranks"],
        scale=c["profile_scale"], device="cpu")
    assert goldens.profile_steps(prof) == gold
