"""The port's admission stack (``repro_torch.admission``: token buckets,
hedged launches, circuit breakers, the crash-consistent journal) against
the JAX package, on the CPU.

Every scenario of tests/test_admission.py runs through both packages on
the same seeded job streams and fault plans; the results must be
identical (tolerance 0): every ``ClusterReport`` field and metric
(``goldens.cluster_report``), the breakers' verdicts, the journal's lines
byte for byte, a killed-and-resumed run's report.  The serving engine's
admission scenarios (capacity, queue bound, deadline shedding) are held
against the JAX package in tests/test_torch_models.py."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.admission as j_admission  # noqa: E402
import repro.cluster as j_cluster  # noqa: E402
import repro.faults.model as j_faults  # noqa: E402
import repro.faults.retry as j_retry  # noqa: E402
from repro.core.config import DPUConfig as JDPUConfig  # noqa: E402
from repro.core.host import PIMSystem as JPIMSystem  # noqa: E402
import repro_torch.admission as t_admission  # noqa: E402
import repro_torch.cluster as t_cluster  # noqa: E402
import repro_torch.faults.model as t_faults  # noqa: E402
import repro_torch.faults.retry as t_retry  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.workloads.goldens import cluster_report  # noqa: E402

JAX = SimpleNamespace(adm=j_admission, cl=j_cluster, faults=j_faults,
                      retry=j_retry, cfg=JDPUConfig,
                      system=lambda cfg, **kw: JPIMSystem(cfg, **kw))
PORT = SimpleNamespace(adm=t_admission, cl=t_cluster, faults=t_faults,
                       retry=t_retry, cfg=DPUConfig,
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


def _burst(p, n, tenant="t", kind="HST-S", n_ranks=1, slo=np.inf,
           spacing=0.0):
    return [p.cl.JobSpec(jid=j, tenant=tenant, kind=kind,
                         arrival=j * spacing, n_ranks=n_ranks,
                         slo_seconds=slo) for j in range(n)]


def _run(p, jobs, **kw):
    cluster = p.cl.PimCluster(_sys(p, mode=kw.pop("mode", "async"),
                                   faults=kw.pop("faults", None)),
                              policy=kw.pop("policy", "first_fit"), **kw)
    return cluster_report(cluster.run(jobs(p)))


# ---------------------------------------------------------------------------
# policy objects
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_policy_validation(p):
    bad = [lambda: p.adm.AdmissionPolicy(max_queue=0),
           lambda: p.adm.AdmissionPolicy(rate_limits={"t": (0.0, 4.0)}),
           lambda: p.adm.AdmissionPolicy(rate_limits={"t": (10.0, 0.5)}),
           lambda: p.adm.HedgePolicy(factor=1.0),
           lambda: p.adm.CircuitBreaker(min_samples=8, window=4),
           lambda: p.adm.CircuitBreaker(trip_rate=0.0),
           lambda: p.adm.TokenBucket(rate_hz=5.0, burst=0.5)]
    for make in bad:
        with pytest.raises(ValueError):
            make()


def test_token_bucket_is_pure_function_of_query_times():
    def run(p):
        b = p.adm.TokenBucket(rate_hz=10.0, burst=2.0)
        out = [b.try_take(0.0), b.try_take(0.0), b.try_take(0.0),
               b.retry_after(), b.try_take(0.05), b.try_take(0.1),
               b.try_take(0.05), b.tokens]
        return out
    got = both(run)
    assert got[:3] == [True, True, False] and got[3] == pytest.approx(0.1)
    assert got[4:7] == [False, True, False]


def test_empty_policy_admits_everything():
    rep = both(lambda p: _run(p, lambda p: _burst(p, 6),
                              admission=p.adm.AdmissionPolicy()))
    assert all(o[6] == "completed" for o in rep["outcomes"])


# ---------------------------------------------------------------------------
# cluster admission: bounded queue + per-tenant rate limits
# ---------------------------------------------------------------------------

def test_queue_bound_rejects_typed_and_free():
    rep = both(lambda p: _run(p, lambda p: _burst(p, 12, n_ranks=8),
                              admission=p.adm.AdmissionPolicy(max_queue=2)))
    assert rep["metrics"]["rejected"] == 9 and rep["metrics"]["completed"] == 3
    assert rep["goodput"] == 1.0


def test_rate_limit_rejects_only_the_offending_tenant():
    def jobs(p):
        return sorted(_burst(p, 6, tenant="greedy")
                      + [p.cl.JobSpec(jid=10 + j, tenant="calm", kind="BFS",
                                      arrival=j * 1e-5) for j in range(3)],
                      key=lambda s: (s.arrival, s.jid))
    rep = both(lambda p: _run(p, jobs, admission=p.adm.AdmissionPolicy(
        rate_limits={"greedy": (100.0, 2.0)})))
    assert rep["tenants"]["greedy"]["rejected"] == 4
    assert rep["tenants"]["calm"]["completed"] == 3


def test_backpressure_snapshot():
    def run(p):
        pol = p.adm.AdmissionPolicy(max_queue=4,
                                    rate_limits={"t": (50.0, 3.0)})
        return p.cl.PimCluster(_sys(p), policy="first_fit",
                               admission=pol).backpressure()
    bp = both(run)
    assert bp == {"queue_depth": 0, "max_queue": 4, "quarantined": [],
                  "tokens": {"t": 3.0}}


# ---------------------------------------------------------------------------
# deadline shedding
# ---------------------------------------------------------------------------

def test_shedding_drops_doomed_jobs_early():
    jobs = lambda p: _burst(p, 8, n_ranks=8, slo=2e-3)  # noqa: E731
    fifo = both(lambda p: _run(p, jobs))
    shed = both(lambda p: _run(p, jobs, shedding=True))
    assert fifo["metrics"]["shed"] == 0 and shed["metrics"]["shed"] > 0
    assert shed["metrics"]["slo_goodput"] >= fifo["metrics"]["slo_goodput"]


def test_slo_goodput_bounded_by_goodput():
    rep = both(lambda p: _run(p, lambda p: _burst(p, 8, n_ranks=8,
                                                  slo=2e-3)))
    assert rep["metrics"]["slo_goodput"] <= rep["metrics"]["goodput"] + 1e-12
    easy = both(lambda p: _run(p, lambda p: _burst(p, 2)))
    assert easy["metrics"]["slo_goodput"] == 1.0


def test_scale_rates():
    def run(p):
        tenants = [p.cl.TenantSpec("a", rate_hz=100.0, kinds=("BFS",)),
                   p.cl.TenantSpec("b", rate_hz=40.0, kinds=("HST-S",))]
        up = p.cl.scale_rates(tenants, 1.5)
        with pytest.raises(ValueError):
            p.cl.scale_rates(tenants, 0.0)
        return [dataclasses.astuple(t) for t in up + tenants]
    got = both(run)
    assert [t[1] for t in got] == [150.0, 60.0, 100.0, 40.0]


# ---------------------------------------------------------------------------
# hedged launches
# ---------------------------------------------------------------------------

def _hedge_jobs(p):
    tenants = [p.cl.TenantSpec("a", rate_hz=150.0, kinds=("BFS",),
                               slo_seconds=0.05),
               p.cl.TenantSpec("b", rate_hz=120.0, kinds=("HST-S",),
                               slo_seconds=0.05)]
    return p.cl.poisson_stream(tenants, horizon=0.05, seed=11)


def _hedge_run(p, mode="async", hedge=True):
    faults = p.faults.FaultPlan(seed=3, p_link_degrade=0.25,
                                link_degrade_factor=8.0)
    cluster = p.cl.PimCluster(
        _sys(p, mode=mode, faults=faults), policy="fault_aware",
        hedge=p.adm.HedgePolicy(factor=2.5) if hedge else None)
    rep = cluster.run(_hedge_jobs(p))
    return cluster_report(rep), cluster.system.timeline.shed


def test_hedge_fires_cuts_tail_latency_and_is_cancel_priced():
    (hedged, shed) = both(_hedge_run)
    (plain, plain_shed) = both(lambda p: _hedge_run(p, hedge=False))
    assert hedged["metrics"]["hedges"] > 0 and plain["metrics"]["hedges"] == 0
    assert hedged["metrics"]["p99_latency"] < plain["metrics"]["p99_latency"]
    assert shed > 0.0 and plain_shed == 0.0 and hedged["goodput"] < 1.0


def test_hedge_bit_deterministic_across_modes():
    a = both(lambda p: _hedge_run(p, "inorder"))
    b = both(lambda p: _hedge_run(p, "async"))
    assert a[0] == b[0]


def test_hedge_policy_trigger_and_profile_floor():
    def run(p):
        pol = p.adm.HedgePolicy(factor=2.0, min_seconds=1e-3)
        derived = p.adm.HedgePolicy.from_profile(
            p.cl.synthetic_profiles()["BFS"], quantile=95.0)
        return (pol.trigger(1e-4), pol.trigger(1.0),
                dataclasses.astuple(derived))
    lo, hi, derived = both(run)
    assert lo == 1e-3 and hi == 2.0 and derived[1] > 0.0


def test_retry_worst_case_is_the_hedge_envelope():
    def run(p):
        pol = p.retry.RetryPolicy(max_attempts=3, backoff_seconds=1e-6,
                                  backoff_factor=2.0)
        clipped = p.retry.RetryPolicy(max_attempts=3, backoff_seconds=1e-6,
                                      timeout_seconds=1e-4)
        with pytest.raises(ValueError):
            pol.worst_case_seconds(-1.0)
        return pol.worst_case_seconds(1e-3), clipped.worst_case_seconds(1e-3)
    a, b = both(run)
    assert a == pytest.approx(3e-3 + 3e-6)
    assert b == pytest.approx(1e-3 + 2e-4 + 3e-6)


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

def test_breaker_trip_probe_restore_reopen():
    def run(p):
        br = p.adm.RankBreakers(p.adm.CircuitBreaker(
            window=4, trip_rate=0.5, min_samples=2, cooldown_seconds=1.0),
            n_ranks=2)
        out = [br.record(0, False, 0.0), br.record(0, False, 0.1),
               br.state(0, 0.5), br.quarantined(0, 0.5),
               br.cooldown_until(0), br.quarantined_ranks(0.5),
               br.record(0, True, 0.5), br.cooldown_until(0),
               br.quarantined(0, 1.2), br.state(0, 1.2),
               br.record(0, False, 1.2), br.cooldown_until(0),
               br.record(0, True, 3.3), br.state(0, 3.3),
               br.state(1, 99.0), br.quarantined(1, 99.0)]
        return out
    got = both(run)
    assert got[:4] == [None, "tripped", "open", True]
    assert got[9:11] == ["half_open", "reopened"]
    assert got[12:14] == ["restored", "closed"]


def test_breaker_excludes_rank_from_placement():
    def run(p):
        cluster = p.cl.PimCluster(
            _sys(p, D=16, ranks=4, chans=2), policy="fault_aware",
            breaker=p.adm.CircuitBreaker(min_samples=2, trip_rate=0.5,
                                         cooldown_seconds=10.0))
        for _ in range(3):
            cluster.breakers.record(0, False, 0.0)
        lease = cluster.lease("svc", n_ranks=2)
        moved = cluster.relocate(lease)
        cluster.release(moved)
        return lease.ranks, moved.ranks, cluster.backpressure()
    lease, moved, bp = both(run)
    assert 0 not in lease and 0 not in moved and bp["quarantined"] == [0]


def test_breaker_cluster_run_deterministic_across_modes():
    def run(p, mode):
        faults = p.faults.FaultPlan(seed=3, p_dpu_permanent=0.01,
                                    p_link_degrade=0.1,
                                    link_degrade_factor=6.0)
        return cluster_report(p.cl.PimCluster(
            _sys(p, mode=mode, faults=faults), policy="fault_aware",
            breaker=p.adm.CircuitBreaker(window=8, trip_rate=0.6,
                                         min_samples=4)).run(_hedge_jobs(p)))
    assert both(lambda p: run(p, "inorder")) == both(lambda p: run(p,
                                                                   "async"))


# ---------------------------------------------------------------------------
# crash-consistent journal resume
# ---------------------------------------------------------------------------

def _journal_cluster(p, mode, journal=None, crash_after=None):
    faults = p.faults.FaultPlan(seed=3, p_dpu_permanent=0.01,
                                p_link_degrade=0.1, link_degrade_factor=6.0)
    return p.cl.PimCluster(
        _sys(p, mode=mode, faults=faults), policy="fault_aware",
        admission=p.adm.AdmissionPolicy(max_queue=6), shedding=True,
        hedge=p.adm.HedgePolicy(factor=2.5),
        breaker=p.adm.CircuitBreaker(window=8, trip_rate=0.6,
                                     min_samples=4),
        journal=journal, crash_after=crash_after)


def _journal_jobs(p):
    tenants = [p.cl.TenantSpec("a", rate_hz=500.0, kinds=("BFS", "HST-S"),
                               priority=1, slo_seconds=0.05),
               p.cl.TenantSpec("b", rate_hz=300.0, kinds=("lm_decode",),
                               size=4, slo_seconds=0.04)]
    return p.cl.poisson_stream(tenants, horizon=0.03, seed=11)


@pytest.mark.parametrize("mode", ["inorder", "async"])
@pytest.mark.parametrize("crash_after", [3, 11])
def test_kill_and_resume_bit_identical(tmp_path, mode, crash_after):
    """Each package's resumed run equals its uninterrupted one, the two
    packages' reports are equal, and the journals the two packages wrote
    are equal byte for byte."""
    def run(p):
        jobs = _journal_jobs(p)
        ref = cluster_report(_journal_cluster(p, mode).run(jobs))
        path = tmp_path / f"{p is PORT}.journal"
        with pytest.raises(p.adm.SimulatedCrash):
            _journal_cluster(p, mode, journal=str(path),
                             crash_after=crash_after).run(jobs)
        crashed = path.read_bytes()
        resumed = cluster_report(
            _journal_cluster(p, mode, journal=str(path)).run(jobs))
        assert resumed == ref
        return ref, crashed, path.read_bytes()
    ref, crashed, whole = both(run)
    assert crashed.count(b"\n") == crash_after + 2   # header, run, steps
    assert len(whole) > len(crashed)


def test_uninterrupted_journal_lines_equal(tmp_path):
    def run(p):
        path = tmp_path / f"{p is PORT}.journal"
        cluster = _journal_cluster(p, "async", journal=str(path))
        cluster.lease("svc", n_ranks=2)
        rep = cluster_report(cluster.run(_journal_jobs(p)))
        return rep, path.read_bytes(), p.adm.JOURNAL_VERSION
    rep, lines, version = both(run)
    assert lines.startswith(b'{"type": "header", "version": %d' % version)


def test_resume_with_lease_replays_placement(tmp_path):
    def run(p):
        jobs = _journal_jobs(p)
        ref_cluster = _journal_cluster(p, "async")
        ref_lease = ref_cluster.lease("svc", n_ranks=2)
        ref = cluster_report(ref_cluster.run(jobs))
        path = str(tmp_path / f"{p is PORT}.journal")
        crashed = _journal_cluster(p, "async", journal=path, crash_after=8)
        crashed.lease("svc", n_ranks=2)
        with pytest.raises(p.adm.SimulatedCrash):
            crashed.run(jobs)
        resumed_cluster = _journal_cluster(p, "async", journal=path)
        lease = resumed_cluster.lease("svc", n_ranks=2)
        resumed = cluster_report(resumed_cluster.run(jobs))
        resumed_cluster.release(lease)
        resumed_cluster.release(lease)
        assert lease.ranks == ref_lease.ranks and resumed == ref
        return resumed, lease.ranks
    both(run)


def test_journal_torn_tail_dropped_mid_file_corruption_raises(tmp_path):
    def run(p):
        path = str(tmp_path / f"{p is PORT}.jsonl")
        j = p.adm.ClusterJournal(path)
        j.write({"type": "header", "v": 1})
        j.write({"type": "step", "jid": 0})
        j.close()
        with open(path, "a") as f:
            f.write('{"type": "step", "jid": 1, "del')
        recs = p.adm.ClusterJournal.load(path)
        with open(path, "w") as f:
            f.write('{"type": "header"}\nGARBAGE\n{"type": "step"}\n')
        with pytest.raises(ValueError):
            p.adm.ClusterJournal.load(path)
        return recs, p.adm.ClusterJournal.load(str(tmp_path / "missing"))
    recs, missing = both(run)
    assert [r["type"] for r in recs] == ["header", "step"] and missing == []


def test_resume_detects_divergent_stream(tmp_path):
    def run(p):
        jobs = _journal_jobs(p)
        path = str(tmp_path / f"{p is PORT}.journal")
        with pytest.raises(p.adm.SimulatedCrash):
            _journal_cluster(p, "async", journal=path,
                             crash_after=8).run(jobs)
        other = [dataclasses.replace(j, kind="HST-S") for j in jobs]
        with pytest.raises(RuntimeError) as ei:
            _journal_cluster(p, "async", journal=path).run(other)
        with pytest.raises(ValueError):
            p.cl.PimCluster(_sys(p), policy="first_fit", crash_after=5)
        return str(ei.value)
    assert "journal divergence" in both(run)


def test_all_default_knobs_bit_exact_vs_plain_cluster():
    def run(p):
        jobs = _journal_jobs(p)
        plain = p.cl.PimCluster(_sys(p), policy="fault_aware",
                                spare_ranks=2).run(jobs)
        cluster = p.cl.PimCluster(_sys(p), policy="fault_aware",
                                  spare_ranks=2, admission=None,
                                  shedding=False, hedge=None, breaker=None,
                                  journal=None)
        knobbed = cluster.run(jobs)
        assert cluster_report(plain) == cluster_report(knobbed)
        return cluster_report(knobbed), cluster.system.timeline.shed
    assert both(run)[1] == 0.0
