"""The port's trace record/replay (``repro_torch.trace``) and run reports
(``repro_torch.obs.report``) against the JAX package, on the CPU.

The scenarios of tests/test_trace.py and the report parts of
tests/test_obs.py run through both packages: a live run's recorded
command stream (every record, and the saved JSONL byte for byte), the
replayed ``Timeline`` under the unchanged configuration (bit-exact
against the live one) and under what-if configurations (another fabric,
channel count or clock), the profile a recording distils into and the
cluster run it drives, and the rendered report text must be identical
(tolerance 0).  A live run here is the port's plain step on the CPU, so
each workload is recorded once per package and shared by the tests."""
import dataclasses
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.cluster as j_cluster  # noqa: E402
import repro.obs as j_obs  # noqa: E402
import repro.obs.report as j_report  # noqa: E402
import repro.trace as j_trace  # noqa: E402
import repro.workloads as j_wl  # noqa: E402
from repro.core.config import DPUConfig as JDPUConfig  # noqa: E402
from repro.core.host import PIMSystem as JPIMSystem  # noqa: E402
from repro.core.stats import KernelReport as JKernelReport  # noqa: E402
import repro_torch.cluster as t_cluster  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
import repro_torch.obs.report as t_report  # noqa: E402
import repro_torch.trace as t_trace  # noqa: E402
import repro_torch.workloads as t_wl  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.core.stats import KernelReport  # noqa: E402
from repro_torch.workloads.goldens import (cluster_report,  # noqa: E402
                                           profile_steps, timeline)

JAX = SimpleNamespace(name="jax", trace=j_trace, wl=j_wl, cfg=JDPUConfig,
                      cl=j_cluster, obs=j_obs, report=j_report,
                      kernel_report=JKernelReport,
                      system=lambda cfg, **kw: JPIMSystem(cfg, **kw))
PORT = SimpleNamespace(name="port", trace=t_trace, wl=t_wl, cfg=DPUConfig,
                       cl=t_cluster, obs=t_obs, report=t_report,
                       kernel_report=KernelReport,
                       system=lambda cfg, **kw: PIMSystem(cfg, device="cpu",
                                                          **kw))
PKGS = (JAX, PORT)


def both(fn):
    """``fn(package)`` for the JAX package and the port: must be equal;
    returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


def _cfg(p, **kw):
    return p.cfg(**{"n_dpus": 4, "n_ranks": 2, "n_channels": 2, **kw})


def _traced_run(p, wl_name, mode):
    system = p.system(_cfg(p), mode=mode)
    rec = p.trace.record(system)
    p.wl.get(wl_name).run(system, 8, scale=0.02, seed=0)
    system.sync()
    return system, rec


#: the live runs the tests share: (workload, queue mode)
RUNS = (("BFS", "async"), ("VA", "inorder"))


@pytest.fixture(scope="module")
def live():
    """{(workload, mode): {package name: (system, recorder)}}"""
    return {run: {p.name: _traced_run(p, *run) for p in PKGS}
            for run in RUNS}


def _assert_bit_exact(live_tl, replayed):
    assert timeline(replayed) == timeline(live_tl)


# ---------------------------------------------------------------------------
# the recording, and the unchanged-config replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_records_identical_and_replay_bit_exact(live, run, tmp_path):
    (js, jrec), (ts, trec) = live[run]["jax"], live[run]["port"]
    assert trec.records == jrec.records
    assert timeline(ts.timeline) == timeline(js.timeline)
    paths = [tmp_path / f"{n}.jsonl" for n in ("jax", "port")]
    assert jrec.save(paths[0]) == trec.save(paths[1]) == len(trec.records)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    for p, rec, system in ((JAX, jrec, js), (PORT, trec, ts)):
        for src in (rec.records, str(paths[1])):
            res = p.trace.replay(src)
            _assert_bit_exact(system.timeline, res.timeline)
            assert res.schedule.makespan == system.last_schedule.makespan


@pytest.mark.parametrize("what", [dict(fabric="direct"), dict(n_channels=1),
                                  dict(freq_mhz=700)],
                         ids=["fabric", "channels", "freq"])
def test_what_if_replay_identical(live, what):
    def run(p):
        _, rec = live[RUNS[0]][p.name]
        res = p.trace.replay(rec.records, cfg=_cfg(p, **what))
        return timeline(res.timeline), res.n_commands
    replayed, n = both(run)
    system, rec = live[RUNS[0]]["port"]
    tl = system.timeline
    assert n == len([r for r in rec.records if r.get("type") == "cmd"])
    if "fabric" in what:
        assert replayed["inter_dpu"] != tl.inter_dpu
        assert replayed["kernel"] == tl.kernel
    elif "n_channels" in what:
        assert replayed["h2d"] == pytest.approx(2 * tl.h2d)
    else:
        assert replayed["kernel"] == pytest.approx(tl.kernel * 350 / 700)
        assert replayed["h2d"] == tl.h2d


def test_replay_rejects_unversioned_garbage():
    def run(p):
        with pytest.raises(ValueError, match="header"):
            p.trace.replay([{"type": "cmd"}])
        with pytest.raises(ValueError, match="version"):
            p.trace.replay([{"type": "header", "version": 99}])
        return p.trace.TRACE_VERSION
    assert both(run) == 1


def _event_ids_from_zero(records):
    """``records`` with their event ids renumbered 0, 1, ... in the order
    they first appear.  An id comes from one counter a process
    (``sched.queue._event_ids``), so its value depends on the events the
    process made before; which command waits on which event does not."""
    ids = {}

    def local(eid):
        return ids.setdefault(eid, len(ids))

    out = []
    for rec in records:
        rec = dict(rec)
        if "eid" in rec:
            rec["eid"] = local(rec["eid"])
        if "waits" in rec:
            rec["waits"] = [local(e) for e in rec["waits"]]
        out.append(rec)
    return out


def test_event_waits_rewired_across_queues():
    def run(p):
        system = p.system(_cfg(p), mode="async")
        rec = p.trace.record(system)
        with system.stream("a"):
            system.h2d(4096.0)
            ev = system.record_event("staged")
        with system.stream("b"):
            system.wait_event(ev)
            system.modeled_launch("k", 1e-4)
        system.sync()
        res = p.trace.replay(rec.records)
        assert res.timeline.elapsed == system.timeline.elapsed
        return (_event_ids_from_zero(rec.records), timeline(res.timeline),
                res.n_commands)
    records, _, n_commands = both(run)
    assert n_commands == 4
    (staged,) = [r for r in records if r.get("eid") is not None]
    assert [r["waits"] for r in records if r.get("waits")] == \
        [[staged["eid"]]]


def test_recorder_detach_and_header_round_trip(tmp_path):
    def run(p):
        system = p.system(_cfg(p, simt_width=4))
        rec = p.trace.record(system)
        system.h2d(1024.0)
        system.recorder = None
        system.h2d(1024.0)
        path = tmp_path / f"{p.name}.jsonl"
        rec.save(path)
        records = p.trace.load(str(path))
        assert p.cfg(**records[0]["cfg"]) == system.cfg
        return records, path.read_bytes()
    records, _ = both(run)
    assert len([r for r in records if r.get("type") == "cmd"]) == 1
    assert json.loads(json.dumps(records[0]))


# ---------------------------------------------------------------------------
# replay-driven cluster profiles
# ---------------------------------------------------------------------------

def test_trace_profile_from_recording(live, tmp_path):
    def run(p):
        _, rec = live[RUNS[0]][p.name]
        path = str(tmp_path / f"{p.name}.trace.jsonl")
        rec.save(path)
        prof = p.cl.trace_profile(path, kind="BFS")
        profs = p.cl.trace_profiles({"BFS": rec.records})
        system = p.system(p.cfg(n_dpus=32, n_ranks=8, n_channels=4,
                                mram_bytes=1 << 20), mode="async")
        rep = p.cl.PimCluster(system, policy="first_fit",
                              profiles={"BFS": prof}).run(
            [p.cl.JobSpec(jid=0, tenant="t", kind="BFS", arrival=0.0)])
        with pytest.raises(ValueError):
            p.cl.trace_profile([], kind="empty")
        assert profile_steps(profs["BFS"]) == profile_steps(prof)
        return profile_steps(prof), cluster_report(rep)
    steps, rep = both(run)
    assert any(s[0] == "kernel" for s in steps)
    assert rep["outcomes"][0][6] == "completed"


# ---------------------------------------------------------------------------
# the report CLI
# ---------------------------------------------------------------------------

def _render(p, argv, capsys):
    assert p.report.main(argv) == 0
    return capsys.readouterr().out


def test_report_renders_command_trace(live, tmp_path, capsys):
    def run(p):
        _, rec = live[RUNS[0]][p.name]
        path = tmp_path / f"{p.name}.jsonl"
        rec.save(path)
        return _render(p, [str(path), "--top", "3"], capsys)
    out = both(run)
    for needle in ("command trace v1", "phase breakdown", "re-priceable"):
        assert needle in out


def _pipeline(system, stages=3):
    """tests/test_obs.py's modeled pipeline: per stage an h2d, a kernel
    on a rank pair, a collective and a d2h, on alternating streams."""
    for i in range(stages):
        ranks = [(2 * i) % 4, (2 * i + 1) % 4]
        with system.stream(f"s{i % 2}"):
            system.h2d(4096, label=f"in{i}")
            system.modeled_launch(f"k{i}", 2e-4, ranks=ranks)
            system.collective("allreduce", 1e-4, 2048.0, ranks=ranks)
            system.d2h(2048, label=f"out{i}")
    system.sync()


def _kernel_report(p, name):
    import numpy as np
    return p.kernel_report(
        name=name, n_dpus=4, n_threads=8, cycles=1000, issued=800,
        active_cycles=800, idle_mem=150, idle_rev=30, idle_rf=20,
        cls_counts={"alu": 800}, hist=np.array([0.0, 4.0]),
        ts=np.zeros((4, 1)), dma_rd_bytes=16000.0, dma_wr_bytes=8000.0,
        row_hit=10, row_miss=2, tlb_hit=5, tlb_miss=1, dc_hit=3, dc_miss=1,
        acq_retry=0, freq_mhz=350, mram_bw_bytes_per_cycle=8.0)


def _cluster_run(p, tracer):
    cfg = p.cfg(n_dpus=32, n_ranks=8, n_channels=4, mram_bytes=1 << 20)
    system = p.system(cfg, mode="async", tracer=tracer)
    tenants = [
        p.cl.TenantSpec("graph", rate_hz=400.0, kinds=("BFS",), n_ranks=2,
                        priority=1, slo_seconds=0.05),
        p.cl.TenantSpec("lm", rate_hz=200.0, kinds=("lm_decode",), size=6,
                        n_ranks=2, priority=2, slo_seconds=0.02)]
    jobs = p.cl.poisson_stream(tenants, horizon=0.04, seed=0)
    cluster = p.cl.PimCluster(system, policy="fault_aware", spare_ranks=2)
    return cluster, cluster.run(jobs)


def test_report_cli_renders_everything(tmp_path, capsys):
    def run(p):
        t = p.obs.Tracer()
        s = p.system(p.cfg(n_dpus=8, n_ranks=4, n_channels=2,
                           mram_bytes=1 << 20), mode="async", tracer=t)
        _pipeline(s)
        prof = p.obs.RunProfile()
        prof.record_report(_kernel_report(p, "va"))
        prof.record_system(s)
        ct = p.obs.Tracer()
        cluster, rep = _cluster_run(p, ct)
        prof.record_cluster(rep)
        tpath = t.save(str(tmp_path / f"{p.name}.trace.json"))
        ppath = prof.save(str(tmp_path / f"{p.name}.counters.json"))
        out = _render(p, [tpath, "--profile", ppath, "--top", "3",
                          "--prometheus"], capsys)
        cpath = tmp_path / f"{p.name}.cluster.json"
        cpath.write_text(json.dumps(cluster.trace))
        cout = _render(p, [str(cpath), "--top", "5"], capsys)
        return (out, cout, open(tpath).read(), open(ppath).read(),
                cpath.read_text())
    out = both(run)[0]
    for needle in ("top 3 spans", "phase breakdown", "exposed",
                   "-- kernels (profile) --", "va", "mram", "compile cache",
                   "per-tenant SLO", "FLEET",
                   "timeline_seconds{phase=kernel}"):
        assert needle in out, f"report missing {needle!r}"


def test_report_helpers_identical():
    spans = [{"name": "a", "phase": "kernel", "start": 0.0, "end": 2.0,
              "busy": 2.0, "wasted": 0.0, "nbytes": 0.0},
             {"name": "b", "phase": "kernel", "start": 1.0, "end": 3.0,
              "busy": 2.0, "wasted": 0.0, "nbytes": 0.0},
             {"name": "c", "phase": "kernel", "start": 5.0, "end": 6.0,
              "busy": 1.0, "wasted": 0.0, "nbytes": 0.0}]

    def run(p):
        t = p.obs.Tracer()
        s = p.system(p.cfg(n_dpus=8, n_ranks=4, n_channels=2,
                           mram_bytes=1 << 20), mode="async", tracer=t)
        _pipeline(s)
        loaded = p.report.load_spans(t.to_chrome_trace())
        return ([p.report.covered(spans, ph) for ph in ("kernel", "h2d")],
                loaded, p.report.render(t.to_chrome_trace(), None, top=4))
    covered, loaded, _ = both(run)
    assert covered == [4.0, 0.0] and loaded


def test_cluster_trace_identical():
    def run(p):
        t = p.obs.Tracer()
        cluster, rep = _cluster_run(p, t)
        jobs = [sp for sp in t.spans(p.obs.PID_CLUSTER)
                if sp.async_id is not None]
        assert len(jobs) == len(rep.outcomes)
        return json.dumps(cluster.trace, sort_keys=True), cluster_report(rep)
    both(run)
    with pytest.raises(RuntimeError):
        _cluster_run(PORT, None)[0].trace
    assert dataclasses.is_dataclass(PORT.cl.JobStep)
