"""The port's PIM decode pool (``repro_torch.serve.pim_pool``) against the
JAX package, on the CPU: the pool alone (ticks, the availability floor,
estimates), a ``ServeEngine`` whose pool collapses mid-stream
(tests/test_faults.py:318: no request is lost), and a ``ServeEngine``
on a pool leased from a ``PimCluster`` (examples/serve_lm.py --cluster).

Both packages serve ``llama3-smoke`` in float32 on identical weights
(``params_from_jax``); tokens, engine stats, the pool's ticks, the
system's ``Timeline`` and fault log must be identical (tolerance 0)."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.cluster as j_cluster  # noqa: E402
import repro.faults.model as j_faults  # noqa: E402
import repro.obs as j_obs  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core.config import DPUConfig as JDPUConfig  # noqa: E402
from repro.core.host import PIMSystem as JPIMSystem  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.pim_pool import PimDecodePool as JPool  # noqa: E402
import repro_torch.cluster as t_cluster  # noqa: E402
import repro_torch.faults.model as t_faults  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.pim_pool import PimDecodePool  # noqa: E402
from repro_torch.workloads.goldens import (cluster_report,  # noqa: E402
                                           timeline)

JAX = SimpleNamespace(name="jax", cl=j_cluster, faults=j_faults, obs=j_obs,
                      cfg=JDPUConfig, pool=JPool, engine=JServeEngine,
                      system=lambda cfg, **kw: JPIMSystem(cfg, **kw))
PORT = SimpleNamespace(name="port", cl=t_cluster, faults=t_faults,
                       obs=t_obs, cfg=DPUConfig, pool=PimDecodePool,
                       engine=ServeEngine,
                       system=lambda cfg, **kw: PIMSystem(cfg, device="cpu",
                                                          **kw))


def both(fn):
    """``fn(package)`` for the JAX package and the port: must be equal;
    returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


@pytest.fixture(scope="module")
def models():
    """{package name: (cfg, params or model)} on identical weights."""
    jcfg = j_smoke("llama3-8b").replace(dtype="float32")
    cfg = get_smoke_config("llama3-8b").replace(dtype="float32")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return {"jax": (jcfg, jparams), "port": (cfg, model)}


def _fault_log(system):
    return [(f.kind, f.label, tuple(int(d) for d in f.dpus), f.detail)
            for f in system.fault_log]


def test_pool_ticks_floor_and_estimates():
    def run(p):
        tracer = p.obs.Tracer()
        s = p.system(p.cfg(n_dpus=8, n_tasklets=8, mram_bytes=1 << 21),
                     tracer=tracer)
        pool = p.pool(s, tick_seconds=2e-4, min_fraction=0.5)
        out = [pool.tick(3), pool.estimate(4)]
        s.disable_dpus([0, 1, 2])
        out += [pool.healthy_fraction, pool.tick(1), pool.estimate(2)]
        s.disable_dpus([3, 4])
        out += [pool.estimate(2)]
        with pytest.raises(p.faults.DpuFaultError) as ei:
            pool.tick(1)
        out += [ei.value.report.kind, ei.value.report.detail, pool.ticks]
        for bad in (dict(tick_seconds=0.0), dict(min_fraction=0.0)):
            with pytest.raises(ValueError):
                p.pool(s, **bad)
        with pytest.raises(ValueError):
            pool.estimate(-1)
        instants = [(i.name, i.ts, dict(i.args)) for i in tracer.instants()]
        return out, timeline(s.timeline), _fault_log(s), instants
    out, tl, log, instants = both(run)
    assert out[-3] == "pool_degraded" and out[-1] == 2
    assert [i[0] for i in instants if i[0].startswith("pool")] \
        == ["pool:floor_tripped"]


def _serve(p, models, pool, n_requests=4, max_new=4):
    cfg, params = models[p.name]
    eng = p.engine(cfg, params, batch=2, capacity=64, pim_pool=pool)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, 5), max_new=max_new)
            for _ in range(n_requests)]
    return eng, rids


def test_serve_engine_survives_midstream_pool_fault(models):
    """tests/test_faults.py:318: the pool collapses below its floor after
    one healthy tick; the engine decodes on the host, no request is
    lost, and everything equals the JAX package's run."""
    def run(p):
        pim = p.system(p.cfg(n_dpus=4, n_tasklets=8, mram_bytes=1 << 21),
                       faults=p.faults.FaultPlan())
        pool = p.pool(pim, min_fraction=0.5)
        eng, rids = _serve(p, models, pool)
        eng.step()
        pim.disable_dpus([0, 1, 2])
        outs = eng.run()
        assert set(outs) == set(rids)
        return (outs, dict(eng.stats), pool.ticks, eng.ticks,
                timeline(pim.timeline), _fault_log(pim))
    outs, stats, ticks, _, tl, _ = both(run)
    assert all(len(v) == 4 for v in outs.values())
    assert stats["pim_ticks"] == ticks >= 1 and stats["host_ticks"] >= 1
    assert tl["kernel"] > 0.0


def test_serve_engine_on_a_cluster_lease(models):
    """examples/serve_lm.py --cluster: a 2-rank lease of a fault-aware
    cluster (32 DPUs, 8 ranks, 4 channels) as the engine's pool; its
    tokens equal the same engine's without a pool, each decode tick is
    one ``decode`` launch on the shared system."""
    def run(p):
        system = p.system(p.cfg(n_dpus=32, n_ranks=8, n_channels=4,
                                mram_bytes=1 << 20), mode="async")
        cluster = p.cl.PimCluster(system, policy="fault_aware",
                                  spare_ranks=2)
        lease = cluster.lease("serve_lm", n_ranks=2)
        eng, _ = _serve(p, models, lease.pool)
        outs = eng.run()
        bare, _ = _serve(p, models, None)
        assert bare.run() == outs
        cluster.release(lease)
        decode = [e for e in system.timeline.events if e[1] == "decode"]
        assert len(decode) == lease.pool.ticks == eng.stats["pim_ticks"]
        return (outs, dict(eng.stats), lease.ranks, lease.pool.ticks,
                timeline(system.timeline), cluster_report(cluster.report))
    outs, stats, ranks, ticks, _, rep = both(run)
    assert ranks == (0, 1) and stats["host_ticks"] == 0 and ticks > 0
    assert rep["admissions"] == [["lease:serve_lm", 0.0, [0, 1]]]
