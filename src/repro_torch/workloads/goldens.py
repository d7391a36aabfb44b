"""Workload goldens: what the JAX package simulates, for holding the port
to it where JAX is not installed (the CUDA card's machine).

``goldens.json`` (beside this module) holds one entry per workload at
each configuration of :data:`CONFIGS`, and the :data:`REMAP` scenario.
``tools/make_workload_goldens.py`` writes it from the JAX package; the
CPU tests, the card tests and ``chip_smoke.py`` compare the port's runs
with it through :func:`entry`, the one function every side uses.  The
functions here take either package's objects (duck-typed) and import
neither package's engine.

An entry holds ``cycles`` and ``issued``, the ``Timeline`` (every field
a run compares, floats exact through JSON) and ``digest``: a SHA-256
over every ``KernelReport`` field (arrays by dtype, shape and bytes)
and every leaf of the final state (sorted keys, dtype, shape, bytes).
A run that raises (a kernel that hits ``max_cycles``) is recorded as
``{"raises": "<type>: <first line>", "state_digest": ...}``: the error and
the SHA-256 of every leaf of the last state the driver returned, the
capped one (:func:`run_entry`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("goldens.json")

_G4 = dict(n_dpus=4, n_ranks=2, n_channels=2, n_tasklets=8,
           mram_bytes=1 << 18)
#: the SIMT and HBM-PIM configurations' cap: 2.5x the longest of their
#: runs that ends (MLP on SIMT, 162,920 cycles).  HST-L and TRNS never end
#: on the SIMT engine (a spin on a held mutex under min-PC reconvergence)
#: and are recorded at it.
CAP = 400_000
#: Fig. 11's designs (benchmarks/pim_figs.py fig11_simt)
FIG11 = {
    "Base": {},
    "SIMT": dict(simt_width=16),
    "SIMT+AC": dict(simt_width=16, coalescing=True),
    "SIMT+AC+4x": dict(simt_width=16, coalescing=True, mram_bw_scale=4.0),
    "SIMT+AC+16x": dict(simt_width=16, coalescing=True, mram_bw_scale=16.0),
}

#: name -> (DPUConfig fields, threads, scale, seed).  g4 is VA's golden
#: configuration (tests/test_backend.py) at 8 tasklets with 256 KiB of
#: MRAM a DPU (MLP's three 128 x 128 layers need 193 KiB); g64 is one
#: UPMEM rank of the paper's figures (benchmarks/pim_figs.py _cfg).  s4,
#: s4ac and h4 are g4 on the SIMT engine (4 wide; 8 wide with the
#: coalescer) and on the HBM-PIM all-bank compat target; c4 is GEMVS's
#: native CRF path (tests/test_hbmpim.py:144's scale and seed); fig11/* are
#: Fig. 11's designs (one DPU, 16 tasklets, the figures' 2 MiB MRAM).
CONFIGS = {
    "g4": (_G4, 8, 0.02, 0),
    "g64": (dict(n_dpus=64, n_tasklets=16, mram_bytes=1 << 21), 16, 0.02,
            0),
    "s4": (dict(_G4, simt_width=4, max_cycles=CAP), 8, 0.02, 0),
    "s4ac": (dict(_G4, simt_width=8, coalescing=True, max_cycles=CAP), 8,
             0.02, 0),
    "h4": (dict(_G4, backend="hbmpim", max_cycles=CAP), 8, 0.02, 0),
    "c4": (dict(_G4, backend="hbmpim_cmd", max_cycles=CAP), 8, 0.05, 3),
}
CONFIGS.update({
    f"fig11/{design}": (dict(n_dpus=1, n_tasklets=16, mram_bytes=1 << 21,
                             max_cycles=CAP, **kw), 16, 0.05, 0)
    for design, kw in FIG11.items()})

#: configurations that hold some workloads only (default: every one)
ONLY = {"c4": ("GEMVS",), **{f"fig11/{d}": ("GEMV",) for d in FIG11}}


def kernel_of(key: str, name: str) -> str:
    """The card kernel that workload ``name`` of configuration ``key``
    runs on: GEMVS on an HBM-PIM backend is the CRF command stream
    (``crf_step``); the SIMT engine and the all-bank compat target are
    ``simt_step``; the scalar DPU is ``cycle_step``."""
    fields = CONFIGS[key][0]
    be = fields.get("backend", "")
    if name == "GEMVS" and be.startswith("hbmpim"):
        return "crf_step"
    if be not in ("", "scalar") or fields.get("simt_width", 0) > 0:
        return "simt_step"
    return "cycle_step"


#: the scalar DPU's configurations (every workload, on cycle_step), and
#: the others: the SIMT and HBM-PIM ones
SCALAR_KEYS = tuple(k for k in CONFIGS if k not in ONLY
                    and kernel_of(k, "") == "cycle_step")
SIMT_KEYS = tuple(k for k in CONFIGS if k not in SCALAR_KEYS)

#: workloads that take fewer DPUs than a configuration has: they run on
#: their most (SSORT's splitter exchange: ``sort.MAX_D``)
MAX_DPUS = {"SSORT": 32}

#: the remap scenario: (workload, configuration, (dpu, launch) killed)
REMAP = ("HST-S", "g4", (1, 0))

#: the Timeline fields an entry holds (``total`` is a property)
TIMELINE = ("h2d", "kernel", "d2h", "inter_dpu", "retry", "shed", "events",
            "elapsed", "total")


def _feed(h, value):
    """Hash ``value`` canonically: numbers by value whatever their numpy
    or Python type, arrays by dtype, shape and bytes, dicts by sorted
    key."""
    if isinstance(value, np.ndarray) or hasattr(value, "__array__") \
            and not np.isscalar(value):
        a = np.ascontiguousarray(np.asarray(value))
        h.update(f"a:{a.dtype.str}:{a.shape}:".encode())
        h.update(a.tobytes())
    elif isinstance(value, dict):
        h.update(f"d{len(value)}:".encode())
        for k in sorted(value):
            h.update(f"k:{k}:".encode())
            _feed(h, value[k])
    elif isinstance(value, (int, np.integer)):
        h.update(f"i:{int(value)};".encode())
    elif isinstance(value, (float, np.floating)):
        h.update(f"f:{float(value).hex()};".encode())
    elif isinstance(value, str):
        h.update(f"s:{value!r};".encode())
    else:
        raise TypeError(f"cannot hash a {type(value).__name__}")


def digest(report, state) -> str:
    """SHA-256 of every ``KernelReport`` field (none if ``report`` is None)
    and every state leaf."""
    h = hashlib.sha256()
    for f in dataclasses.fields(report) if report is not None else ():
        h.update(f"field:{f.name}:".encode())
        _feed(h, getattr(report, f.name))
    for k in sorted(state):
        h.update(f"leaf:{k}:".encode())
        _feed(h, np.asarray(state[k]))
    return h.hexdigest()


def timeline(tl) -> dict:
    """The Timeline fields of :data:`TIMELINE`, as JSON would hold them."""
    out = {}
    for name in TIMELINE:
        v = getattr(tl, name)
        if name == "events":
            v = [[str(p), str(lbl), float(s), float(b)]
                 for p, lbl, s, b in v]
        elif v is not None:
            v = float(v)
        out[name] = v
    return out


def entry(report, system, state) -> dict:
    """The golden entry of one run: ``report`` and ``state`` are what
    ``Workload.run`` returned, ``system`` the ``PIMSystem`` it ran on."""
    return {"cycles": int(report.cycles), "issued": int(report.issued),
            "timeline": timeline(system.timeline),
            "digest": digest(report, state)}


def workloads_of(key: str, names) -> list:
    """The workloads of ``names`` that configuration ``key`` holds."""
    return sorted(n for n in names if n in ONLY.get(key, names))


def raised(exc: BaseException) -> dict:
    """The entry of a run that raised: the exception's type and the first
    line of its message."""
    return {"raises": f"{type(exc).__name__}: "
                      f"{str(exc).splitlines()[0] if str(exc) else ''}"}


def run_entry(workloads, config_cls, system_cls, cache, key: str,
              name: str, **system_kw) -> dict:
    """:func:`entry` of :func:`run_config`'s run, or, if the run raises
    ``RuntimeError`` (a kernel that hits ``max_cycles``), :func:`raised`
    with ``state_digest``, the :func:`digest` of the last state that
    ``cache.run`` (the package's ``compile_cache``) returned."""
    last = []
    run = cache.run

    def recording_run(*a, **kw):
        out = run(*a, **kw)
        last[:] = [out]
        return out

    cache.run = recording_run
    try:
        return entry(*run_config(workloads, config_cls, system_cls, key,
                                 name, **system_kw))
    except RuntimeError as e:
        if not last:
            raise
        return dict(raised(e), state_digest=digest(None, last[0]))
    finally:
        cache.run = run


def remap_entry(report, system, state) -> dict:
    """:func:`entry` plus the fault log's kinds and DPUs."""
    out = entry(report, system, state)
    out["fault_log"] = [[f.kind, [int(d) for d in f.dpus]]
                        for f in system.fault_log]
    return out


def run_config(workloads, config_cls, system_cls, key: str, name: str,
               **system_kw):
    """Run workload ``name`` at configuration ``key`` (on at most
    :data:`MAX_DPUS` DPUs) with one package's registry, ``DPUConfig`` and
    ``PIMSystem`` (``system_kw`` goes to the system, e.g. ``device=``);
    returns ``(report, system, state)``."""
    fields, threads, scale, seed = CONFIGS[key]
    fields = dict(fields, n_dpus=min(fields["n_dpus"],
                                     MAX_DPUS.get(name, fields["n_dpus"])))
    system = system_cls(config_cls(**fields), **system_kw)
    state, report = workloads.get(name).run(system, threads, scale=scale,
                                            seed=seed)
    return report, system, state


def run_remap(workloads, config_cls, system_cls, fault_plan_cls, kill_dpu,
              **system_kw):
    """The :data:`REMAP` scenario with one package's classes."""
    name, key, (dpu, launch) = REMAP
    fields, threads, scale, seed = CONFIGS[key]
    system = system_cls(config_cls(**fields),
                        faults=fault_plan_cls(events=(kill_dpu(dpu, launch),)),
                        recovery="remap", **system_kw)
    state, report = workloads.get(name).run(system, threads, scale=scale,
                                            seed=seed)
    return report, system, state


#: the cluster configuration (``chip_smoke.py`` [cluster] (a)):
#: benchmarks/cluster_load.py's system (8 ranks x 4 DPUs, 4 channels, 1
#: MiB MRAM, async, 2 spare ranks), its four-tenant mix at scale 1.0 and
#: its seeds, with measured profiles (BFS, HST-S, SSORT each run once on
#: a 4-DPU, 8-tasklet, 2 MiB rank at ``profile_scale``), under each
#: policy at each permanent-fault rate
CLUSTER = {
    "system": dict(n_dpus=32, n_ranks=8, n_channels=4, mram_bytes=1 << 20),
    "mode": "async", "spare_ranks": 2, "seed": 7, "fault_seed": 1,
    "horizon": 0.08, "profile_scale": 0.05,
    "policies": ("first_fit", "fault_aware"), "rates": (0.0, 0.02),
    #: benchmarks/cluster_load.py tenant_mix(1.0)
    "tenants": (
        dict(name="graph", rate_hz=400.0, kinds=("BFS",), n_ranks=2,
             priority=1, slo_seconds=0.05),
        dict(name="sort", rate_hz=300.0, kinds=("SSORT", "HST-S")),
        dict(name="lm", rate_hz=200.0, kinds=("lm_decode",), size=8,
             n_ranks=2, priority=2, slo_seconds=0.02),
        dict(name="hist", rate_hz=250.0, kinds=("HST-S",)),
    ),
}
#: the kinds a measured cluster profiles
CLUSTER_KINDS = ("BFS", "HST-S", "SSORT")


def cluster_key(policy: str, rate: float) -> str:
    return f"{policy}@{rate}"


def profile_steps(profile) -> list:
    """A ``JobProfile``'s steps as JSON would hold them: (phase, label,
    seconds, bytes_per_dpu, nbytes) each."""
    return [[str(s.phase), str(s.label), float(s.seconds),
             float(s.bytes_per_dpu), float(s.nbytes)] for s in profile.steps]


def cluster_report(rep) -> dict:
    """A ``ClusterReport`` as JSON would hold it: the fleet's
    ``metrics()``, ``goodput()`` and ``utilization()``, each tenant's
    ``metrics``, the admissions (jid, time, ranks), every outcome's
    fields, each rank's busy seconds and the makespan."""
    return {
        "metrics": rep.metrics(),
        "goodput": rep.goodput(), "utilization": rep.utilization(),
        "tenants": {t: rep.metrics(t) for t in rep.tenants()},
        "admissions": [[jid if isinstance(jid, str) else int(jid),
                        float(t), [int(r) for r in ranks]]
                       for jid, t, ranks in rep.admissions],
        "outcomes": [[getattr(o, f.name) if f.name != "ranks"
                      else [int(r) for r in o.ranks]
                      for f in dataclasses.fields(o)]
                     for o in rep.outcomes],
        "rank_busy": [[int(r), float(b)]
                      for r, b in sorted(rep.rank_busy.items())],
        "makespan": float(rep.makespan)}


def run_cluster(cluster, config_cls, system_cls, fault_plan_cls,
                policy: str, rate: float, *, config: dict = CLUSTER,
                cluster_kw: dict = None, **system_kw):
    """One run of ``config`` (:data:`CLUSTER` unless another such dict is
    given) with one package's ``cluster`` module, ``DPUConfig``,
    ``PIMSystem`` and ``FaultPlan`` (``cluster_kw`` goes to the
    ``PimCluster``, e.g. ``journal=``; ``system_kw`` to the system, e.g.
    ``device=``); returns ``(profiles, report)``, the profiles as
    ``cluster.measure_profile`` holds them after the run."""
    c = config
    tenants = [cluster.TenantSpec(**kw) for kw in c["tenants"]]
    jobs = cluster.poisson_stream(tenants, horizon=c["horizon"],
                                  seed=c["seed"])
    faults = (fault_plan_cls(seed=c["fault_seed"], p_dpu_permanent=rate)
              if rate > 0 else None)
    system = system_cls(config_cls(**c["system"]), mode=c["mode"],
                        faults=faults, **system_kw)
    report = cluster.PimCluster(system, policy=policy,
                                spare_ranks=c["spare_ranks"],
                                profiles="measured",
                                profile_scale=c["profile_scale"],
                                **(cluster_kw or {})).run(jobs)
    kw = {"device": system.device} if hasattr(system, "device") else {}
    profiles = {k: cluster.measure_profile(
        k, n_dpus=system.topology.dpus_per_rank, scale=c["profile_scale"],
        **kw) for k in CLUSTER_KINDS}
    return profiles, report


def cluster_entries(run) -> dict:
    """The cluster goldens: ``run(policy, rate)`` is
    :func:`run_cluster` with one package's classes bound.  Holds the
    measured profiles' steps and each (policy, rate)'s
    :func:`cluster_report`."""
    out = {"runs": {}}
    for rate in CLUSTER["rates"]:
        for policy in CLUSTER["policies"]:
            profiles, report = run(policy, rate)
            out["runs"][cluster_key(policy, rate)] = cluster_report(report)
    out["profiles"] = {k: profile_steps(p) for k, p in profiles.items()}
    return out


def load() -> dict:
    """``goldens.json``: ``{"configs": ..., "entries": {key: {workload:
    entry}}, "remap": entry, "cluster": cluster entries, "scripts":
    {"runs": {key: script entry}, "engine_perf": {key: row}}}`` (the
    entry points' goldens: ``tools/script_runs.py``)."""
    with open(PATH) as f:
        return json.load(f)


def differences(want: dict, got: dict) -> list:
    """The keys of an entry where ``got`` differs from ``want`` (the
    Timeline field by field)."""
    bad = [k for k in want if k != "timeline" and want[k] != got.get(k)]
    bad += [f"timeline.{k}" for k in want.get("timeline", {})
            if want["timeline"][k] != got.get("timeline", {}).get(k)]
    return bad
