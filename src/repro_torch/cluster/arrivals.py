"""Seeded, deterministic workload generator for the cluster runtime.

Produces the request streams a multi-tenant PIM fleet has to absorb:
mixed jobs — the PrIM-style kernels (BFS, HST-S, SSORT) plus
``lm_decode`` (a :class:`~repro_torch.serve.pim_pool.PimDecodePool`-backed LM
decode burst) — each carrying a size, a rank-subset width, a priority,
and a latency SLO.  Two sources:

* :func:`poisson_stream` — per-tenant Poisson processes (exponential
  interarrivals), every draw a pure function of ``(seed, tenant index)``
  so the same spec replays bit-identically across runs and across
  ``mode="inorder"`` / ``mode="async"`` systems;
* :func:`trace_stream` — a JSONL trace file (one job per line), the
  record side of which is :func:`save_trace` — captured streams re-run
  without re-sampling.

Job identity is assigned *after* the global (arrival, tenant, index)
sort, so ``jid`` order == admission-queue arrival order, which is what
the determinism tests pin.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: job classes the cluster knows how to plan (see cluster.scheduler)
JOB_KINDS = ("BFS", "HST-S", "SSORT", "lm_decode")


@dataclass(frozen=True)
class JobSpec:
    """One admitted unit of tenant work.

    ``size`` scales the job's work: kernel/exchange seconds and
    transfer bytes for the PrIM kinds, the decode-tick count for
    ``lm_decode`` (``max(1, round(size))`` ticks).  ``n_ranks`` is the
    disjoint rank-subset width the job must be placed on;
    ``priority`` orders admission (higher first) and arms preemption;
    ``slo_seconds`` is the end-to-end (arrival -> completion) target
    the metrics layer scores attainment against."""

    jid: int
    tenant: str
    kind: str
    arrival: float            # seconds since stream start
    size: float = 1.0
    n_ranks: int = 1
    priority: int = 0
    slo_seconds: float = float("inf")

    def __post_init__(self):
        if self.kind not in JOB_KINDS:
            raise ValueError(f"unknown job kind {self.kind!r} "
                             f"(want one of {JOB_KINDS})")
        if self.arrival < 0 or self.size <= 0 or self.n_ranks < 1:
            raise ValueError(f"bad job spec {self!r}")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic model for :func:`poisson_stream`.

    ``rate_hz`` is the Poisson arrival rate; ``kinds`` cycle per draw
    (weighted by ``kind_weights`` when given); ``size``/``size_jitter``
    bound the uniform size draw ``size * (1 - j/2 + j*u)``."""

    name: str
    rate_hz: float
    kinds: Tuple[str, ...] = ("BFS",)
    kind_weights: Optional[Tuple[float, ...]] = None
    n_ranks: int = 1
    priority: int = 0
    size: float = 1.0
    size_jitter: float = 0.5
    slo_seconds: float = float("inf")

    def __post_init__(self):
        if self.rate_hz <= 0:
            raise ValueError("tenant arrival rate must be positive")
        for k in self.kinds:
            if k not in JOB_KINDS:
                raise ValueError(f"unknown job kind {k!r}")
        if self.kind_weights is not None \
                and len(self.kind_weights) != len(self.kinds):
            raise ValueError("kind_weights must match kinds")
        if not 0.0 <= self.size_jitter <= 1.0:
            raise ValueError("size_jitter must be in [0, 1]")


def poisson_stream(tenants: Sequence[TenantSpec], horizon: float,
                   seed: int = 0) -> List[JobSpec]:
    """Sample every tenant's Poisson arrivals over ``[0, horizon)``.

    Deterministic: tenant ``i`` draws from
    ``np.random.default_rng([seed, i])`` regardless of the other
    tenants, so adding a tenant never perturbs existing streams."""
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    raw: List[Tuple[float, int, int, TenantSpec, str, float]] = []
    for ti, ten in enumerate(tenants):
        rng = np.random.default_rng([int(seed), ti])
        t, k = 0.0, 0
        weights = None
        if ten.kind_weights is not None:
            w = np.asarray(ten.kind_weights, np.float64)
            weights = w / w.sum()
        while True:
            t += float(rng.exponential(1.0 / ten.rate_hz))
            if t >= horizon:
                break
            if weights is None:
                kind = ten.kinds[k % len(ten.kinds)]
            else:
                kind = ten.kinds[int(rng.choice(len(ten.kinds), p=weights))]
            j = ten.size_jitter
            size = ten.size * (1.0 - j / 2.0 + j * float(rng.random()))
            raw.append((t, ti, k, ten, kind, size))
            k += 1
    raw.sort(key=lambda r: (r[0], r[1], r[2]))
    return [JobSpec(jid=i, tenant=ten.name, kind=kind, arrival=t,
                    size=size, n_ranks=ten.n_ranks, priority=ten.priority,
                    slo_seconds=ten.slo_seconds)
            for i, (t, _, _, ten, kind, size) in enumerate(raw)]


def scale_rates(tenants: Sequence[TenantSpec],
                factor: float) -> List[TenantSpec]:
    """Uniformly scale every tenant's arrival rate — the overload knob:
    ``scale_rates(mix, 1.5)`` offers 1.5x the calibrated load with the
    same kind/size/SLO structure (the chaos benchmark's x-axis)."""
    if factor <= 0:
        raise ValueError("rate factor must be positive")
    import dataclasses
    return [dataclasses.replace(t, rate_hz=t.rate_hz * factor)
            for t in tenants]


def save_trace(path: str, jobs: Sequence[JobSpec]) -> None:
    """Record a job stream as a JSONL trace (one job per line)."""
    with open(path, "w") as f:
        for job in jobs:
            f.write(json.dumps(asdict(job)) + "\n")


def trace_stream(path: str) -> List[JobSpec]:
    """Replay a JSONL trace written by :func:`save_trace` (or by hand:
    any line with at least ``tenant``/``kind``/``arrival`` keys).  Jobs
    are re-sorted by arrival and re-numbered so hand-edited traces stay
    admission-ordered."""
    jobs: List[Dict] = []
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec = json.loads(line)
            for key in ("tenant", "kind", "arrival"):
                if key not in rec:
                    raise ValueError(f"{path}:{ln + 1}: trace record "
                                     f"missing {key!r}")
            jobs.append(rec)
    jobs.sort(key=lambda r: (float(r["arrival"]),
                             str(r["tenant"]), int(r.get("jid", 0))))
    return [JobSpec(jid=i, tenant=str(r["tenant"]), kind=str(r["kind"]),
                    arrival=float(r["arrival"]),
                    size=float(r.get("size", 1.0)),
                    n_ranks=int(r.get("n_ranks", 1)),
                    priority=int(r.get("priority", 0)),
                    slo_seconds=float(r.get("slo_seconds", float("inf"))))
            for i, r in enumerate(jobs)]
