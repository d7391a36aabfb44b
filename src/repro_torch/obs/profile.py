"""Run-level counter aggregation: one profile for a whole run.

A :class:`RunProfile` accumulates, across any number of systems and
cluster runs:

* per-kernel hardware counters from every
  :class:`~repro_torch.core.stats.KernelReport` (cycles, issued, idle
  breakdown, DMA read/write bytes — summed over launches, with derived
  IPC and MRAM read/write bandwidth utilization recomputed on the
  sums);
* timeline phase busy seconds and per-label byte volumes (collective
  traffic per collective kind, transfer traffic per label);
* fault/retry counts by kind from the fault log;
* compile-cache hit/miss/launch counters
  (:func:`repro_torch.core.compile_cache.stats` deltas since profile start);
* per-tenant SLO scorecards from a
  :class:`~repro_torch.cluster.metrics.ClusterReport`.

Exports: a flat, deterministically-ordered counter dict
(:meth:`counters`), a JSON snapshot (:meth:`to_json` / :meth:`save`),
and a Prometheus-style text exposition (:meth:`to_prometheus`) so the
same numbers can feed dashboards.  ``python -m repro_torch.obs.report``
renders the snapshot for humans.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

#: additive KernelReport counter fields (summed per kernel name)
_KERNEL_FIELDS = ("cycles", "issued", "active_cycles", "idle_mem",
                  "idle_rev", "idle_rf", "dma_rd_bytes", "dma_wr_bytes",
                  "row_hit", "row_miss", "tlb_hit", "tlb_miss",
                  "dc_hit", "dc_miss", "acq_retry")


def _kernel_row(name: str, agg: Dict[str, float]) -> Dict[str, Any]:
    """Derived per-kernel row from summed counters (to_row() schema:
    the same ipc/util/frac columns, computed over all launches)."""
    cyc_dpu = max(agg["cycles"] * agg["n_dpus"], 1e-9)
    peak = agg["mram_bw_bytes_per_cycle"] * cyc_dpu
    tot = max(agg["active_cycles"] + agg["idle_mem"] + agg["idle_rev"]
              + agg["idle_rf"], 1)
    return {
        "name": name,
        "launches": int(agg["launches"]),
        "n_dpus": int(agg["n_dpus"]),
        "cycles": int(agg["cycles"]),
        "issued": int(agg["issued"]),
        "ipc": round(agg["issued"] / cyc_dpu, 4),
        "mram_rd_util": round(agg["dma_rd_bytes"] / max(peak, 1e-9), 4),
        "mram_wr_util": round(agg["dma_wr_bytes"] / max(peak, 1e-9), 4),
        "acq_retry": int(agg["acq_retry"]),
        "frac_active": round(agg["active_cycles"] / tot, 4),
        "frac_idle_memory": round(agg["idle_mem"] / tot, 4),
        "frac_idle_revolver": round(agg["idle_rev"] / tot, 4),
        "frac_idle_rf": round(agg["idle_rf"] / tot, 4),
    }


class RunProfile:
    """Accumulates counters across a run; see module docstring.

    ``record_system`` is one-shot per system (it snapshots the system's
    reports, timeline, and fault log wholesale — recording the same
    system twice double-counts).  The compile-cache baseline is taken
    at construction, so a profile reports the *delta* its run caused,
    not the process-lifetime totals."""

    def __init__(self, name: str = "run"):
        self.name = name
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.phase_seconds: Dict[str, float] = {}
        self.label_bytes: Dict[str, Dict[str, float]] = {}   # phase -> label
        self.label_seconds: Dict[str, Dict[str, float]] = {}
        self.fault_counts: Dict[str, int] = {}
        self.retry_seconds = 0.0
        self.overlap_saved = 0.0
        self.end_to_end = 0.0
        self.n_systems = 0
        self.cluster: Optional[Dict[str, Any]] = None
        from repro_torch.core import compile_cache
        self._cache0 = compile_cache.stats()
        self.compile_cache: Dict[str, int] = {
            k: 0 for k in ("entries", "hits", "misses", "launches")}

    # ---- recording ---------------------------------------------------------
    def record_report(self, rep):
        """Fold one :class:`KernelReport` into the per-kernel sums."""
        agg = self.kernels.setdefault(rep.name, {
            "launches": 0.0, "n_dpus": float(rep.n_dpus),
            "mram_bw_bytes_per_cycle": float(rep.mram_bw_bytes_per_cycle),
            **{f: 0.0 for f in _KERNEL_FIELDS}})
        agg["launches"] += 1
        agg["n_dpus"] = max(agg["n_dpus"], float(rep.n_dpus))
        for f in _KERNEL_FIELDS:
            agg[f] += float(getattr(rep, f))

    def record_system(self, system):
        """Snapshot one finished :class:`PIMSystem`: kernel reports,
        timeline phases + per-label attribution, and the fault log."""
        self.n_systems += 1
        for rep in system.reports:
            self.record_report(rep)
        tl = system.timeline
        for phase in ("h2d", "kernel", "d2h", "inter_dpu", "retry",
                      "shed"):
            sec = getattr(tl, phase)
            if sec:
                self.phase_seconds[phase] = \
                    self.phase_seconds.get(phase, 0.0) + sec
        self.retry_seconds += tl.retry
        self.overlap_saved += tl.overlap_saved
        self.end_to_end += tl.end_to_end
        for ph, label, sec, nbytes in tl.events:
            by_s = self.label_seconds.setdefault(ph, {})
            by_s[label] = by_s.get(label, 0.0) + sec
            if nbytes:
                by_b = self.label_bytes.setdefault(ph, {})
                by_b[label] = by_b.get(label, 0.0) + nbytes
        for rep in system.fault_log:
            self.fault_counts[rep.kind] = \
                self.fault_counts.get(rep.kind, 0) + 1

    def record_compile_cache(self):
        """Refresh the compile-cache delta counters (call at run end)."""
        from repro_torch.core import compile_cache
        now = compile_cache.stats()
        self.compile_cache = {k: now[k] - self._cache0.get(k, 0)
                              for k in now}

    def record_cluster(self, report):
        """Snapshot one :class:`ClusterReport`: per-tenant + fleet SLO
        scorecards, makespan, utilization."""
        self.cluster = {
            "policy": report.policy,
            "makespan": report.makespan,
            "utilization": report.utilization(),
            "tenants": {t: report.metrics(t) for t in report.tenants()},
            "fleet": report.metrics(None),
        }

    # ---- export ------------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        """Flat ``name -> value`` counter map, deterministically ordered
        (sorted keys) — the snapshot both text exports derive from."""
        out: Dict[str, float] = {}
        for phase in sorted(self.phase_seconds):
            out[f"timeline_seconds{{phase={phase}}}"] = \
                self.phase_seconds[phase]
        out["retry_seconds"] = self.retry_seconds
        out["overlap_saved_seconds"] = self.overlap_saved
        out["end_to_end_seconds"] = self.end_to_end
        for ph in sorted(self.label_bytes):
            for label in sorted(self.label_bytes[ph]):
                out[f"bytes{{phase={ph},label={label}}}"] = \
                    self.label_bytes[ph][label]
        for name in sorted(self.kernels):
            row = _kernel_row(name, self.kernels[name])
            for k in ("launches", "cycles", "issued", "ipc",
                      "mram_rd_util", "mram_wr_util"):
                out[f"kernel_{k}{{kernel={name}}}"] = row[k]
        for kind in sorted(self.fault_counts):
            out[f"faults_total{{kind={kind}}}"] = self.fault_counts[kind]
        for k in sorted(self.compile_cache):
            out[f"compile_cache_{k}"] = self.compile_cache[k]
        if self.cluster:
            for tenant in sorted(self.cluster["tenants"]):
                m = self.cluster["tenants"][tenant]
                for k in ("jobs", "completed", "failed", "rejected",
                          "shed", "hedges", "slo_attainment", "goodput",
                          "slo_goodput", "p50_latency", "p99_latency"):
                    out[f"cluster_{k}{{tenant={tenant}}}"] = m.get(k, 0.0)
            out["cluster_makespan_seconds"] = self.cluster["makespan"]
            out["cluster_utilization"] = self.cluster["utilization"]
        return out

    def kernel_rows(self) -> List[Dict[str, Any]]:
        """Per-kernel derived rows (``to_row()``-schema columns), sorted
        by kernel name — ready for ``make_tables.kernel_table``."""
        return [_kernel_row(n, self.kernels[n])
                for n in sorted(self.kernels)]

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "n_systems": self.n_systems,
            "phase_seconds": dict(sorted(self.phase_seconds.items())),
            "retry_seconds": self.retry_seconds,
            "overlap_saved_seconds": self.overlap_saved,
            "end_to_end_seconds": self.end_to_end,
            "label_seconds": {p: dict(sorted(d.items()))
                              for p, d in sorted(self.label_seconds.items())},
            "label_bytes": {p: dict(sorted(d.items()))
                            for p, d in sorted(self.label_bytes.items())},
            "kernels": self.kernel_rows(),
            "faults": dict(sorted(self.fault_counts.items())),
            "compile_cache": dict(sorted(self.compile_cache.items())),
            "cluster": self.cluster,
            "counters": self.counters(),
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, default=float)
        return path

    def to_prometheus(self, prefix: str = "repro") -> str:
        """Prometheus text exposition of :meth:`counters` — one
        ``<prefix>_<name>{labels} value`` line per counter, gauge-typed
        (these are end-of-run snapshots, not live scrapes)."""
        lines: List[str] = []
        seen_base = set()
        for key, value in self.counters().items():
            base, brace, labels = key.partition("{")
            metric = f"{prefix}_{base}"
            if metric not in seen_base:
                lines.append(f"# TYPE {metric} gauge")
                seen_base.add(metric)
            label_part = ""
            if brace:
                pairs = [p.split("=", 1)
                         for p in labels.rstrip("}").split(",")]
                label_part = "{" + ",".join(
                    f'{k}="{v}"' for k, v in pairs) + "}"
            lines.append(f"{metric}{label_part} {value:.10g}")
        return "\n".join(lines) + "\n"
