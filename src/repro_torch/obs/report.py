"""Human-readable run reports from exported observability artifacts.

    PYTHONPATH=src python -m repro_torch.obs.report TRACE.json \\
        [--profile COUNTERS.json] [--top 10] [--prometheus]

Reads a Chrome-trace JSON (as written by :meth:`Tracer.save` /
``Schedule.to_chrome_trace()`` / ``benchmarks/run.py --trace``) and an
optional :class:`~repro_torch.obs.profile.RunProfile` snapshot, and prints:

* the top spans by total busy seconds (aggregated by span name);
* the per-phase busy / wall-covered breakdown, with transfer time split
  into **exposed** (on the critical path, outside kernel coverage) vs
  **hidden** (overlapped under kernels) — the Fig. 10 question;
* per-kernel IPC / idle breakdown / MRAM read+write bandwidth
  utilization rows from the profile snapshot;
* compile-cache hit/miss, fault counts, and the per-tenant SLO table
  when the profile carries a cluster section.

Pure stdlib + the trace files: no simulator import, so it runs on an
artifact pulled from CI.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

US = 1e6  # chrome trace timestamps are microseconds


def load_spans(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a Chrome trace back into span dicts (seconds).  ``X``
    events carry ``busy_s`` (the modeled busy duration — one entry per
    occupied lane, deduplicated here on (name, ts, busy)); ``b``/``e``
    async pairs are matched by id."""
    spans: List[Dict[str, Any]] = []
    seen = set()
    open_async: Dict[Tuple[int, Any], Dict[str, Any]] = {}
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "X":
            args = ev.get("args", {})
            key = (ev["name"], ev["ts"], args.get("busy_s"))
            if key in seen:
                continue  # same command on another resource lane
            seen.add(key)
            spans.append({
                "name": ev["name"], "phase": args.get("phase"),
                "start": ev["ts"] / US, "end": (ev["ts"] + ev["dur"]) / US,
                "busy": args.get("busy_s", ev["dur"] / US),
                "wasted": args.get("wasted_s", 0.0),
                "nbytes": args.get("nbytes", 0.0),
            })
        elif ph == "b":
            open_async[(ev["pid"], ev.get("id"))] = ev
        elif ph == "e":
            b = open_async.pop((ev["pid"], ev.get("id")), None)
            if b is not None:
                args = b.get("args", {})
                spans.append({
                    "name": b["name"], "phase": args.get("phase"),
                    "start": b["ts"] / US, "end": ev["ts"] / US,
                    "busy": args.get("busy_s",
                                     (ev["ts"] - b["ts"]) / US),
                    "wasted": 0.0, "nbytes": 0.0,
                })
    return spans


def covered(spans: List[Dict[str, Any]], phase: str) -> float:
    """Wall seconds with >= 1 ``phase`` span in flight (interval union)."""
    ivs = sorted((s["start"], s["end"]) for s in spans
                 if s["phase"] == phase and s["end"] > s["start"])
    total, cur_s, cur_f = 0.0, None, 0.0
    for s, f in ivs:
        if cur_s is None or s > cur_f:
            if cur_s is not None:
                total += cur_f - cur_s
            cur_s, cur_f = s, f
        elif f > cur_f:
            cur_f = f
    return total + (cur_f - cur_s if cur_s is not None else 0.0)


def top_spans(spans: List[Dict[str, Any]], n: int = 10
              ) -> List[Tuple[str, float, int]]:
    """(name, total busy seconds, count), heaviest first."""
    agg: Dict[str, List[float]] = {}
    for s in spans:
        cur = agg.setdefault(s["name"], [0.0, 0])
        cur[0] += s["busy"]
        cur[1] += 1
    rows = [(name, busy, int(cnt)) for name, (busy, cnt) in agg.items()]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:n]


def _fmt_s(sec: float) -> str:
    return f"{sec * 1e3:10.4f}ms"


def render(trace: Dict[str, Any], profile: Optional[Dict[str, Any]] = None,
           top: int = 10) -> str:
    """The full text report (what the CLI prints)."""
    spans = load_spans(trace)
    makespan = max((s["end"] for s in spans), default=0.0)
    lines: List[str] = []
    lines.append(f"== trace: {len(spans)} spans, "
                 f"makespan {makespan * 1e3:.4f}ms ==")

    lines.append(f"\n-- top {top} spans by busy time --")
    lines.append(f"{'span':<32} {'count':>6} {'busy':>12} {'share':>7}")
    busy_total = sum(s["busy"] for s in spans) or 1.0
    for name, busy, cnt in top_spans(spans, top):
        lines.append(f"{name:<32} {cnt:>6d} {_fmt_s(busy):>12} "
                     f"{busy / busy_total:>6.1%}")

    lines.append("\n-- phase breakdown --")
    lines.append(f"{'phase':<10} {'busy':>12} {'covered':>12} {'hidden':>12}")
    phases = sorted({s["phase"] for s in spans if s["phase"]})
    for phase in phases:
        busy = sum(s["busy"] for s in spans if s["phase"] == phase)
        cov = covered(spans, phase)
        lines.append(f"{phase:<10} {_fmt_s(busy):>12} {_fmt_s(cov):>12} "
                     f"{_fmt_s(max(0.0, busy - cov)):>12}")
    xfer = sum(s["busy"] for s in spans if s["phase"] in ("h2d", "d2h"))
    exposed = max(0.0, makespan - covered(spans, "kernel"))
    lines.append(f"transfer busy {_fmt_s(xfer)}  exposed (outside kernels) "
                 f"{_fmt_s(min(exposed, xfer) if xfer else exposed)}  "
                 f"hidden {_fmt_s(max(0.0, xfer - exposed))}")
    wasted = sum(s["wasted"] for s in spans)
    if wasted:
        lines.append(f"retry waste {_fmt_s(wasted)} "
                     f"({wasted / busy_total:.1%} of busy)")

    if profile:
        kernels = profile.get("kernels") or []
        if kernels:
            lines.append("\n-- kernels (profile) --")
            lines.append(f"{'kernel':<28} {'launches':>8} {'ipc':>7} "
                         f"{'rd_util':>8} {'wr_util':>8} {'active':>7} "
                         f"{'idle_mem':>8}")
            for row in kernels:
                lines.append(
                    f"{row['name']:<28} {row.get('launches', 1):>8} "
                    f"{row['ipc']:>7.4f} {row['mram_rd_util']:>8.4f} "
                    f"{row['mram_wr_util']:>8.4f} "
                    f"{row.get('frac_active', 0.0):>7.4f} "
                    f"{row.get('frac_idle_memory', 0.0):>8.4f}")
        cache = profile.get("compile_cache") or {}
        if cache:
            lines.append(f"\ncompile cache: {cache.get('hits', 0)} hits / "
                         f"{cache.get('misses', 0)} misses / "
                         f"{cache.get('launches', 0)} launches")
        faults = profile.get("faults") or {}
        if faults:
            lines.append("faults: " + ", ".join(
                f"{k}={v}" for k, v in sorted(faults.items())))
        cluster = profile.get("cluster")
        if cluster:
            lines.append(f"\n-- per-tenant SLO "
                         f"(policy={cluster['policy']}) --")
            lines.append(f"{'tenant':<12} {'jobs':>5} {'done':>5} "
                         f"{'fail':>5} {'p50_ms':>8} {'p99_ms':>8} "
                         f"{'slo':>6} {'goodput':>8}")
            rows = dict(cluster["tenants"])
            rows["FLEET"] = cluster["fleet"]
            for tenant, m in rows.items():
                lines.append(
                    f"{tenant:<12} {m['jobs']:>5} {m['completed']:>5} "
                    f"{m['failed']:>5} {m['p50_latency'] * 1e3:>8.2f} "
                    f"{m['p99_latency'] * 1e3:>8.2f} "
                    f"{m['slo_attainment']:>6.2f} {m['goodput']:>8.4f}")
    return "\n".join(lines)


def render_command_trace(records: List[Dict[str, Any]],
                         top: int = 10) -> str:
    """Text report for a ``repro_torch.trace`` command-stream JSONL (recorded
    at the ``PIMSystem._submit`` seam): per-phase busy/bytes breakdown,
    heaviest labels, and how much of the stream carries a re-pricing
    spec (i.e. is re-priceable by ``repro_torch.trace.replay`` under another
    fabric/topology config rather than replayed as recorded)."""
    header = records[0]
    cmds = [r for r in records[1:] if r.get("type") == "cmd"]
    syncs = sum(1 for r in records[1:] if r.get("type") == "sync")
    cfg = header.get("cfg", {})
    lines = [
        f"== command trace v{header.get('version')}: {len(cmds)} commands, "
        f"{syncs} sync(s), mode={header.get('mode')} ==",
        f"config: n_dpus={cfg.get('n_dpus')} n_ranks={cfg.get('n_ranks')} "
        f"n_channels={cfg.get('n_channels')} fabric={cfg.get('fabric')!r} "
        f"freq_mhz={cfg.get('freq_mhz')} backend={cfg.get('backend')!r}",
    ]
    lines.append("\n-- phase breakdown --")
    lines.append(f"{'phase':<10} {'count':>6} {'busy':>12} {'bytes':>14}")
    phases: Dict[str, List[float]] = {}
    for c in cmds:
        if c.get("phase"):
            cur = phases.setdefault(c["phase"], [0, 0.0, 0.0])
            cur[0] += 1
            cur[1] += c["seconds"]
            cur[2] += c.get("nbytes", 0.0)
    for phase in sorted(phases):
        cnt, busy, nb = phases[phase]
        lines.append(f"{phase:<10} {int(cnt):>6d} {_fmt_s(busy):>12} "
                     f"{nb:>14,.0f}")
    lines.append(f"\n-- top {top} labels by busy time --")
    lines.append(f"{'label':<32} {'count':>6} {'busy':>12}")
    agg: Dict[str, List[float]] = {}
    for c in cmds:
        cur = agg.setdefault(c.get("label") or c["kind"], [0, 0.0])
        cur[0] += 1
        cur[1] += c["seconds"]
    rows = sorted(agg.items(), key=lambda kv: (-kv[1][1], kv[0]))[:top]
    for label, (cnt, busy) in rows:
        lines.append(f"{label:<32} {int(cnt):>6d} {_fmt_s(busy):>12}")
    priced = sum(1 for c in cmds if c.get("meta"))
    timed = sum(1 for c in cmds if c["seconds"] > 0)
    lines.append(f"\nre-priceable: {priced}/{timed} timed commands carry a "
                 "pricing spec (the rest replay as recorded)")
    queues = sorted({c["queue"] for c in cmds})
    lines.append(f"queues: {', '.join(queues)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="Chrome-trace JSON (Tracer.save output) "
                                  "or a repro_torch.trace command-stream JSONL")
    ap.add_argument("--profile", default=None,
                    help="RunProfile JSON snapshot (counters + kernels)")
    ap.add_argument("--top", type=int, default=10,
                    help="spans to list in the top-spans table")
    ap.add_argument("--prometheus", action="store_true",
                    help="also dump the profile's counters as a "
                         "Prometheus text exposition")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        text = f.read()
    try:
        trace = json.loads(text)
    except json.JSONDecodeError:
        trace = None
    if trace is None or (isinstance(trace, dict)
                         and trace.get("type") == "header"):
        # repro_torch.trace command-stream JSONL (one JSON record per line)
        records = [json.loads(line) for line in text.splitlines()
                   if line.strip()]
        if not records or records[0].get("type") != "header":
            raise SystemExit(f"{args.trace}: neither a Chrome trace nor a "
                             "command-stream JSONL")
        print(render_command_trace(records, top=args.top))
        return 0
    profile = None
    if args.profile:
        with open(args.profile) as f:
            profile = json.load(f)
    print(render(trace, profile, top=args.top))
    if args.prometheus and profile:
        counters = profile.get("counters", {})
        print("\n# counters")
        for key in sorted(counters):
            print(f"{key} {counters[key]:.10g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
