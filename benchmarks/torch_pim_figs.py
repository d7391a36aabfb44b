"""Per-figure PIM characterization on the PyTorch/CUDA port (paper Figs.
5-15, the MMU case study and Table III's simulation rate).

The studies of ``benchmarks/pim_figs.py`` with the same arguments and the
same rows, run by ``repro_torch`` on the CUDA card (``device=None``; on
the card every simulated cycle runs in a fused kernel, ``cycle_step`` for
the scalar DPU and ``simt_step`` for the SIMT one)
or on the CPU (``device="cpu"``).  One simulation sweep feeds Figs. 5-9;
it is cached in reports/torch_pim_char.json keyed by (workload, threads,
scale), apart from the JAX package's cache.  Fig. 11's SIMT designs run
on the ``simt_step`` kernel.

    python benchmarks/torch_pim_figs.py [--scale 0.05] [--only fig12]
        [--device cpu]

prints one JSON object a line: each row of each study, then
``{"study": ..., "wall_s": ...}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.workloads as wl  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.workloads.goldens import FIG11  # noqa: E402

CHAR_WORKLOADS = ["VA", "RED", "SCAN-SSA", "SCAN-RSS", "SEL", "UNI", "HST-S",
                  "HST-L", "BS", "TS", "GEMV", "TRNS", "SpMV", "MLP"]
THREADS = (1, 4, 16)
CHAR_CACHE = "reports/torch_pim_char.json"


def _cfg(**kw):
    base = dict(n_dpus=1, n_tasklets=16, mram_bytes=1 << 21)
    base.update(kw)
    return DPUConfig(**base)


def characterize(scale: float, cache_path=CHAR_CACHE, workloads=None,
                 threads=THREADS, device=None) -> Dict:
    """Run (workload x threads) once; cache derived metrics."""
    workloads = workloads or CHAR_WORKLOADS
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    cache = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)
    dirty = False
    for name in workloads:
        for nt in threads:
            key = f"{name}/{nt}/{scale}"
            if key in cache:
                continue
            sys_ = PIMSystem(_cfg(n_tasklets=max(nt, 16)), device=device)
            t0 = time.time()
            _, rep = wl.get(name).run(sys_, n_threads=nt, scale=scale)
            row = rep.to_row()
            row["wall_s"] = round(time.time() - t0, 2)
            row["hist"] = [int(x) for x in rep.hist]
            row["ts"] = [round(float(x), 2) for x in rep.ts[0][:128]]
            cache[key] = row
            dirty = True
    if dirty:
        with open(cache_path, "w") as f:
            json.dump(cache, f)
    return {k: v for k, v in cache.items()
            if any(k.startswith(w + "/") for w in workloads)}


# Figs. 5-9 are projections of characterize()'s runs: they simulate
# nothing, so they take no device.

def fig5_utilization(char: Dict, scale) -> List[Dict]:
    """Compute + MRAM-read-BW utilization vs thread count."""
    rows = []
    for key, r in sorted(char.items()):
        name, nt, _ = key.split("/")
        rows.append({"bench": "fig5", "workload": name, "threads": int(nt),
                     "compute_util": r["ipc"],
                     "mram_rd_util": r["mram_rd_util"]})
    return rows


def fig6_breakdown(char: Dict, scale) -> List[Dict]:
    rows = []
    for key, r in sorted(char.items()):
        name, nt, _ = key.split("/")
        rows.append({"bench": "fig6", "workload": name, "threads": int(nt),
                     "active": r["frac_active"],
                     "idle_memory": r["frac_idle_memory"],
                     "idle_revolver": r["frac_idle_revolver"],
                     "idle_rf": r["frac_idle_rf"]})
    return rows


def fig7_tlp_hist(char: Dict, scale) -> List[Dict]:
    rows = []
    for key, r in sorted(char.items()):
        name, nt, _ = key.split("/")
        if int(nt) != 16:
            continue
        h = np.array(r["hist"], dtype=float)
        h = h / max(h.sum(), 1)
        rows.append({"bench": "fig7", "workload": name,
                     "frac_zero_issuable": round(float(h[0]), 4),
                     "avg_issuable": r["avg_issuable"]})
    return rows


def fig8_tlp_timeseries(char: Dict, scale) -> List[Dict]:
    rows = []
    for key, r in sorted(char.items()):
        name, nt, _ = key.split("/")
        if int(nt) != 16 or name not in ("BS", "GEMV", "SCAN-SSA"):
            continue
        ts = [t for t in r["ts"] if t > 0]
        rows.append({"bench": "fig8", "workload": name,
                     "ts_mean": round(float(np.mean(ts)), 2) if ts else 0,
                     "ts_std": round(float(np.std(ts)), 2) if ts else 0,
                     "ts_head": ts[:12]})
    return rows


def fig9_instr_mix(char: Dict, scale) -> List[Dict]:
    rows = []
    for key, r in sorted(char.items()):
        name, nt, _ = key.split("/")
        if int(nt) != 16:
            continue
        rows.append({"bench": "fig9", "workload": name,
                     "alu": r["mix_alu"], "wram_ldst": r["mix_wram_ldst"],
                     "dma": r["mix_dma"], "control": r["mix_control"],
                     "sync": r["mix_sync"]})
    return rows


def fig10_strong_scaling(scale: float, device=None) -> List[Dict]:
    """1/4/16 DPUs, fixed total work; latency breakdown incl transfers."""
    rows = []
    for name in ("VA", "RED", "SCAN-SSA", "BS", "NW"):
        base_t = None
        for d in (1, 4, 16):
            sys_ = PIMSystem(_cfg(n_dpus=d), device=device)
            _, rep = wl.get(name).run(sys_, n_threads=16, scale=scale / d)
            t = sys_.timeline
            if base_t is None:
                base_t = t.total
            rows.append({
                "bench": "fig10", "workload": name, "dpus": d,
                "speedup": round(base_t / t.total, 2),
                "kernel_frac": round(t.breakdown()["kernel"], 3),
                "h2d_frac": round(t.breakdown()["h2d"], 3),
                "d2h_frac": round(t.breakdown()["d2h"], 3),
                "inter_dpu_frac": round(t.breakdown()["inter_dpu"], 3),
            })
    return rows


def fig11_simt(scale: float, device=None) -> List[Dict]:
    """SIMT GEMV case study: Base / SIMT / +AC / +4x / +16x (on the card
    the Base design runs on cycle_step, the SIMT designs on simt_step)."""
    rows = []
    base_c = None
    for label, kw in FIG11.items():
        sys_ = PIMSystem(_cfg(**kw), device=device)
        _, rep = wl.get("GEMV").run(sys_, n_threads=16, scale=scale)
        if base_c is None:
            base_c = rep.cycles
        rows.append({"bench": "fig11", "design": label,
                     "cycles": rep.cycles,
                     "speedup": round(base_c / rep.cycles, 2),
                     "ipc": rep.to_row()["ipc"]})
    return rows


def fig12_ilp(scale: float, workloads=("TS", "GEMV", "RED", "VA", "HST-S"),
              device=None) -> List[Dict]:
    """Additive D/R/S/F ablation."""
    rows = []
    for name in workloads:
        base_t = None
        for feats in ("", "D", "DR", "DRS", "DRSF"):
            cfg = _cfg().with_ilp(feats)
            sys_ = PIMSystem(cfg, device=device)
            _, rep = wl.get(name).run(sys_, n_threads=16, scale=scale)
            t = rep.kernel_seconds
            if base_t is None:
                base_t = t
            rows.append({"bench": "fig12", "workload": name,
                         "design": "Base" + ("+" + feats if feats else ""),
                         "speedup": round(base_t / t, 2),
                         "frac_idle_memory":
                             rep.to_row()["frac_idle_memory"]})
    return rows


def fig13_mram_bw(scale: float, workloads=("BS", "VA", "TS"),
                  device=None) -> List[Dict]:
    """MRAM->WRAM bandwidth sweep x1..x4, base vs full-ILP designs."""
    rows = []
    for name in workloads:
        for ilp in ("", "DRSF"):
            base_t = None
            for bw in (1.0, 2.0, 4.0):
                cfg = _cfg(mram_bw_scale=bw).with_ilp(ilp)
                sys_ = PIMSystem(cfg, device=device)
                _, rep = wl.get(name).run(sys_, n_threads=16, scale=scale)
                t = rep.kernel_seconds
                if base_t is None:
                    base_t = t
                rows.append({"bench": "fig13", "workload": name,
                             "design": "Base" + ("+DRSF" if ilp else ""),
                             "bw_scale": bw,
                             "speedup": round(base_t / t, 2)})
    return rows


def fig15_cache_vs_scratchpad(scale: float, device=None) -> List[Dict]:
    rows = []
    for name in wl.CACHEABLE:
        c1 = _cfg()
        s1 = PIMSystem(c1, device=device)
        _, r1 = wl.get(name).run(s1, 16, scale=scale)
        c2 = _cfg(cache_mode=True, wram_bytes=1 << 23)
        s2 = PIMSystem(c2, device=device)
        _, r2 = wl.get(name).run(s2, 16, scale=scale, cache_mode=True)
        rows.append({
            "bench": "fig15", "workload": name,
            "scratchpad_cycles": r1.cycles, "cache_cycles": r2.cycles,
            "cache_speedup": round(r1.cycles / r2.cycles, 2),
            "rd_traffic_ratio": round(
                r1.dma_rd_bytes / max(r2.dc_miss * 64, 1), 2),
        })
    return rows


def mmu_overhead(scale: float, device=None) -> List[Dict]:
    """Case study #3: translation overhead (paper: avg 0.8%, max 14.1%)."""
    rows = []
    slows = []
    for name in ("VA", "RED", "BS", "GEMV", "HST-S", "TS"):
        s0 = PIMSystem(_cfg(), device=device)
        _, r0 = wl.get(name).run(s0, 16, scale=scale)
        s1 = PIMSystem(_cfg(mmu=True), device=device)
        _, r1 = wl.get(name).run(s1, 16, scale=scale)
        sl = r1.cycles / r0.cycles - 1
        slows.append(sl)
        rows.append({"bench": "mmu", "workload": name,
                     "slowdown_pct": round(100 * sl, 2),
                     "tlb_hit_rate": round(
                         r1.tlb_hit / max(r1.tlb_hit + r1.tlb_miss, 1), 4)})
    rows.append({"bench": "mmu", "workload": "AVG",
                 "slowdown_pct": round(100 * float(np.mean(slows)), 2),
                 "max_pct": round(100 * float(np.max(slows)), 2)})
    return rows


def simulation_rate(scale: float, device=None) -> List[Dict]:
    """Table III: simulation rate.  Paper's PIMulator: 3 KIPS (1 DPU)."""
    rows = []
    for d in (1, 16, 64):
        sys_ = PIMSystem(_cfg(n_dpus=d), device=device)
        t0 = time.time()
        _, rep = wl.get("VA").run(sys_, n_threads=16, scale=scale)
        wall = time.time() - t0
        rows.append({"bench": "simrate", "dpus": d,
                     "instructions": rep.issued,
                     "kips": round(rep.issued / wall / 1e3, 1),
                     "cycles_per_s": round(rep.cycles / wall, 0),
                     "wall_s": round(wall, 2)})
    return rows


def studies(scale: float, device=None) -> Dict:
    """Study name -> a thunk that returns its rows (Figs. 5-9 share one
    characterize() sweep)."""
    char = {}

    def need_char():
        if not char:
            char.update(characterize(scale, device=device))
        return char

    return {
        "fig5_util": lambda: fig5_utilization(need_char(), scale),
        "fig6_breakdown": lambda: fig6_breakdown(need_char(), scale),
        "fig7_tlp_hist": lambda: fig7_tlp_hist(need_char(), scale),
        "fig8_tlp_ts": lambda: fig8_tlp_timeseries(need_char(), scale),
        "fig9_instr_mix": lambda: fig9_instr_mix(need_char(), scale),
        "fig10_scaling": lambda: fig10_strong_scaling(scale, device),
        "fig11_simt": lambda: fig11_simt(scale, device),
        "fig12_ilp": lambda: fig12_ilp(scale, device=device),
        "fig13_mram_bw": lambda: fig13_mram_bw(scale, device=device),
        "fig15_cache": lambda: fig15_cache_vs_scratchpad(scale, device),
        "mmu_overhead": lambda: mmu_overhead(scale, device),
        "simulation_rate": lambda: simulation_rate(scale, device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--only", default=None,
                    help="run the studies whose name holds this substring")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args(argv)
    from repro_torch.core.carry import resolve_device
    resolve_device(args.device)        # raises without a card unless cpu
    selected = {k: fn for k, fn in studies(args.scale, args.device).items()
                if args.only is None or args.only in k}
    if not selected:
        raise SystemExit(f"no study matches --only {args.only!r}; valid "
                         f"names: {', '.join(studies(args.scale))}")
    for name, fn in selected.items():
        t0 = time.time()
        rows = fn()
        for row in rows:
            print(json.dumps({"study": name, **row}, default=float),
                  flush=True)
        print(json.dumps({"study": name, "wall_s": time.time() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
