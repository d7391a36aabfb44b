"""Per-rank execution vs the PR 3 whole-system schedule, on the
PyTorch/CUDA port (benchmarks/rank_overlap.py's sweeps, calibration and
checks, the same rows, on ``repro_torch``; the systems are modeled only
(no kernel runs) and live on the CUDA card unless ``--device cpu`` asks
for the CPU).

Each of R ranks runs an independent batch loop: stage (h2d to its own
DPUs), compute (kernel on its own rank), exchange (allreduce among its
own DPUs).  The *same* command durations are scheduled twice:

* **whole-system** — PR 3's resource model: every LAUNCH holds every
  rank's compute slot and every collective holds whole-channel links,
  so the rank loops serialize (only h2d on distinct channels ever
  overlapped);
* **per-rank** — this PR's model: LAUNCHes hold only their rank's slot,
  transfers/collectives hold per-rank link shares
  (``chan<c>:rank<r>``), so the R loops pipeline against each other and
  disjoint-rank collectives overlap.

A second sweep prices link sharing: with every rank on ONE physical
channel, the ``channel_contention`` factor stretches concurrent
disjoint-rank operations; the makespan must grow monotonically with the
factor and the factor-1.0 default must reproduce the independent-share
schedule.  A final check re-runs the per-rank submission on an in-order
system and asserts the serialized timeline is bit-exact with the busy
sum — the PR 3 default behaviour is untouched.

    python benchmarks/torch_rank_overlap.py [--scale 1.0] [--device cpu]
    python -m benchmarks.torch_run --suite overlap
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.comm as comm  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.core.host import PIMSystem  # noqa: E402
from repro_torch.sched import queue as sq  # noqa: E402

DPUS_PER_RANK = 4
EXCHANGE_WORDS = 1 << 14         # per-rank allreduce payload (64 KiB)


def _cfg(ranks: int, chans: int, contention: float = 1.0) -> DPUConfig:
    return DPUConfig(n_dpus=ranks * DPUS_PER_RANK, n_ranks=ranks,
                     n_channels=chans, mram_bytes=1 << 20,
                     channel_contention=contention)


def _submit(sys_: PIMSystem, per_rank: bool, n_iters: int,
            stage_bytes: float, words: int) -> None:
    """Queue R independent rank loops; ``per_rank=False`` emulates the
    PR 3 whole-system resource holds on identical command durations."""
    topo = sys_.topology
    D = topo.n_dpus
    img = np.zeros((D, words), np.int32)
    kernel_s = stage_bytes / (sys_.cfg.h2d_gbps_per_dpu * 1e9)  # balanced
    for r in range(topo.n_ranks):
        group = list(range(D))[topo.dpu_slice(r)]
        vec = np.zeros(D)
        vec[group] = stage_bytes
        with sys_.stream(f"rank{r}"):
            for k in range(n_iters):
                if per_rank:
                    sys_.h2d(vec, label=f"stage r{r}.{k}")
                    sys_.modeled_launch(f"kern r{r}.{k}", kernel_s,
                                        ranks=[r])
                    comm.allreduce(sys_, img, 0, words, dpus=group)
                else:
                    # PR 3 holds: whole channels for transfers/collectives,
                    # every rank slot for launches — same durations
                    ev = topo.schedule(vec, "h2d")
                    sys_._submit(sq.H2D, "h2d", f"stage r{r}.{k}",
                                 ev.seconds, ev.total_bytes,
                                 {f"chan{c}": b for c, b
                                  in enumerate(ev.channel_busy) if b > 0})
                    sys_.modeled_launch(f"kern r{r}.{k}", kernel_s)
                    secs = sys_.fabric.subset(group).allreduce(4.0 * words)
                    sys_.collective("allreduce", secs,
                                    4.0 * words * len(group))


def rank_overlap(scale: float = 1.0, ranks_list=(2, 4),
                 chans_list=(1, 2), n_iters: int = 3,
                 device=None) -> List[Dict]:
    """Makespan of the per-rank schedule vs the whole-system schedule."""
    stage_bytes = 1e6 * scale
    words = max(256, int(EXCHANGE_WORDS * scale))
    rows = []
    for ranks in ranks_list:
        for chans in chans_list:
            if chans > ranks:
                continue
            res = {}
            for mode in ("whole", "per_rank"):
                sys_ = PIMSystem(_cfg(ranks, chans), mode="async",
                                 device=device)
                _submit(sys_, mode == "per_rank", n_iters, stage_bytes,
                        words)
                res[mode] = (sys_.sync().makespan, sys_.timeline.total)
            (whole, total_w), (per, total_p) = res["whole"], res["per_rank"]
            assert abs(total_w - total_p) < 1e-12 * max(total_w, 1e-30), \
                "arms must submit identical busy time"
            rows.append({
                "bench": "rank_overlap", "ranks": ranks, "channels": chans,
                "iters": n_iters, "busy_ms": round(total_w * 1e3, 3),
                "whole_ms": round(whole * 1e3, 3),
                "per_rank_ms": round(per * 1e3, 3),
                "speedup": round(whole / per, 3),
            })
    return rows


#: measured multi-rank transfer weak scaling, Gomez-Luna et al.
#: (arXiv:2110.01709): aggregate CPU->DPU bandwidth of R ranks driving
#: ONE memory channel concurrently, relative to a single rank.  The real
#: UPMEM config is 2 ranks/channel and sustains ~1.2x (the host copy
#: threads contend on the channel bus); 4 ranks/channel is the paper's
#: saturating extrapolation, down-weighted below because no shipping
#: module has it.
MEASURED_WEAK_SCALING = {2: 1.2, 4: 1.3}
MEASURED_WEIGHT = {2: 1.0, 4: 0.25}
CALIBRATION_GRID = (1.0, 1.25, 1.5, 1.67, 2.0, 2.5, 3.0, 4.0)


def contention_calibration(scale: float = 1.0, device=None) -> List[Dict]:
    """Sweep ``channel_contention`` against the measured weak-scaling
    shape and report the best-fitting factor.

    For each factor the model's aggregate speedup is measured directly:
    R ranks on one channel each h2d their own payload concurrently; the
    async makespan vs the single-rank time gives the aggregate scaling
    (analytically R/factor — the later arrivals stretch while sharing
    the physical link).  The factor minimizing the weighted relative
    error vs ``MEASURED_WEAK_SCALING`` is the shipped
    ``DPUConfig.channel_contention`` default (1.67 = 2/1.2: exact on the
    measured 2-ranks-per-channel point); a regression test pins it."""
    stage_bytes = 1e6 * scale
    rows = []
    best = None
    for f in CALIBRATION_GRID:
        err = 0.0
        model = {}
        for ranks, meas in sorted(MEASURED_WEAK_SCALING.items()):
            sys_ = PIMSystem(_cfg(ranks, 1, contention=f), mode="async",
                             device=device)
            topo = sys_.topology
            for r in range(ranks):
                vec = np.zeros(topo.n_dpus)
                vec[topo.dpu_slice(r)] = stage_bytes
                with sys_.stream(f"rank{r}"):
                    sys_.h2d(vec, label=f"weak r{r}")
            mk = sys_.sync().makespan
            ref = PIMSystem(_cfg(ranks, 1, contention=f), mode="async",
                            device=device)
            vec = np.zeros(topo.n_dpus)
            vec[topo.dpu_slice(0)] = stage_bytes
            ref.h2d(vec)
            one = ref.sync().makespan
            model[ranks] = ranks * one / mk
            err += (MEASURED_WEIGHT[ranks]
                    * abs(model[ranks] - meas) / meas)
        rows.append({"bench": "rank_calibration", "contention": f,
                     "model_x2": round(model[2], 3),
                     "model_x4": round(model[4], 3),
                     "weighted_rel_err": round(err, 4)})
        if best is None or err < best[0]:
            best = (err, f)
    from repro_torch.core.config import DPUConfig
    rows.append({"bench": "rank_calibration", "best_fit": best[1],
                 "shipped_default": DPUConfig().channel_contention,
                 "measured": MEASURED_WEAK_SCALING})
    return rows


def contention_sweep(scale: float = 1.0, ranks: int = 4,
                     factors=(1.0, 1.5, 2.0, 4.0),
                     n_iters: int = 3, device=None) -> List[Dict]:
    """All ranks on ONE channel: price the disjoint-rank link sharing."""
    stage_bytes = 1e6 * scale
    words = max(256, int(EXCHANGE_WORDS * scale))
    rows = []
    for f in factors:
        sys_ = PIMSystem(_cfg(ranks, 1, contention=f), mode="async",
                         device=device)
        _submit(sys_, True, n_iters, stage_bytes, words)
        rows.append({"bench": "rank_contention", "ranks": ranks,
                     "channels": 1, "contention": f,
                     "per_rank_ms": round(sys_.sync().makespan * 1e3, 3)})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device of every system (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)

    # sanity: the default in-order path still reproduces the serialized
    # PR 3 timeline bit-exactly under the per-rank resource model
    ser = PIMSystem(_cfg(2, 2), device=args.device)  # mode="inorder"
    _submit(ser, True, args.iters, 1e6 * args.scale, 1024)
    ser.sync()
    # same durations, two summation orders (scheduler finish chain vs
    # per-phase accumulators) -> compare to the last ulp, not bitwise
    assert abs(ser.timeline.elapsed - ser.timeline.total) \
        <= 1e-12 * ser.timeline.total, \
        "in-order default must reproduce the serialized sum"

    rows = rank_overlap(args.scale, n_iters=args.iters, device=args.device)
    print("== per-rank launches + disjoint-rank collectives vs "
          "whole-system holds ==")
    print(f"{'ranks':>5} {'chans':>5} {'busy_ms':>8} {'whole_ms':>9} "
          f"{'per_rank_ms':>12} {'speedup':>8}")
    ok = True
    for row in rows:
        print(f"{row['ranks']:>5} {row['channels']:>5} {row['busy_ms']:>8.2f} "
              f"{row['whole_ms']:>9.2f} {row['per_rank_ms']:>12.2f} "
              f"{row['speedup']:>8.2f}")
        if row["per_rank_ms"] >= row["whole_ms"]:
            ok = False

    krows = contention_calibration(args.scale, args.device)
    print("\n== contention calibration vs measured weak scaling "
          "(arXiv:2110.01709) ==")
    print(f"{'factor':>7} {'model_x2':>9} {'model_x4':>9} {'rel_err':>8}")
    for row in krows[:-1]:
        print(f"{row['contention']:>7.2f} {row['model_x2']:>9.2f} "
              f"{row['model_x4']:>9.2f} {row['weighted_rel_err']:>8.4f}")
    summary = krows[-1]
    print(f"best fit {summary['best_fit']} == shipped default "
          f"{summary['shipped_default']}")
    if summary["best_fit"] != summary["shipped_default"]:
        ok = False

    crows = contention_sweep(args.scale, n_iters=args.iters,
                             device=args.device)
    print("\n== link-share contention factor (4 ranks, 1 channel) ==")
    print(f"{'factor':>7} {'per_rank_ms':>12}")
    last = 0.0
    for row in crows:
        print(f"{row['contention']:>7.1f} {row['per_rank_ms']:>12.2f}")
        if row["per_rank_ms"] < last - 1e-9:
            ok = False
        last = row["per_rank_ms"]

    if not ok:
        raise SystemExit("FAIL: per-rank schedule did not beat the "
                         "whole-system schedule (or contention decreased "
                         "the makespan)")
    print("\nAll configurations: the per-rank schedule pipelines the rank "
          "loops (stage/compute/exchange of distinct ranks overlap) and "
          "beats PR 3's whole-system holds; contention factors only "
          "stretch the makespan.")


if __name__ == "__main__":
    main()
