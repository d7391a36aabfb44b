"""Multi-tenant PIM cluster demo on the PyTorch/CUDA port: one shared
system, four tenants, fault-aware placement vs health-blind first-fit
(examples/pim_cluster.py on ``repro_torch``; the shared system lives on
the CUDA card unless ``--device cpu`` asks for the CPU).

A Poisson job mix (graph BFS on 2-rank subsets, sample sort, LM decode
bursts, histogram batch) is admitted onto an 8-rank system twice — once
fault-free and once with a 2% per-launch permanent-DPU fault rate — and
the per-tenant SLO scorecard is printed for both placement policies.
Watch the goodput column: with faults, first-fit keeps parking tenants
on degraded ranks (each kernel stretches as survivors re-stream dead
lanes' shards) while the fault-aware policy retires sick ranks, promotes
the provisioned spares, and reschedules replicas.

    python examples/torch_pim_cluster.py [--rate 0.02] [--trace f] \\
        [--chrome-trace cluster.trace.json] [--device cpu]

``--chrome-trace PATH`` records every run (all four rate x policy
combinations) into one :class:`repro_torch.obs.Tracer` and writes the
Chrome-trace JSON to PATH — open it at ``ui.perfetto.dev`` to see the
per-rank lanes, whole-job async spans per tenant, and fault/preemption/
spare-promotion instants.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.cluster import (PimCluster, TenantSpec, poisson_stream,
                           save_trace, trace_stream)
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem
from repro_torch.faults.model import FaultPlan
from repro_torch.obs import Tracer


def _system(rate: float, tracer=None, device=None) -> PIMSystem:
    faults = FaultPlan(seed=1, p_dpu_permanent=rate) if rate > 0 else None
    return PIMSystem(DPUConfig(n_dpus=32, n_ranks=8, n_channels=4,
                               mram_bytes=1 << 20),
                     mode="async", faults=faults, tracer=tracer,
                     device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=0.02,
                    help="per-launch permanent-DPU fault rate")
    ap.add_argument("--horizon", type=float, default=0.08)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace", default=None,
                    help="save the sampled stream as a JSONL trace and "
                         "replay it from the file (record/replay demo)")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="export all runs as Chrome-trace JSON to PATH "
                         "(open in ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device of the shared system (default: the "
                         "CUDA card; cpu asks for the CPU)")
    args = ap.parse_args()
    tracer = Tracer() if args.chrome_trace else None

    tenants = [
        TenantSpec("graph", rate_hz=400.0, kinds=("BFS",), n_ranks=2,
                   priority=1, slo_seconds=0.05),
        TenantSpec("sort", rate_hz=300.0, kinds=("SSORT", "HST-S")),
        TenantSpec("lm", rate_hz=200.0, kinds=("lm_decode",), size=8,
                   n_ranks=2, priority=2, slo_seconds=0.02),
        TenantSpec("hist", rate_hz=250.0, kinds=("HST-S",)),
    ]
    jobs = poisson_stream(tenants, horizon=args.horizon, seed=args.seed)
    if args.trace:
        save_trace(args.trace, jobs)
        jobs = trace_stream(args.trace)
        print(f"replaying {len(jobs)} jobs from {args.trace}")

    for rate in (0.0, args.rate):
        for policy in ("first_fit", "fault_aware"):
            rep = PimCluster(_system(rate, tracer, args.device),
                             policy=policy,
                             spare_ranks=2).run(jobs)
            print(f"\n=== fault rate {rate:.0%}  policy {policy} ===")
            print(rep.table())

    if tracer is not None:
        tracer.finalize()
        tracer.save(args.chrome_trace)
        print(f"\nChrome trace: {args.chrome_trace} "
              f"({len(tracer.spans())} spans, "
              f"{len(tracer.instants())} instants)")


if __name__ == "__main__":
    main()
