"""Batched serving demo on the PyTorch/CUDA port: continuous batching
over a slot pool (examples/serve_lm.py on ``repro_torch``: the smoke
config in float32 on random weights from a seed, on the CUDA card unless
``--device cpu`` asks for the CPU).

    python examples/torch_serve_lm.py --arch mamba2-130m [--device cpu]

``--arch`` takes a configuration of any family (dense, ssm, moe, hybrid,
encdec, vlm); encdec's engine holds no encoder positions, as the
original's.

``--cluster`` submits through the multi-tenant cluster runtime instead
of attaching a private accelerator: the serving replica leases ranks
from a shared :class:`repro_torch.cluster.PimCluster` (fault-aware placement)
and its decode ticks are charged to the shared system's timeline next
to everyone else's work.

    python examples/torch_serve_lm.py --arch mamba2-130m --cluster \\
        [--lease-ranks 2]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.carry import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine


def _cluster_pool(n_ranks: int, device=None):
    """Lease decode ranks from a shared fault-aware cluster."""
    from repro_torch.cluster import PimCluster
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    system = PIMSystem(DPUConfig(n_dpus=32, n_ranks=8, n_channels=4,
                                 mram_bytes=1 << 20), mode="async",
                       device=device)
    cluster = PimCluster(system, policy="fault_aware", spare_ranks=2)
    lease = cluster.lease("serve_lm", n_ranks=n_ranks)
    return cluster, lease


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--cluster", action="store_true",
                    help="lease decode ranks from the shared PIM cluster")
    ap.add_argument("--lease-ranks", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the shared system "
                         "(default: the CUDA card; cpu asks for the CPU)")
    args = ap.parse_args()

    cluster = lease = None
    pool = None
    if args.cluster:
        cluster, lease = _cluster_pool(args.lease_ranks, args.device)

    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    device = resolve_device(args.device)
    params = T.Transformer(cfg, device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(0))
    eng = ServeEngine(cfg, params, batch=4, capacity=128,
                      pim_pool=lease.pool if lease else pool)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        eng.submit(rng.integers(0, cfg.vocab_size, plen),
                   max_new=args.max_new)
    outs = eng.run()
    dt = time.time() - t0
    total = sum(len(v) for v in outs.values())
    print(f"arch={cfg.name} served {len(outs)} requests "
          f"({total} tokens) in {dt:.1f}s on a 4-slot pool")
    if cluster is not None:
        tl = cluster.system.timeline
        print(f"cluster lease: ranks={list(lease.ranks)} "
              f"policy={cluster.policy} "
              f"pim_ticks={eng.stats['pim_ticks']} "
              f"host_ticks={eng.stats['host_ticks']} "
              f"modeled_decode={tl.kernel * 1e3:.2f}ms")
        cluster.release(lease)
    for rid, toks in sorted(outs.items()):
        print(f"  req{rid}: {toks}")


if __name__ == "__main__":
    main()
