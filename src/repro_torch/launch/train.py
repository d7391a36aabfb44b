"""Training CLI: checkpoint/restart on one device.

    python -m repro_torch.launch.train --arch llama3-8b --smoke \
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]

The counterpart of ``repro.launch.train``: the same arguments, and
``--device`` (default: the CUDA card; ``cpu`` asks for the CPU).  It
builds no mesh: on one device the reference's elastic mesh is
``{'data': 1, 'model': 1}`` (``launch.mesh.elastic_shape(1)``) and every
sharding an identity, so the twin prints that mesh's shape and runs the
port's train step
(``repro_torch.train.loop``) under ``run_with_restarts``, whose
checkpoints are in the JAX package's layout.  The step lines' ms and
tok/s, the median step and ``stragglers`` are read off the wall clock.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.carry import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import elastic_shape
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.runtime.coordinator import run_with_restarts
from repro_torch.train import loop as train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu asks "
                         "for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    opt = get_optimizer(cfg.optimizer,
                        warmup_cosine(args.lr, warmup=10, total=args.steps))
    # the reference's make_elastic_mesh() on one device
    print(f"mesh: {elastic_shape(1)}  arch: {cfg.name}")

    state = train_loop.init_train_state(cfg, opt, device=device)
    step_fn = train_loop.make_train_step(cfg, opt,
                                         microbatches=args.microbatches)
    data = SyntheticLM(cfg, DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size))
    ref = {"state": state}
    t_hist = []

    def one_step(i):
        t0 = time.perf_counter()
        batch = train_loop.to_device(data.batch_at(i), device)
        ref["state"], m = step_fn(ref["state"], batch)
        data.step = i + 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        t_hist.append(dt)
        if i % 10 == 0:
            tok_s = args.batch * args.seq / dt
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"{dt*1e3:.0f} ms ({tok_s:,.0f} tok/s)", flush=True)

    stats = run_with_restarts(
        one_step, state_ref=ref, data=data, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    print(f"done: {stats}; median step "
          f"{np.median(t_hist)*1e3:.0f} ms")


if __name__ == "__main__":
    main()
