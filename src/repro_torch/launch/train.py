"""Training CLI: elastic mesh, sharded state, checkpoint/restart.

    python -m repro_torch.launch.train --arch llama3-8b --smoke \
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --device cpu

The counterpart of ``repro.launch.train``: the same arguments, and
``--device`` (default: the CUDA card, ``LOCAL_RANK`` modulo the cards;
``cpu`` asks for the CPU; a rank sent to the card raises without one).
Under several ranks (``torchrun``'s ``WORLD_SIZE``, or a process group
its caller made) it joins the group (gloo on the CPU or when ranks share
a card, NCCL with a card each), builds ``launch.mesh.make_elastic_mesh()``
over it, places the train state by ``parallel.api.param_shardings``
(``train.loop.shard_train_state``), feeds each rank its rows
by ``batch_sharding`` and takes the steps under ``run_with_restarts``,
whose checkpoints take each rank's blocks, gathered on rank 0's host and
written whole in the JAX package's layout, and give each rank back its
own.  On
one device the mesh is ``{'data': 1, 'model': 1}``
(``launch.mesh.elastic_shape(1)``) and the state whole.  Rank 0 alone
prints.  The step lines' ms and tok/s, the median step and
``stragglers`` are read off the wall clock.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.carry import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import elastic_shape, make_elastic_mesh
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.parallel import api as par
from repro_torch.runtime.coordinator import run_with_restarts
from repro_torch.train import loop as train_loop


def _rank_device(name=None) -> torch.device:
    """This rank's device: ``name``, or (None) the card ``LOCAL_RANK``
    modulo the cards, raising without one."""
    device = resolve_device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    return device


def _join_group(device) -> bool:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1)
    unless one exists; True if this call made it.  Ranks that share a
    card, or run on the CPU, use gloo (NCCL refuses two ranks on one
    device)."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if dist.is_initialized() or world == 1:
        return False
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nccl = device.type == "cuda" and local <= torch.cuda.device_count()
    dist.init_process_group("nccl" if nccl else "gloo")
    return True


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
    device = _rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    made = _join_group(device)
    mesh = make_elastic_mesh(device_type=device.type) \
        if dist.is_initialized() else None
    rank0 = mesh is None or dist.get_rank() == 0

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    opt = get_optimizer(cfg.optimizer,
                        warmup_cosine(args.lr, warmup=10, total=args.steps))
    shape = elastic_shape(1) if mesh is None else par.mesh_axes(mesh)
    if rank0:
        print(f"mesh: {shape}  arch: {cfg.name}")

    state = train_loop.init_train_state(cfg, opt, device=device)
    if mesh is not None:
        state = train_loop.shard_train_state(state, mesh)
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
        if mesh is not None:
            batch = par.batch_rows(batch, mesh)
        ref["state"], m = step_fn(ref["state"], batch)
        data.step = i + 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        t_hist.append(dt)
        if i % 10 == 0 and rank0:
            tok_s = args.batch * args.seq / dt
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"{dt*1e3:.0f} ms ({tok_s:,.0f} tok/s)", flush=True)

    stats = run_with_restarts(
        one_step, state_ref=ref, data=data, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if rank0:
        print(f"done: {stats}; median step "
              f"{np.median(t_hist)*1e3:.0f} ms")
    if made:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
