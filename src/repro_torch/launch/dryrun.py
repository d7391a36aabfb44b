"""Dry-run: count every (arch x shape) cell on the meta device, on the
production meshes (16x16 and 2x16x16) or on one card, and price it on
NVIDIA H100s.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles
each cell on 512 host devices and reads XLA's cost and memory analyses.
The port has no compiler to partition a program, so it runs its own
sharded program instead:

* **the mesh** — the default process group is torch's ``fake`` backend
  (``launch/mesh.py``'s :func:`~repro_torch.launch.mesh.fake_group`) as one
  rank of a world of 256 or 512, and the production mesh is a
  ``DeviceMesh`` over it; collectives return at once, on meta tensors
  too;
* **the cell** — ``launch/specs.py``'s ``make_cell`` on that mesh: the
  rank's blocks of the state, the batch and the cache (meta tensors) and
  the port's sharded train step, prefill or decode step (tensor and
  sequence parallel on ``model``, as XLA partitions the reference's),
  run under
  ``launch/cost.py``'s counters (FLOPs, bytes accessed, the arguments',
  results' and temporaries' bytes, the collectives the rank issued by
  kind and group);
* **the ranks** — ranks are not all alike (the rank whose cache block
  holds the written position; blocks that do not divide evenly), so the
  rank at coordinate all-0 and the rank at coordinate all-last are
  counted, and every number of the row is the larger of the two;
* **depth** — as in the reference, extrapolated linearly from two reduced
  depths (units 2 and 4 of :func:`_depth_units`, microbatches 1): the
  port's layers are a Python loop, so the counts are exactly linear in
  units where the units are whole.  On 2x16x16 the claim is memory (args,
  out, temp), as the reference's multi-pod pass; its roofline terms come
  from the same count.  A mesh row over one card's 80 GiB names the
  temporaries' largest term in its notes (:func:`over_card`);
* **the price** — ``launch/roofline.py``'s :data:`H100` data-sheet peaks
  per card, and each collective over the slowest link its group crosses
  on :data:`~repro_torch.launch.roofline.H100_FLEET` (8 cards a node on
  NVLink 4, nodes on NDR InfiniBand; ranks laid out row-major, so a
  ``model`` group of 16 spans two nodes).

``--mesh 1x1`` writes the one-card rows instead (``{arch}__{shape}__1x1``):
the cell on one card, no collectives.  The PIM cell (:func:`run_pim_cell`,
the reference's ``run_pim_cell``): the full system's 2,560 DPUs, VA, with
the DPU axis split over every rank of the mesh
(``core/compile_cache.py``'s sharded driver); one card runs it whole.

Every entry point runs on the card unless ``--device cpu`` asks for the
CPU (the LM cells are counted on meta either way; the device runs the
one-card PIM cell).  A cell that fails makes the sweep exit non-zero.

    python -m repro_torch.launch.dryrun [--arch a] [--shape s]
        [--multi-pod] [--single-pod] [--mesh 1x1] [--jobs N]
        [--out reports/torch_dryrun] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.core.carry import resolve_device
from repro_torch.launch import cost, roofline, specs
from repro_torch.launch import mesh as mesh_mod

#: the one-card mesh
ONE_CARD = "1x1"
#: file suffix of each mesh's rows, as the reference names them
SUFFIX = {ONE_CARD: "1x1", "16x16": "sp", "2x16x16": "mp"}


def mesh_name(multi_pod: Optional[bool]) -> str:
    """``1x1`` (None), ``16x16`` or ``2x16x16``."""
    if multi_pod is None:
        return ONE_CARD
    return "x".join(map(str, mesh_mod.production_shape(multi_pod).values()))


def _depth_units(cfg) -> float:
    fam = cfg.family
    if fam == "moe":
        return cfg.n_layers - cfg.n_dense_layers
    if fam == "hybrid":
        return cfg.n_layers / 3.0  # (rglru, rglru, local) groups
    if fam == "encdec":
        return cfg.n_enc_layers
    return cfg.n_layers


def _with_units(cfg, u: int):
    fam = cfg.family
    cfg = cfg.replace(train_microbatches=1)
    if fam == "moe":
        return cfg.replace(n_layers=cfg.n_dense_layers + u)
    if fam == "hybrid":
        # the reference's analysis-only chunk (it keeps XLA's unrolled
        # chunk count tractable); kept so both count the same program
        return cfg.replace(n_layers=3 * u, ssm_chunk=2048)
    if fam == "encdec":
        return cfg.replace(n_layers=2 * u, n_enc_layers=u, n_dec_layers=u)
    return cfg.replace(n_layers=u)


def count_cell(cfg, shape, mesh=None) -> tuple:
    """(counts, kind, build seconds, count seconds) of ``cfg`` at its own
    depth on ``shape`` (a name or a ``ShapeSpec``), on one card or as this
    rank of ``mesh``."""
    t0 = time.perf_counter()
    cell = specs.make_cell(cfg, shape, mesh)
    t1 = time.perf_counter()
    counts = cost.count(cell["fn"], *cell["args"])
    return counts, cell["kind"], t1 - t0, time.perf_counter() - t1


def _extrapolated(cfg, shape, mesh=None) -> tuple:
    """(counts at ``cfg``'s depth from units 2 and 4, kind, build s,
    count s)."""
    c2, kind, b2, n2 = count_cell(_with_units(cfg, 2), shape, mesh)
    c4, _, b4, n4 = count_cell(_with_units(cfg, 4), shape, mesh)
    return (c2.scaled(c4, (_depth_units(cfg) - 2) / 2.0), kind, b2 + b4,
            n2 + n4)


def corner_ranks(multi_pod: bool) -> tuple:
    """The ranks at coordinate all-0 and all-last of the mesh."""
    n = math.prod(mesh_mod.production_shape(multi_pod).values())
    return (0, n - 1)


def count_on_mesh(cfg, shape, multi_pod: bool) -> dict:
    """{rank: (counts, kind, build s, count s)} of the two corner ranks
    (:func:`corner_ranks`) of the production mesh, each counted as one
    rank of a fake group of the mesh's size."""
    world = math.prod(mesh_mod.production_shape(multi_pod).values())
    out = {}
    for rank in corner_ranks(multi_pod):
        with mesh_mod.fake_group(world, rank):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                 device_type="cpu")
            out[rank] = _extrapolated(cfg, shape, mesh)
    return out


def report(arch_id: str, cfg, shape, counts: cost.Counts, kind: str,
           notes: str, mesh: str = ONE_CARD, chips: int = 1,
           coll=None, coll_seconds: float = None
           ) -> roofline.RooflineReport:
    """``counts`` of ``cfg`` on ``shape`` priced on H100s: one card, or
    one rank of ``mesh`` with its collectives (``coll``: bytes by kind;
    ``coll_seconds``: their time on :data:`roofline.H100_FLEET`)."""
    coll = coll or {}
    return roofline.RooflineReport(
        arch=arch_id, shape=shape.name, mesh=mesh, chips=chips,
        flops_per_device=counts.flops, bytes_per_device=counts.bytes,
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown={k: int(v) for k, v in coll.items()},
        model_flops=roofline.model_flops(cfg, shape, kind),
        bytes_in=counts.args, bytes_out=counts.out,
        bytes_temp=counts.temp, kind=kind,
        model_bytes=(roofline.model_bytes_decode(cfg, shape)
                     if kind == "decode" else 0.0),
        notes=notes, hw=roofline.H100,
        coll_seconds=coll_seconds if mesh != ONE_CARD else None)


_COUNTED = ("FLOPs: FlopCounterMode (matmul-class ops, flash and SSD as the "
            "card's kernels); bytes: operands + results of every op but "
            "views; temp: peak of live result storages")
NOTES = ("meta device, depth-extrapolated (u=2,4; microbatches 1); "
         + _COUNTED + "; priced on " + roofline.H100.name)


def mesh_notes(multi_pod: bool) -> str:
    ranks = corner_ranks(multi_pod)
    return (f"the port's sharded program on meta as ranks {ranks[0]} "
            f"(coordinate all-0) and {ranks[1]} (all-last) of a fake "
            f"{mesh_name(multi_pod)} group, each number the larger of the "
            "two; tensor and sequence parallel on model (each rank keeps "
            "its model block of every leaf whose spec names model, gathers "
            "weights over data alone, holds its block of the sequence "
            "between blocks); depth-extrapolated (u=2,4; microbatches 1); "
            + _COUNTED + "; collectives: each result's bytes on the rank, "
            "an all-gather or reduce-scatter counted under its kind with "
            "the bytes of the all-to-all it is on the wire; priced on "
            + roofline.H100.name + ", each "
            "collective over the slowest link its group crosses on "
            + roofline.H100_FLEET.name + ", ranks row-major"
            + ("; 2x16x16 is the memory pass (args, out, temp), as the "
               "reference's" if multi_pod else ""))


#: one card's memory, the bound a mesh row's bytes a device are held to
CARD_BYTES = 80 * 2 ** 30


def over_card(counts: cost.Counts) -> str:
    """The note of a row whose bytes a device (args, out, temp) pass
    :data:`CARD_BYTES`: the temporaries' largest term at their peak
    (counted at the deeper of the two depths); else nothing."""
    total = counts.args + counts.out + counts.temp
    if total <= CARD_BYTES or not counts.temp_top:
        return ""
    key, n, b = counts.temp_top
    return (f"; {total / 2**30:.2f} GiB a device, over one card's 80 GiB: "
            f"the temporaries' largest term at their peak (u=4) {n} x "
            f"{key}, {b / 2**30:.2f} GiB of {counts.temp / 2**30:.2f}")


def _skip(arch_id, shape_name, mesh):
    return {"arch": arch_id, "shape": shape_name, "mesh": mesh,
            "status": "SKIP(policy)",
            "reason": "long_500k requires sub-quadratic decode "
                      "(DESIGN.md §4)"}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = None,
             verbose: bool = True) -> dict:
    """The row of one cell: on the production mesh (``multi_pod`` False:
    16x16, True: 2x16x16) or on one card (None)."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    mesh = mesh_name(multi_pod)
    if not cfg.supports_shape(shape):
        return _skip(arch_id, shape_name, mesh)
    t0 = time.perf_counter()
    if multi_pod is None:
        counts, kind, build, count = _extrapolated(cfg, shape)
        rep = report(arch_id, cfg, shape, counts, kind, NOTES)
    else:
        per_rank = count_on_mesh(cfg, shape, multi_pod)
        kind = next(iter(per_rank.values()))[1]
        build = sum(v[2] for v in per_rank.values())
        count = sum(v[3] for v in per_rank.values())
        cs = [v[0] for v in per_rank.values()]
        counts = cost.Counts(*(max(getattr(c, f) for c in cs) for f in (
            "flops", "bytes", "args", "out", "temp")))
        counts.temp_top = max(cs, key=lambda c: c.temp).temp_top
        kinds = {k for c in cs for k in c.coll_by_kind()}
        coll = {k: max(c.coll_by_kind().get(k, 0.0) for c in cs)
                for k in sorted(kinds)}
        seconds = max(roofline.H100_FLEET.seconds(c.coll) for c in cs)
        rep = report(arch_id, cfg, shape, counts, kind,
                     mesh_notes(multi_pod) + over_card(counts), mesh,
                     math.prod(mesh_mod.production_shape(multi_pod)
                               .values()), coll, seconds)
    row = rep.to_row()
    # lower_s: building the cells on meta; compile_s: counting them
    row.update(
        status="OK",
        kind=kind,
        lower_s=round(build, 1),
        compile_s=round(count, 1),
        bytes_per_device={"args": int(counts.args), "out": int(counts.out),
                          "temp": int(counts.temp)},
    )
    if multi_pod is not None:
        row["chips"] = rep.chips
    if verbose:
        gb = (counts.args + counts.out + counts.temp) / 2 ** 30
        print(f"[{arch_id} x {shape_name} x {mesh}] OK "
              f"kind={kind} bottleneck={row['bottleneck']} "
              f"c/m/coll(ms)={row['compute_ms']}/{row['memory_ms']}/"
              f"{row['collective_ms']} useful={row['useful_ratio']} "
              f"roofline_frac={row['roofline_fraction']} "
              f"mem/dev={gb:.2f}GiB build={build:.1f}s "
              f"count={count:.1f}s total={time.perf_counter() - t0:.1f}s",
              flush=True)
    return row


def _pim_inputs(n_dpus: int):
    """The reference's full-system cell: (config, binary, WRAM image, MRAM
    image) of VA at scale 1.0 on ``n_dpus`` DPUs, 16 tasklets, 1 MiB."""
    from repro_torch.core.config import DPUConfig
    from repro_torch.workloads import get

    cfg = DPUConfig(n_dpus=n_dpus, n_tasklets=16, mram_bytes=1 << 20)
    W = get("VA")
    hd = W.host_data(cfg, scale=1.0, seed=0)
    binary = W.build(16).binary(cfg.iram_instrs)
    wram = np.zeros((n_dpus, 16), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    return cfg, binary, wram, hd.mram


def run_pim_cell(device=None, n_dpus: int = 2560,
                 multi_pod: bool = None) -> dict:
    """The paper's own architecture as a dry-run cell: one full UPMEM
    system (2,560 DPUs, 16 tasklets, 1 MiB MRAM, VA at scale 1.0).

    One card (``multi_pod`` None): built on ``device`` (None: the card)
    and one ``cycle_step`` launch of 64 steps (on the CPU, 64 steps of its
    plain version); the state's bytes (padded to the driver's DPU bucket;
    updated in place, so ``out`` is the same) and as temp what the card
    allocates over the launch (``max_memory_allocated``; not measured on
    the CPU).

    A production mesh: the DPU axis split over every rank
    (``compile_cache``'s sharded driver, 10 DPUs a rank on 16x16, 5 on
    2x16x16), counted as the corner ranks of a fake group on meta: each
    rank's state bytes (padded to the driver's bucket), and the consensus
    that its K-block ends with (one all-reduce, ``compile_cache
    .consensus``), whose bytes over K are the collective bytes a cycle."""
    from repro_torch.core import compile_cache
    from repro_torch.kernels.cycle_step import ops as step_ops

    device = resolve_device(device)
    if multi_pod is not None:
        return _pim_mesh_row(multi_pod, n_dpus)
    cfg, binary, wram, mram = _pim_inputs(n_dpus)
    t0 = time.perf_counter()
    prep = compile_cache.prepare(cfg, binary, wram, mram, 16,
                                 device=device)
    state = cost.tree_bytes(prep.st)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    launches = step_ops.launches
    prep.advance(compile_cache.STEPS_PER_CHECK)
    temp = None
    if cuda:
        torch.cuda.synchronize(device)
        temp = torch.cuda.max_memory_allocated(device) - base
    row = {
        "arch": f"pim-engine({n_dpus} DPUs, VA kernel)", "shape": "fleet_sim",
        "mesh": ONE_CARD, "status": "OK", "kind": "simulate",
        "collective_bytes_per_cycle": {},
        "bytes_per_device": {"args": state, "out": state, "temp": temp},
        "cycle_step_launches": step_ops.launches - launches,
        "device": str(device),
        "prepare_launch_s": round(time.perf_counter() - t0, 3),
        "notes": f"state padded to {prep.st['status'].shape[0]} DPUs; one "
                 f"launch of {compile_cache.STEPS_PER_CHECK} steps; temp: "
                 + ("max_memory_allocated over it" if cuda else
                    "not measured (CPU)") + "; one card, no collective",
    }
    print(f"[pim-engine x fleet_sim x {ONE_CARD}] OK "
          f"state={state / 2**30:.3f}GiB temp={temp} "
          f"launches={row['cycle_step_launches']} "
          f"{row['prepare_launch_s']}s", flush=True)
    return row


def _pim_mesh_row(multi_pod: bool, n_dpus: int) -> dict:
    from repro_torch.core import compile_cache
    from repro_torch.parallel import collectives as coll

    axes = mesh_mod.production_shape(multi_pod)
    world = math.prod(axes.values())
    mesh = mesh_name(multi_pod)
    cfg, binary, wram, mram = _pim_inputs(n_dpus)
    K = compile_cache.STEPS_PER_CHECK
    t0 = time.perf_counter()
    state, sent, per_dpus = 0, {}, set()
    for rank in corner_ranks(multi_pod):
        with mesh_mod.fake_group(world, rank):
            group = torch.distributed.group.WORLD
            lo, hi = compile_cache.dpu_block(n_dpus, world, rank)
            per_dpus.add(hi - lo)
            shard = compile_cache.Shard(cfg, binary, wram, mram, 16, group,
                                        device="meta")
            state = max(state, cost.tree_bytes(shard.st))
            before = dict(coll.BY_GROUP)
            shard.consensus()
            for (kind, members), b in coll.BY_GROUP.items():
                got = b - before.get((kind, members), 0)
                if got:
                    sent[kind] = max(sent.get(kind, 0), got)
    row = {
        "arch": f"pim-engine({n_dpus} DPUs, VA kernel)", "shape": "fleet_sim",
        "mesh": mesh, "chips": world, "status": "OK", "kind": "simulate",
        "collective_bytes_per_cycle": {k: v / K for k, v in sent.items()},
        "bytes_per_device": {"args": state, "out": state, "temp": None},
        "dpus_per_device": sorted(per_dpus),
        "compile_s": round(time.perf_counter() - t0, 1),
        "notes": f"the DPU axis split over the {world} ranks "
                 f"({'/'.join(map(str, sorted(per_dpus)))} DPUs a rank), "
                 "counted as ranks 0 and the last of a fake group on meta; "
                 "args/out: a rank's state padded to the driver's DPU "
                 "bucket (updated in place); temp not measured (meta); "
                 "collective: one all-reduce a K-block of "
                 f"{K} steps (the vote whether any DPU runs, each step's "
                 "go bit, and each step's and issue slot's wide-DMA bit: "
                 "a DMA's copy window is set by every DPU's widest DMA of "
                 "its slot, so the DPUs are not independent), its bytes "
                 f"over {K}",
    }
    print(f"[pim-engine x fleet_sim x {mesh}] OK "
          f"coll/cycle={row['collective_bytes_per_cycle']} "
          f"state={state / 2**30:.4f}GiB", flush=True)
    return row


def _row_path(out: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out, f"{arch}__{shape}__{SUFFIX[mesh]}.json")


def _cell_job(job) -> tuple:
    """(path, row, failed) of one LM cell: ``job`` is (arch, shape,
    multi_pod, out)."""
    arch, shape, multi_pod, out = job
    mesh = mesh_name(multi_pod)
    try:
        row, failed = run_cell(arch, shape, multi_pod), False
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        row = {"arch": arch, "shape": shape, "mesh": mesh,
               "status": f"FAIL: {type(e).__name__}: {e}"}
        failed = True
    return _row_path(out, arch, shape, mesh), row, failed


def _pim_job(job) -> tuple:
    multi_pod, device, out = job
    mesh = mesh_name(multi_pod)
    path = os.path.join(out, f"pim-engine__fleet_sim__{SUFFIX[mesh]}.json")
    try:
        return path, run_pim_cell(device, multi_pod=multi_pod), False
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        return path, {"arch": "pim-engine", "mesh": mesh,
                      "status": f"FAIL: {e}"}, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="an architecture (repeat for several; default: "
                         "all)")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (with neither this nor "
                         "--single-pod: both)")
    ap.add_argument("--single-pod", action="store_true",
                    help="the 16x16 mesh")
    ap.add_argument("--mesh", default=None, choices=(ONE_CARD,),
                    help="1x1: the one-card rows instead of the meshes'")
    ap.add_argument("--with-pim", action="store_true",
                    help="the PIM cell's rows with --arch too")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each in a process of its "
                         "own")
    ap.add_argument("--out", default="reports/torch_dryrun")
    ap.add_argument("--device", default=None,
                    help="torch device of the one-card PIM cell (default: "
                         "the CUDA card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.mesh == ONE_CARD:
        meshes = [None]
    else:
        meshes = []
        if args.single_pod or not args.multi_pod:
            meshes.append(False)
        if args.multi_pod or not args.single_pod:
            meshes.append(True)
    archs = args.arch or list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    results = []
    if not args.arch or args.with_pim:
        # the paper's own architecture: the PIM engine
        results += [_pim_job((m, device, args.out)) for m in meshes]
    jobs = [(a, s, m, args.out) for m in meshes for a in archs
            for s in shapes]
    if args.jobs > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(args.jobs, len(jobs))) as pool:
            results += pool.map(_cell_job, jobs, chunksize=1)
    else:
        results += [_cell_job(j) for j in jobs]
    failures = 0
    for path, row, failed in results:
        failures += failed
        with open(path, "w") as f:
            json.dump(row, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f}s; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
