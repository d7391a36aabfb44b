"""One-card dry-run: count every (arch x shape) cell on the meta device and
price it on an NVIDIA H100.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 512 host devices and reads XLA's cost and memory analyses.  The
port's cell is one card, so:

* each cell's real function (the train step with the configuration's
  optimizer and remat, prefill, or one decode step) runs on the meta
  device at the configuration's published width, under
  ``launch/cost.py``'s counters (FLOPs, bytes accessed, the arguments',
  results' and temporaries' bytes);
* as in the reference, depth is extrapolated linearly from two reduced
  depths (units 2 and 4 of :func:`_depth_units`, microbatches 1): the
  port's layers are a Python loop, so the counts are exactly linear in
  units where the units are whole;
* the counts are priced with ``launch/roofline.py``'s :data:`H100` data-sheet
  peaks on the mesh the port has, ``1x1``: one chip, no collectives.
  ``--multi-pod`` says so and exits non-zero: no row names a mesh that was
  not priced;
* :func:`run_pim_cell` builds the reference's full-system cell (2,560 DPUs,
  VA) on the card and launches ``cycle_step`` once (64 steps).

Every entry point runs on the card unless ``--device cpu`` asks for the
CPU (the LM cells are counted on meta either way; the device runs the PIM
cell).  A cell that fails makes the sweep exit non-zero.

    python -m repro_torch.launch.dryrun [--arch a] [--shape s]
        [--out reports/torch_dryrun] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.core.carry import resolve_device
from repro_torch.launch import cost, roofline, specs

#: the mesh every row is priced on: one card
MESH = "1x1"
CHIPS = 1


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


def count_cell(cfg, shape) -> tuple:
    """(counts, kind, build seconds, count seconds) of ``cfg`` at its own
    depth on ``shape`` (a name or a ``ShapeSpec``)."""
    t0 = time.perf_counter()
    cell = specs.make_cell(cfg, shape)
    t1 = time.perf_counter()
    counts = cost.count(cell["fn"], *cell["args"])
    return counts, cell["kind"], t1 - t0, time.perf_counter() - t1


def report(arch_id: str, cfg, shape, counts: cost.Counts, kind: str,
           notes: str) -> roofline.RooflineReport:
    """``counts`` of ``cfg`` on ``shape`` priced on one H100."""
    return roofline.RooflineReport(
        arch=arch_id, shape=shape.name, mesh=MESH, chips=CHIPS,
        flops_per_device=counts.flops, bytes_per_device=counts.bytes,
        coll_bytes_per_device=0.0, coll_breakdown={},
        model_flops=roofline.model_flops(cfg, shape, kind),
        bytes_in=counts.args, bytes_out=counts.out,
        bytes_temp=counts.temp, kind=kind,
        model_bytes=(roofline.model_bytes_decode(cfg, shape)
                     if kind == "decode" else 0.0),
        notes=notes, hw=roofline.H100)


NOTES = ("meta device, depth-extrapolated (u=2,4; microbatches 1); FLOPs: "
         "FlopCounterMode (matmul-class ops, flash as the card's kernel); "
         "bytes: operands + results of every op but views; temp: peak of "
         "live result storages; priced on " + roofline.H100.name)


def run_cell(arch_id: str, shape_name: str, verbose: bool = True) -> dict:
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return {"arch": arch_id, "shape": shape_name, "mesh": MESH,
                "status": "SKIP(policy)",
                "reason": "long_500k requires sub-quadratic decode "
                          "(DESIGN.md §4)"}
    t0 = time.perf_counter()
    u_t = _depth_units(cfg)
    c2, kind, b2, n2 = count_cell(_with_units(cfg, 2), shape)
    c4, _, b4, n4 = count_cell(_with_units(cfg, 4), shape)
    counts = c2.scaled(c4, (u_t - 2) / 2.0)
    rep = report(arch_id, cfg, shape, counts, kind, NOTES)
    row = rep.to_row()
    # lower_s: building the two cells on meta; compile_s: counting them
    row.update(
        status="OK",
        kind=kind,
        lower_s=round(b2 + b4, 1),
        compile_s=round(n2 + n4, 1),
        bytes_per_device={"args": int(counts.args), "out": int(counts.out),
                          "temp": int(counts.temp)},
    )
    if verbose:
        gb = (counts.args + counts.out + counts.temp) / 2 ** 30
        print(f"[{arch_id} x {shape_name} x {MESH}] OK "
              f"kind={kind} bottleneck={row['bottleneck']} "
              f"c/m/coll(ms)={row['compute_ms']}/{row['memory_ms']}/"
              f"{row['collective_ms']} useful={row['useful_ratio']} "
              f"roofline_frac={row['roofline_fraction']} "
              f"mem/dev={gb:.2f}GiB build={b2 + b4:.1f}s "
              f"count={n2 + n4:.1f}s total={time.perf_counter() - t0:.1f}s",
              flush=True)
    return row


def run_pim_cell(device=None, n_dpus: int = 2560) -> dict:
    """The paper's own architecture as a dry-run cell: one full UPMEM
    system (2,560 DPUs, 16 tasklets, 1 MiB MRAM, VA at scale 1.0) built on
    ``device`` (None: the card) and one ``cycle_step`` launch of 64 steps
    (on the CPU, 64 steps of its plain version).  Reports the state's
    bytes (padded to the driver's DPU bucket; updated in place, so ``out``
    is the same) and as temp what the card allocates over the launch
    (``max_memory_allocated``; not measured on the CPU).  One card: no
    collective."""
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.workloads import get

    device = resolve_device(device)
    cfg = DPUConfig(n_dpus=n_dpus, n_tasklets=16, mram_bytes=1 << 20)
    W = get("VA")
    hd = W.host_data(cfg, scale=1.0, seed=0)
    binary = W.build(16).binary(cfg.iram_instrs)
    wram = np.zeros((n_dpus, 16), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    t0 = time.perf_counter()
    prep = compile_cache.prepare(cfg, binary, wram, hd.mram, 16,
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
        "mesh": MESH, "status": "OK", "kind": "simulate",
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
    print(f"[pim-engine x fleet_sim x {MESH}] OK state={state / 2**30:.3f}"
          f"GiB temp={temp} launches={row['cycle_step_launches']} "
          f"{row['prepare_launch_s']}s", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="not priced: the port has one card")
    ap.add_argument("--out", default="reports/torch_dryrun")
    ap.add_argument("--device", default=None,
                    help="torch device of the PIM cell (default: the CUDA "
                         "card; cpu asks for the CPU)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        print("--multi-pod: the port prices one card (mesh 1x1); no "
              "multi-pod mesh is counted")
        return 2
    device = resolve_device(args.device)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t0 = time.perf_counter()
    if not args.arch:
        # the paper's own architecture: the PIM engine on the card
        path = os.path.join(args.out, "pim-engine__fleet_sim__sp.json")
        try:
            row = run_pim_cell(device)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            row = {"arch": "pim-engine", "status": f"FAIL: {e}"}
            failures += 1
        with open(path, "w") as f:
            json.dump(row, f, indent=1)
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__sp"
            path = os.path.join(args.out, tag + ".json")
            try:
                row = run_cell(arch, shape)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                row = {"arch": arch, "shape": shape, "mesh": MESH,
                       "status": f"FAIL: {type(e).__name__}: {e}"}
                failures += 1
            with open(path, "w") as f:
                json.dump(row, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f}s; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
