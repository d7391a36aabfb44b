"""Graceful degradation: remap dead DPUs' shards onto survivors.

:func:`launch_with_remap` wraps :meth:`PIMSystem.launch` with a recovery
loop: the primary launch runs degraded on whatever DPUs are still alive,
and the shards of lanes that were already dead (or died mid-kernel) are
re-executed on surviving lanes — spare lanes first, then live workers —
by *relocating the shard's args/MRAM rows to the survivor's lane* and
launching the survivor subset.  Each recovery round is an ordinary
subset launch through the compiled-engine cache, so it lands in a warm
power-of-two DPU bucket instead of recompiling.

Two properties make this sound for the workloads that use it:

* Kernels must be **arg-addressed**: a shard's work is defined entirely
  by its WRAM args and MRAM image, not by the ``DPU_ID`` register (true
  for BFS/HST/SSORT — BFS carries per-DPU vertex ranges in its args).
* Kernels that read ``N_DPUS`` (SSORT's merge phase sizes its bucket
  loop with it) get the **pre-fault logical width** via the
  ``ndpus_reg`` register override, so a shard re-executed on a survivor
  computes exactly what the dead lane would have.

With ``ckpt_dir`` (or ``system.ckpt_dir``) set, the launch inputs are
checkpointed through :mod:`repro_torch.ckpt.store` before execution and the
recovery rounds restore them by step — re-executing *only the lost
shards* from durable state, the cluster-runtime recovery flow.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.faults.model import DpuFaultError, FaultReport


def launch_with_remap(system, name: str, binary, args: np.ndarray,
                      mram: np.ndarray, *, n_threads: Optional[int] = None,
                      wram_extra: Optional[np.ndarray] = None,
                      dpus: Optional[Sequence[int]] = None,
                      ndpus_reg: Optional[int] = None,
                      spares: Sequence[int] = (),
                      ckpt_dir: Optional[str] = None,
                      max_rounds: int = 8):
    """Degraded launch + shard re-execution; returns ``(state, report)``.

    The returned state has one row per *requested* DPU (like a plain
    subset launch) with every shard's results present — computed either
    in place or by a survivor.  ``spares`` names lanes preferred as
    recovery targets (a spare-DPU provisioning policy); dead spares are
    skipped.  Raises :class:`DpuFaultError` when no survivor remains or
    ``max_rounds`` recovery rounds still leave shards unexecuted."""
    D = system.cfg.n_dpus
    if dpus is not None:
        requested = sorted({int(d) for d in dpus})
        if not requested:
            raise ValueError("dpus subset must not be empty")
    else:
        requested = list(range(D))
    logical_n = int(ndpus_reg) if ndpus_reg is not None else len(requested)

    ckpt_dir = ckpt_dir or getattr(system, "ckpt_dir", None)
    if ckpt_dir is not None:
        from repro_torch.ckpt import store
        step = system._launch_idx  # upcoming launch index names the step
        store.save(ckpt_dir, step, {"args": args, "mram": mram})
        # the recovery rounds below re-read the inputs from the durable
        # checkpoint, proving lost shards are re-executable from storage
        restored, _ = store.restore(
            ckpt_dir, {"args": args, "mram": mram}, step=step)
        args, mram = restored["args"], restored["mram"]

    # primary attempt: run on whatever survives; only pass the register
    # override when genuinely degraded so the fault-free path stays
    # bit-exact with a plain launch
    pre_alive = [d for d in requested if system.active_mask[d]]
    reg = logical_n if (ndpus_reg is not None
                        or len(pre_alive) < len(requested)) else None
    st, rep = system.launch(name, binary, args, mram, n_threads=n_threads,
                            wram_extra=wram_extra, dpus=dpus, degraded=True,
                            ndpus_reg=reg)
    info = system.last_launch_faults
    if info is None or (not info["lost"] and not info["dead_before"]):
        return st, rep

    pos = {d: i for i, d in enumerate(requested)}
    pending = sorted(set(info["lost"]) | set(info["dead_before"]))
    reports = [rep]
    for round_no in range(max_rounds):
        if not pending:
            break
        live_spares = [s for s in spares if system.active_mask[int(s)]]
        workers = [d for d in requested if system.active_mask[d]]
        pool = list(dict.fromkeys([int(s) for s in live_spares] + workers))
        if not pool:
            raise DpuFaultError(FaultReport(
                kind="no_active_dpus", label=name,
                dpus=tuple(pending),
                detail="remap found no surviving DPU to host lost shards"))
        # place each lost shard on a survivor lane (round-robin over the
        # pool); relocating the rows is what makes the kernel re-execute
        # the dead lane's work
        placement = [(shard, pool[i % len(pool)])
                     for i, shard in enumerate(pending)]
        if getattr(system, "tracer", None) is not None:
            system.tracer.instant(
                f"remap:{name}", system.timeline.total, track="recovery",
                args={"round": round_no, "shards": list(pending),
                      "lanes": sorted({lane for _, lane in placement}),
                      "spares_used": [s for s in live_spares
                                      if s in {L for _, L in placement}]})
        args2, mram2 = np.array(args), np.array(mram)
        wram2 = None if wram_extra is None else np.array(wram_extra)
        for shard, lane in placement:
            args2[lane] = args[shard]
            mram2[lane] = mram[shard]
            if wram2 is not None:
                wram2[lane] = wram_extra[shard]
        lanes = sorted({lane for _, lane in placement})
        st2, rep2 = system.launch(
            name, binary, args2, mram2, n_threads=n_threads,
            wram_extra=wram2, dpus=lanes, degraded=True,
            ndpus_reg=logical_n)
        reports.append(rep2)
        info2 = system.last_launch_faults
        executed = set(info2["executed"]) if info2 is not None else set(lanes)
        # subset-state row i is the i-th smallest launched lane
        row_of = {lane: i for i, lane in enumerate(lanes)}
        done = []
        # sort by lane so two shards on one lane can't both claim it --
        # only the placement that owns the lane this round copies back
        lane_owner = {lane: shard for shard, lane in placement}
        for lane, shard in sorted(lane_owner.items()):
            if lane in executed:
                for k, v in st.items():
                    v[pos[shard]] = st2[k][row_of[lane]]
                done.append(shard)
        pending = sorted(set(pending) - set(done))
    if pending:
        raise DpuFaultError(FaultReport(
            kind="retry_exhausted", label=name, dpus=tuple(pending),
            detail=f"{len(pending)} shards still unexecuted after "
                   f"{max_rounds} remap rounds"))
    from repro_torch.core.host import merge_reports
    return st, (reports[0] if len(reports) == 1
                else merge_reports(name, reports))
