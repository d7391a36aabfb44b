"""Workload interface for the PrIM-style benchmark suite (paper Table II).

Every workload provides:
  * ``build(n_tasklets, cache_mode)``  -> a :class:`Program` (the "DPU-side
    source"); ``cache_mode=True`` emits the direct-addressing variant used
    by the cache-vs-scratchpad case study (no DMA staging — loads/stores
    address the data directly, the linker maps it onto the DRAM-backed
    space, exactly the paper's §V-D methodology);
  * ``host_data(cfg, scale, seed)``    -> per-DPU args + MRAM images +
    transfer byte counts + an output checker (numpy oracle);
  * ``run(system, n_threads, ...)``    -> orchestrates (possibly multi-)
    kernel execution incl. host transfers, returns a KernelReport.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.asm import Program, Reg
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import PIMSystem

BLK = 1024  # streaming DMA block (bytes), PrIM-style staging granularity


@dataclass
class HostData:
    args: np.ndarray                  # (D, n_args) int32
    mram: np.ndarray                  # (D, mram_words) int32
    h2d_bytes: float                  # per-DPU input bytes
    d2h_bytes: float                  # per-DPU output bytes
    check: Callable[[np.ndarray], bool]  # mram_out (D, words) -> ok
    extra: Dict = None


class Workload:
    name: str = "?"
    sync_heavy: bool = False

    #: default per-DPU element count (scaled-down from Table II so the full
    #: suite runs in CI time; benchmarks accept --scale to restore Table II)
    default_n: int = 16_384

    def build(self, n_tasklets: int, cache_mode: bool = False) -> Program:
        raise NotImplementedError

    def host_data(self, cfg: DPUConfig, scale: float = 1.0, seed: int = 0
                  ) -> HostData:
        raise NotImplementedError

    def n_elems(self, scale: float) -> int:
        # divisible by every supported tasklet count (1..16, 24)
        n = int(self.default_n * scale)
        return max(n // 48, 2) * 48

    def run(self, system: PIMSystem, n_threads: int, scale: float = 1.0,
            seed: int = 0, cache_mode: bool = False, pipeline: int = 0):
        """Public entry point for every workload.  ``pipeline=N`` (N > 1)
        switches to the double-buffered batch mode for any workload;
        subclasses customize execution by overriding :meth:`_run`, never
        this dispatcher."""
        if pipeline > 1:
            st, rep, _ = self.run_pipelined(system, n_threads,
                                            n_batches=pipeline, scale=scale,
                                            seed=seed, cache_mode=cache_mode)
            return st, rep
        return self._run(system, n_threads, scale, seed, cache_mode)

    def _run(self, system: PIMSystem, n_threads: int, scale: float = 1.0,
             seed: int = 0, cache_mode: bool = False):
        hd = self.host_data(system.cfg, scale, seed, cache_mode=cache_mode)
        prog = self.build(n_threads, cache_mode=cache_mode)
        binary = prog.binary(system.cfg.iram_instrs)
        system.h2d(hd.h2d_bytes)
        if cache_mode:
            # the linker maps the data into the DRAM-backed direct space
            # (engine WRAM array); MRAM stays empty (paper §V-D relink)
            D = system.cfg.n_dpus
            mram = np.zeros((D, 2), np.int32)
            st, rep = self.recover_launch(system, self.name, binary,
                                          hd.args, mram,
                                          n_threads=n_threads,
                                          wram_extra=hd.mram)
            mem = np.asarray(st["wram"])
        else:
            st, rep = self.recover_launch(system, self.name, binary,
                                          hd.args, hd.mram,
                                          n_threads=n_threads)
            mem = np.asarray(st["mram"])
        if not hd.check(mem):
            raise AssertionError(f"{self.name}: output mismatch vs oracle")
        self.readback(system, hd, mem)
        return st, rep

    def recover_launch(self, system: PIMSystem, name: str, binary, args,
                       mram, *, n_threads=None, wram_extra=None, dpus=None,
                       ndpus_reg=None):
        """Launch with the system's fault-recovery policy.

        Fault-free systems go straight to :meth:`PIMSystem.launch`
        (bit-exact with pre-fault builds).  Under a fault plan,
        ``recovery="raise"`` is fail-stop (faults propagate as
        :class:`~repro_torch.faults.model.DpuFaultError`) and ``"remap"``
        re-executes lost shards on surviving DPUs via
        :func:`repro_torch.faults.remap.launch_with_remap` — workloads whose
        kernels are arg-addressed get degraded-mode execution for free
        by routing launches through this hook.  That module is not
        ported yet, so ``"remap"`` raises :class:`NotImplementedError`."""
        if system.faults is None:
            return system.launch(name, binary, args, mram,
                                 n_threads=n_threads, wram_extra=wram_extra,
                                 dpus=dpus)
        if system.recovery == "raise":
            return system.launch(name, binary, args, mram,
                                 n_threads=n_threads, wram_extra=wram_extra,
                                 dpus=dpus, ndpus_reg=ndpus_reg)
        raise NotImplementedError(
            f"{name}: recovery='remap' needs repro_torch.faults.remap, which "
            "is not ported yet (ROADMAP.md, modules still to port: "
            "faults/remap); use recovery='raise' or the JAX package")

    def readback(self, system: PIMSystem, hd: HostData, mem: np.ndarray):
        """Post-kernel epilogue: charge the host readback. Subclasses may
        first merge inter-DPU state through ``repro_torch.comm`` collectives."""
        system.d2h(hd.d2h_bytes)

    def run_pipelined(self, system: PIMSystem, n_threads: int,
                      n_batches: int = 4, scale: float = 1.0, seed: int = 0,
                      cache_mode: bool = False, buffers: int = 2):
        """Double-buffered batch mode: ``n_batches`` independent instances
        (seeds ``seed..seed+n_batches-1``), each on its own stream, so an
        async system overlaps staging/readback with other batches'
        kernels.  Returns ``(last_state, merged_report, schedule)``."""
        from repro_torch.sched.pipeline import run_pipelined
        return run_pipelined(self, system, n_threads, n_batches=n_batches,
                             scale=scale, seed=seed, buffers=buffers,
                             cache_mode=cache_mode)


# ---------------------------------------------------------------------------
# shared program fragments
# ---------------------------------------------------------------------------


def tasklet_slice(p: Program, n_reg: Reg, start: Reg, count: Reg):
    """start = tid * (n/NT); count = n/NT  (n divisible by NT assumed)."""
    from repro_torch.core.asm import N_TASKLETS, TID
    p.div(count, n_reg, N_TASKLETS)
    p.mul(start, TID, count)


def dma_block_loop(p: Program, body, *, cur: Reg, end: Reg, blk_bytes: int = BLK):
    """for cur in range(cur, end, blk_elems): body(n_bytes_reg).

    ``cur``/``end`` are element indices; body receives a register holding
    this block's byte count (min(BLK, 4*(end-cur))).
    """
    nb = p.reg("nb")
    top, done = p.newlabel("blk"), p.newlabel("blkend")
    p.label(top)
    p.bge(cur, end, done)
    rem = p.reg("rem")
    p.sub(rem, end, cur)
    p.sll(rem, rem, 2)
    p.li(nb, blk_bytes)
    skip = p.newlabel("min")
    p.bge(rem, nb, skip)
    p.mv(nb, rem)
    p.label(skip)
    body(nb)
    elems = p.reg("elems")
    p.srl(elems, nb, 2)
    p.add(cur, cur, elems)
    p.free(rem, elems)
    p.jump(top)
    p.label(done)
    p.free(nb)


def wram_loop(p: Program, body, *, addr: Reg, n_bytes: Reg, step: int = 4):
    """Iterate ``addr`` over [addr, addr+n_bytes) in ``step`` strides."""
    endr = p.reg("endr")
    p.add(endr, addr, n_bytes)
    top, done = p.newlabel("w"), p.newlabel("wend")
    p.label(top)
    p.bge(addr, endr, done)
    body()
    p.add(addr, addr, step)
    p.jump(top)
    p.label(done)
    p.free(endr)
