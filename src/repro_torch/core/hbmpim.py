"""HBM-PIM all-bank execution backends (the paper's pathfinding target),
in torch: the port of :mod:`repro.core.hbmpim`.

Samsung's HBM-PIM (Aquabolt-XL/FIMDRAM) sits at the opposite corner of
the PIM design space from UPMEM: instead of thousands of independently
programmed scalar DPUs, every bank hosts one SIMD FP/ALU pipe and *all
banks execute the same microcoded command stream in lockstep* (all-bank
mode), driven by a tiny Command Register File (CRF) and per-bank vector
(GRF) / scalar (SRF) register files.  This module models that target on
top of the same compile-cache/`Timeline`/`KernelReport` machinery as the
UPMEM engines, registered as two :class:`repro_torch.core.backend.ExecBackend`
implementations:

* ``"hbmpim"`` (:class:`AllBankBackend`) — the *compat* target: runs
  unmodified uPIM binaries in all-bank lockstep by executing them on the
  SIMT engine with one warp as wide as the whole tasklet set and DMA
  coalescing always on.  This is how the existing workloads (BFS, SSORT,
  ...) run on the second architecture without touching a line of kernel
  code: ``DPUConfig(backend="hbmpim")`` and launch as usual.
* ``"hbmpim_cmd"`` (:class:`CmdBackend`) — the *native* target: a
  bank-level command-stream model executing :class:`CrfProgram` μcode
  (NOP/EXIT/JUMP/MOV/FILL/ADD/MUL/MAC over BANK/GRF_A/GRF_B/SRF
  operands) with open-row timing per bank access.  Launched through
  :func:`launch_commands`, which charges the host timeline exactly like
  ``PIMSystem.launch``.

Geometry knobs live on :class:`~repro.core.config.DPUConfig`:
``hbm_lanes`` (SIMD lanes per bank = words per GRF register / bank row
burst) and ``hbm_crf_slots`` (CRF capacity; programs that exceed it are
rejected by :meth:`CmdBackend.validate`).

The command step (:func:`make_cmd_step`) is the reference's bit for bit,
gated on ``go`` (some bank runs) so that a step after the run ended
changes nothing; int32 products wrap as XLA's do.  On the card the
driver runs the hand-written kernel :mod:`repro_torch.kernels.crf_step`,
K commands a launch, and this step is its plain version; the compat
target runs on :mod:`repro_torch.kernels.simt_step`.
"""
from __future__ import annotations

import enum
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core import engine, isa, simt
from repro_torch.core.carry import resolve_device
from repro_torch.core.config import DPUConfig


# ---------------------------------------------------------------------------
# native command model: CRF opcodes + operand encoding
# ---------------------------------------------------------------------------


class CmdOp(enum.IntEnum):
    """HBM-PIM CRF microcode (the Aquabolt-XL command set, integerized)."""

    NOP = 0
    EXIT = 1
    JUMP = 2      # imm = target slot, ra = extra trips (raw count, no kind)
    MOV = 3       # dst <- a
    FILL = 4      # dst <- a  (bank->GRF spelling of MOV; same semantics)
    ADD = 5       # dst <- a + b
    MUL = 6       # dst <- a * b
    MAC = 7       # dst <- dst + a * b


#: operand kinds (top byte of an operand code)
K_BANK, K_GRF_A, K_GRF_B, K_SRF = 0, 1, 2, 3

_IDX_MASK = 0xFFFFFF


def bank(row: int) -> int:
    """Bank operand: one ``hbm_lanes``-word burst at MRAM row ``row``."""
    return (K_BANK << 24) | (int(row) & _IDX_MASK)


def grf_a(i: int) -> int:
    """Vector register GRF_A[i] (8 regs x ``hbm_lanes`` words)."""
    return (K_GRF_A << 24) | (int(i) & 7)


def grf_b(i: int) -> int:
    """Vector register GRF_B[i]."""
    return (K_GRF_B << 24) | (int(i) & 7)


def srf(i: int) -> int:
    """Scalar register SRF[i], broadcast across the SIMD lanes."""
    return (K_SRF << 24) | (int(i) & 7)


class CrfProgram:
    """Builder for a CRF command stream.

    ``jump(target, times)`` re-enters ``target`` ``times`` extra trips
    (total body iterations = ``times + 1`` when the jump is backward to
    the body start); the single hardware loop counter means jumps don't
    nest.  ``here()`` is the next slot index — take it before emitting a
    loop body to get the jump target."""

    def __init__(self):
        self._ops = []

    def _emit(self, op: CmdOp, rd=0, ra=0, rb=0, imm=0) -> int:
        self._ops.append((int(op), int(rd), int(ra), int(rb), int(imm)))
        return len(self._ops) - 1

    def here(self) -> int:
        return len(self._ops)

    @property
    def n_instrs(self) -> int:
        return len(self._ops)

    def nop(self):
        return self._emit(CmdOp.NOP)

    def mov(self, dst: int, src: int):
        return self._emit(CmdOp.MOV, dst, src)

    def fill(self, dst: int, src: int):
        return self._emit(CmdOp.FILL, dst, src)

    def add(self, dst: int, a: int, b: int):
        return self._emit(CmdOp.ADD, dst, a, b)

    def mul(self, dst: int, a: int, b: int):
        return self._emit(CmdOp.MUL, dst, a, b)

    def mac(self, dst: int, a: int, b: int):
        return self._emit(CmdOp.MAC, dst, a, b)

    def jump(self, target: int, times: int):
        return self._emit(CmdOp.JUMP, ra=int(times), imm=int(target))

    def exit_(self):
        return self._emit(CmdOp.EXIT)

    def binary(self, capacity: int) -> isa.Binary:
        """Pack into an :class:`isa.Binary` image of ``capacity`` slots.

        Padding slots are ``EXIT`` (not the uPIM assembler's ``STOP``,
        which is outside the CRF opcode range), so a fall-through off the
        program end terminates cleanly."""
        n = len(self._ops)
        cap = max(int(capacity), n)
        opcode = np.full(cap, int(CmdOp.EXIT), np.int32)
        rd = np.zeros(cap, np.int32)
        ra = np.zeros(cap, np.int32)
        rb = np.zeros(cap, np.int32)
        imm = np.zeros(cap, np.int32)
        use_imm = np.zeros(cap, np.int32)
        for i, (op, d, a, b, m) in enumerate(self._ops):
            opcode[i], rd[i], ra[i], rb[i], imm[i] = op, d, a, b, m
        return isa.Binary(opcode, rd, ra, rb, imm, use_imm, n, {})


# ---------------------------------------------------------------------------
# native command-stream engine (vectorized over DPUs=banks)
# ---------------------------------------------------------------------------


def make_cmd_state_np(cfg: DPUConfig, binary, wram_init, mram_init,
                      n_threads: int = 1) -> Dict:
    """Initial all-bank state.  ``wram_init``'s first 8 columns seed the
    SRF (the host broadcasts scalars there, mirroring the real part's
    mode-register writes); the full UPMEM counter set is carried (zeros
    where the concept doesn't apply) so ``stats.report_from_state`` and
    the compile cache's padding/readback work unchanged."""
    D = cfg.n_dpus
    W = cfg.hbm_lanes
    T = n_threads or 1
    srf0 = np.zeros((D, 8), np.int32)
    w = np.asarray(wram_init, np.int32)
    if w.size:
        k = min(8, w.shape[1])
        srf0[:, :k] = w[:, :k]
    return {
        "cycle": np.zeros(D, np.int32),
        "pc": np.zeros(D, np.int32),
        "status": np.full((D, 1), engine.RUN, np.int32),
        "loop_left": np.full(D, -1, np.int32),
        "open_row": np.full(D, -1, np.int32),
        "grf_a": np.zeros((D, 8, W), np.int32),
        "grf_b": np.zeros((D, 8, W), np.int32),
        "srf": srf0,
        "mram": np.asarray(mram_init, np.int32),
        # counters (UPMEM-compatible so KernelReport works unchanged)
        "c_active": np.zeros(D, np.int32),
        "c_idle_mem": np.zeros(D, np.int32),
        "c_idle_rev": np.zeros(D, np.int32),
        "c_idle_rf": np.zeros(D, np.int32),
        "c_issued": np.zeros(D, np.int32),
        "c_cls": np.zeros((D, 6), np.int32),
        "c_hist": np.zeros((D, T + 1), np.int32),
        "c_dma_rd": np.zeros(D, np.int32),
        "c_dma_wr": np.zeros(D, np.int32),
        "c_dma_rd_bytes": np.zeros(D, np.float32),
        "c_dma_wr_bytes": np.zeros(D, np.float32),
        "c_row_hit": np.zeros(D, np.int32),
        "c_row_miss": np.zeros(D, np.int32),
        "c_tlb_hit": np.zeros(D, np.int32),
        "c_tlb_miss": np.zeros(D, np.int32),
        "c_dc_hit": np.zeros(D, np.int32),
        "c_dc_miss": np.zeros(D, np.int32),
        "c_acq_retry": np.zeros(D, np.int32),
        "ts_buf": np.zeros((D, cfg.timeseries_len), np.float32),
        "ts_acc": np.zeros(D, np.float32),
    }


def _wrap32(x):
    """int64 -> int32 with two's-complement wrap-around (XLA's int32
    arithmetic)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


class CmdConsts:
    """Device tensors a command step reads: the lane, register and class
    indices and the float32 burst size."""

    def __init__(self, cfg: DPUConfig, device):
        dev = torch.device(device)
        self.device = dev
        self.lanes = torch.arange(cfg.hbm_lanes, dtype=torch.int32,
                                  device=dev).view(1, -1)
        self.regs = torch.arange(8, dtype=torch.int32, device=dev).view(1, -1)
        self.classes = torch.arange(6, dtype=torch.int32,
                                    device=dev).view(1, -1)
        self.burst = torch.tensor(np.float32(cfg.hbm_lanes * 4), device=dev)


def make_cmd_step(cfg: DPUConfig, device=None):
    """``(ir, state) -> state``: one CRF command per bank per step
    (``cycle`` advances by the command's full service time, so steps !=
    cycles).

    Timing per command: 1 issue cycle, plus for every BANK operand an
    open-row term (``row_hit_overhead`` on the open row, else
    ``row_miss_overhead``) and the burst transfer of ``hbm_lanes`` words
    at the coalesced all-bank bandwidth.  A bank that is past
    ``max_cycles`` but not ``DONE`` keeps executing while any bank runs,
    as in the reference.  ``device``: None = the CUDA card."""
    W = cfg.hbm_lanes
    hit_ovh = int(cfg.row_hit_overhead)
    miss_ovh = int(cfg.row_miss_overhead)
    xfer = max(1, int(np.ceil(
        (W * 4) / (cfg.effective_mram_bw * cfg.coalesced_bw_mult))))
    C = CmdConsts(cfg, resolve_device(device))

    def step(ir, st):
        D = st["cycle"].shape[0]
        M = st["mram"].shape[1]
        P = ir.shape[1]
        alive = (st["status"] != engine.DONE).any(-1)
        go = (alive & (st["cycle"] < cfg.max_cycles)).any()
        pc = st["pc"].clamp(0, P - 1).to(torch.int64)
        op, dst, a, b, tgt = ir[:5].index_select(1, pc).unbind(0)
        run_m = (st["status"][:, 0] == engine.RUN) & go

        is_jump = op == CmdOp.JUMP
        is_exit = op == CmdOp.EXIT
        is_mov = (op == CmdOp.MOV) | (op == CmdOp.FILL)
        is_add = op == CmdOp.ADD
        is_mul = op == CmdOp.MUL
        is_compute = is_mov | is_add | is_mul | (op == CmdOp.MAC)
        uses_b = is_add | is_mul | (op == CmdOp.MAC)
        mram = st["mram"]

        def read(code):
            kind = (code >> 24).view(D, 1)
            idx = (code & _IDX_MASK).view(D, 1)
            cols = (idx * W + C.lanes).clamp(0, M - 1).to(torch.int64)
            r = (idx & 7).to(torch.int64)
            v_a = st["grf_a"].gather(1, r.view(D, 1, 1).expand(D, 1, W))
            v_b = st["grf_b"].gather(1, r.view(D, 1, 1).expand(D, 1, W))
            v_s = st["srf"].gather(1, r).expand(D, W)
            return torch.where(kind == K_GRF_A, v_a.view(D, W),
                   torch.where(kind == K_GRF_B, v_b.view(D, W),
                   torch.where(kind == K_SRF, v_s, mram.gather(1, cols))))

        va, vb, vd = (read(x).to(torch.int64) for x in (a, b, dst))
        res = _wrap32(torch.where(is_mov.view(D, 1), va,
                      torch.where(is_add.view(D, 1), va + vb,
                      torch.where(is_mul.view(D, 1), va * vb,
                                  vd + va * vb))))

        # ---- open-row timing over the command's bank-access sequence ----
        open_row = st["open_row"]
        cost = torch.zeros_like(open_row)
        n_rd, n_wr = torch.zeros_like(cost), torch.zeros_like(cost)
        n_hit, n_miss = torch.zeros_like(cost), torch.zeros_like(cost)
        any_bank = torch.zeros_like(run_m)
        for code, active, is_write in ((a, is_compute, False),
                                       (b, uses_b, False),
                                       (dst, is_compute, True)):
            row = code & _IDX_MASK
            bk = active & ((code >> 24) == K_BANK) & run_m
            hit = bk & (row == open_row)
            cost = cost + bk * torch.where(hit, hit_ovh + xfer,
                                           miss_ovh + xfer).to(torch.int32)
            open_row = torch.where(bk, row, open_row)
            if is_write:
                n_wr = n_wr + bk.to(torch.int32)
            else:
                n_rd = n_rd + bk.to(torch.int32)
            n_hit = n_hit + hit.to(torch.int32)
            n_miss = n_miss + (bk & ~hit).to(torch.int32)
            any_bank = any_bank | bk

        # ---- writeback by destination kind; bank columns past the end of
        # MRAM are dropped, not clamped ----
        wmask = (run_m & is_compute).view(D, 1)
        dkind = (dst >> 24).view(D, 1)
        didx = (dst & _IDX_MASK).view(D, 1)
        cols = didx * W + C.lanes
        wb = wmask & (dkind == K_BANK) & (cols < M)
        top = M - 1
        ci = torch.where(wb, cols, top).to(torch.int64)  # the dropped: on top
        top_val = torch.where((wb & (cols == top)).any(-1, keepdim=True),
                              (res * (wb & (cols == top))).sum(
                                  -1, keepdim=True, dtype=torch.int32),
                              mram[:, top:])
        mram.scatter_(1, ci, torch.where(wb, res, top_val))
        reg = (didx & 7)
        sel_a = (wmask & (dkind == K_GRF_A) & (C.regs == reg)).view(D, 8, 1)
        sel_b = (wmask & (dkind == K_GRF_B) & (C.regs == reg)).view(D, 8, 1)
        sel_s = wmask & (dkind == K_SRF) & (C.regs == reg)
        grf_a = torch.where(sel_a, res.view(D, 1, W), st["grf_a"])
        grf_b = torch.where(sel_b, res.view(D, 1, W), st["grf_b"])
        srf = torch.where(sel_s, res[:, :1], st["srf"])

        # ---- control flow ----
        ll = st["loop_left"]
        remaining = torch.where(ll >= 0, ll, a)   # JUMP.ra = raw trip count
        take = is_jump & run_m & (remaining > 0)
        ll_n = torch.where(is_jump & run_m,
                           torch.where(take, remaining - 1, -1), ll)
        pc_n = torch.where(run_m, torch.where(take, tgt, st["pc"] + 1),
                           st["pc"])
        status = torch.where((run_m & is_exit).view(D, 1), engine.DONE,
                             st["status"])

        service = run_m * (1 + cost)
        cls_sel = torch.where(any_bank, isa.CLS_DMA, torch.where(
            is_compute, isa.CLS_ALU, isa.CLS_CTRL)).to(torch.int32)
        run_i = run_m.to(torch.int32)
        hist = st["c_hist"].clone()
        hist[:, 1] += run_i

        new = dict(st)
        new.update(
            cycle=st["cycle"] + service,
            pc=pc_n, status=status, loop_left=ll_n,
            open_row=torch.where(run_m, open_row, st["open_row"]),
            grf_a=grf_a, grf_b=grf_b, srf=srf, mram=mram,
            c_active=st["c_active"] + run_i,
            c_idle_mem=st["c_idle_mem"] + run_m * cost,
            c_issued=st["c_issued"] + run_m * torch.where(
                is_compute, W, 1).to(torch.int32),
            c_cls=st["c_cls"] + (C.classes == cls_sel.view(D, 1)) * run_i.view(
                D, 1),
            c_hist=hist,
            c_dma_rd=st["c_dma_rd"] + n_rd,
            c_dma_wr=st["c_dma_wr"] + n_wr,
            c_dma_rd_bytes=st["c_dma_rd_bytes"]
            + n_rd.to(torch.float32) * C.burst,
            c_dma_wr_bytes=st["c_dma_wr_bytes"]
            + n_wr.to(torch.float32) * C.burst,
            c_row_hit=st["c_row_hit"] + n_hit,
            c_row_miss=st["c_row_miss"] + n_miss,
        )
        return new

    return step


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class AllBankBackend(backends.ExecBackend):
    """Compat all-bank target: unmodified uPIM binaries in SIMD lockstep.

    The whole tasklet set becomes one warp (``simt_width = n_threads``)
    with DMA coalescing forced on — the SIMT engine then models exactly
    the all-bank execution discipline: one shared front-end, min-PC
    reconvergence on divergence, bursts coalesced across the full SIMD
    width.  The driver-cache key normalizes ``simt_width``/``coalescing``
    away (the warp width is the launch's ``n_threads``, already keyed),
    so every MIMD config maps onto the same all-bank drivers.  On the card
    it runs the SIMT kernel."""

    name = "hbmpim"

    @staticmethod
    def _allbank_cfg(cfg: DPUConfig, n_threads: int) -> DPUConfig:
        return cfg.replace(simt_width=n_threads, coalescing=True)

    def make_state(self, cfg, binary, wram_init, mram_init, n_threads):
        return simt.make_state_np(self._allbank_cfg(cfg, n_threads), binary,
                                  wram_init, mram_init, n_threads)

    def step_driver(self, cfg, n_threads, device):
        cfg2 = self._allbank_cfg(cfg, n_threads)
        return (simt.make_step_traced(cfg2, n_threads, device),
                engine.make_cond(cfg2))

    def static_key(self, cfg):
        return cfg.replace(simt_width=0, coalescing=True).static_key()

    def card_kernel(self, cfg, st, ir, image):
        from repro_torch.kernels.simt_step.ops import SimtStep
        cfg2 = self._allbank_cfg(cfg, st["status"].shape[1])
        return SimtStep(cfg2, st, ir, image=image)


class CmdBackend(backends.ExecBackend):
    """Native bank-level CRF command-stream target (see module docs).

    State has no per-tasklet axis, so the engine-family lane masking is
    overridden; launch through :func:`launch_commands` (the generic
    ``PIMSystem.launch`` builds uPIM WRAM images this model has no use
    for).  On the card it runs the CRF kernel."""

    name = "hbmpim_cmd"

    def validate(self, cfg, binary, n_threads):
        if binary.n_instrs > cfg.hbm_crf_slots:
            raise AssertionError(
                f"CRF program of {binary.n_instrs} commands exceeds "
                f"hbm_crf_slots={cfg.hbm_crf_slots}")

    def make_state(self, cfg, binary, wram_init, mram_init, n_threads):
        return make_cmd_state_np(cfg, binary, wram_init, mram_init, n_threads)

    def step_driver(self, cfg, n_threads, device):
        return make_cmd_step(cfg, device), engine.make_cond(cfg)

    def pad_lanes(self, cfg, st, logical_d):
        st["status"][logical_d:] = engine.DONE

    def set_ndpus(self, st, logical_d, ndpus_reg):
        pass  # no N_DPUS register in the command model

    def finish_all(self, st):
        st["status"][:] = engine.DONE

    def card_kernel(self, cfg, st, ir, image):
        from repro_torch.kernels.crf_step.ops import CrfStep
        return CrfStep(cfg, st, ir, image=image)


def launch_commands(system, name: str, prog: CrfProgram, mram: np.ndarray,
                    srf_init: Optional[np.ndarray] = None):
    """Run one CRF program all-bank on ``system`` and charge its timeline.

    ``mram``: (D, mram_words) int32 bank images, rows = ``hbm_lanes``-word
    bursts addressed by :func:`bank`.  ``srf_init``: (D, 8) (or (8,),
    broadcast) int32 SRF seed — the host-written scalars.  Returns
    ``(final_state, KernelReport)`` exactly like ``PIMSystem.launch``,
    with the kernel charged to the timeline and appended to
    ``system.reports``; thread the returned ``st["mram"]`` into the next
    launch to accumulate across chunks.  Runs on ``system.device``."""
    from repro_torch.core import compile_cache

    cfg = system.cfg
    D = cfg.n_dpus
    mram = np.ascontiguousarray(np.asarray(mram, np.int32))
    if mram.shape[0] != D:
        raise ValueError(f"{name}: mram must carry one row per DPU "
                         f"(want {D}, got {mram.shape[0]})")
    if srf_init is None:
        srf_init = np.zeros((D, 8), np.int32)
    srf_init = np.asarray(srf_init, np.int32)
    if srf_init.ndim == 1:
        srf_init = np.broadcast_to(srf_init, (D, srf_init.shape[0]))
    binary = prog.binary(cfg.hbm_crf_slots)
    st = compile_cache.run(cfg, binary, srf_init, mram, n_threads=1,
                           backend="hbmpim_cmd", device=system.device)
    if (st["status"] != engine.DONE).any():
        raise RuntimeError(
            f"{name}: command stream hit max_cycles={cfg.max_cycles}")
    rep = backends.get("hbmpim_cmd").report(name, cfg, st, 1)
    system._charge_kernel(name, rep.kernel_seconds)
    system.reports.append(rep)
    return st, rep


backends.register(AllBankBackend())
backends.register(CmdBackend())
