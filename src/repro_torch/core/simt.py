"""SIMT vector DPU (case study #1, Fig. 11), in torch.

The port of :mod:`repro.core.simt`.  The same uPIM binary executes on an
N-way SIMT pipeline: N consecutive tasklets form a warp; each cycle one
ready warp issues, lanes whose PC equals the warp's minimum PC execute in
lockstep, others are masked.  Lane DMA requests are merged by the
optional memory address coalescer (AC): with AC the per-warp DRAM
occupancy pays one activate per *unique row* touched; without AC one per
lane.  ``mram_bw_scale`` scales the MRAM bandwidth (the SIMT+AC+4x/16x
design points).

The step (:func:`make_step_traced`) is the reference's bit for bit, in
the idiom of :mod:`repro_torch.core.engine`: one-hot ``torch.where`` and
gathers with explicit clamps in place of ``.at[].set``, WRAM and MRAM
updated in place, and every update gated on ``go`` (some DPU runs), so a
step taken after the run ended changes nothing.  The driver runs it on
the CPU (traced once a launch); on the card the driver runs the
hand-written kernel :mod:`repro_torch.kernels.simt_step`, which computes
this step K times a launch, and this step is its plain version.  What
the reference leaves to XLA and the port spells out:

* colliding scatters resolve as XLA's CPU scatter does, the last update
  in (lane, word) row-major order wins: several lanes' SW to one WRAM
  word, and the lanes' DMA copy windows, which overlap when lanes'
  buffers do and pile onto the last word when a window runs past it;
* the reference's ``lax.cond`` around the copy is one masked copy (a
  traced step has no branch on a tensor);
* ``ceil(bytes / bw)`` multiplies by the float32 reciprocal of ``bw``, as
  XLA rewrites a division by a constant;
* ``argmax``/``argmin`` ties take the first index (a bool is cast first).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine, isa
from repro_torch.core.carry import resolve_device
from repro_torch.core.config import DPUConfig
from repro_torch.core.engine import BLK_BAR, BLK_DMA, DONE, INF, RUN
from repro_torch.core.isa import Op
from repro_torch.kernels.alu_exec.ops import alu_exec

_INT32_MIN = -(1 << 31)
#: the lane copy window (words): the largest DMA
COPY_WORDS = engine.MAX_DMA_BYTES // 4


def make_state_np(cfg: DPUConfig, binary, wram_init, mram_init,
                  n_threads=None):
    """The scalar engine's state plus ``warp_next`` (D, n_warps), each
    warp's next issue cycle, and ``req_service`` (D, T), the DRAM service
    cycles of each latched request."""
    st = engine.make_state_np(cfg, binary, wram_init, mram_init, n_threads)
    D = cfg.n_dpus
    T = st["status"].shape[1]
    n_warps = T // cfg.simt_width
    st["warp_next"] = np.zeros((D, n_warps), np.int32)
    st["req_service"] = np.zeros((D, T), np.int32)
    return st


def decode_image(img: np.ndarray) -> np.ndarray:
    """(6, P) instruction image -> (8, P) int32: op, rd, ra, rb, imm,
    use_imm, ``isa.WRITES_RD`` and ``isa.OP_CLASS_TABLE`` of every slot
    (the rows :func:`_step` unpacks)."""
    op = img[0]
    tab = np.clip(op, 0, isa.N_OPS - 1)
    return np.stack([op, img[1], img[2], img[3], img[4], img[5] != 0,
                     isa.WRITES_RD[tab], isa.OP_CLASS_TABLE[tab]]
                    ).astype(np.int32)


class SimtConsts:
    """Device tensors a step reads (index ranges, the float32 reciprocal
    of the DMA bandwidth) and the image decoded once per launch."""

    def __init__(self, cfg: DPUConfig, n_threads: int, device):
        dev = torch.device(device)
        W = cfg.simt_width
        self.cfg, self.device, self.W = cfg, dev, W
        self.tt = torch.arange(n_threads, dtype=torch.int32,
                               device=dev).view(1, -1)
        self.lane = torch.arange(W, dtype=torch.int32, device=dev).view(1, -1)
        self.lane1 = (self.lane + 1).view(1, 1, -1)
        self.kk = torch.arange(COPY_WORDS, dtype=torch.int32,
                               device=dev).view(1, 1, -1)
        self.warps = torch.arange(n_threads // W, dtype=torch.int32,
                                  device=dev).view(1, -1)
        # lane m comes before lane l (the coalescer's earlier lanes)
        self.before = torch.tril(torch.ones(W, W, dtype=torch.bool,
                                            device=dev), -1)
        self.lane_warp = (self.tt // W)
        bw = cfg.effective_mram_bw * (cfg.coalesced_bw_mult
                                      if cfg.coalescing else 1.0)
        # XLA rewrites x / c (c a constant) as x * (1/c) in float32
        self.inv_bw = torch.tensor(np.float32(1) / np.float32(bw), device=dev)
        self._image = (None, None)

    def decode(self, ir: torch.Tensor) -> torch.Tensor:
        if self._image[0] is ir:
            return self._image[1]
        dec = torch.from_numpy(decode_image(ir.cpu().numpy())).to(self.device)
        self._image = (ir, dec)
        return dec


def _floordiv(x, d: int):
    return torch.div(x, d, rounding_mode="floor")


def _last_lane(t, lo, hi, writes, lane1):
    """For each entry of ``t`` (D, N): the last lane m (of W) whose
    writes cover its target, ``writes[m] and lo[m] <= t <= hi[m]``
    ((D, W) each), or -1.  XLA's CPU scatter applies updates in
    row-major (lane, word) order, so that lane's update is what lands."""
    D, N = t.shape
    tt = t.view(D, N, 1)
    cover = writes.view(D, 1, -1) & (lo.view(D, 1, -1) <= tt) \
        & (tt <= hi.view(D, 1, -1))
    return (torch.where(cover, lane1, 0).amax(-1) - 1).to(torch.int64)


def _dram_step(cfg: DPUConfig, C: SimtConsts, st, cycle, go):
    """FR-FCFS on the precomputed per-request service; a completion wakes
    the whole warp of the request's leader."""
    D, T = st["status"].shape
    comp = st["eng_active"] & (st["eng_finish"] <= cycle) & go
    leader = st["eng_thread"].view(D, 1)
    wake = comp.view(D, 1) & (C.lane_warp == _floordiv(leader, C.W)) \
        & (st["status"] == BLK_DMA)
    status = torch.where(wake, RUN, st["status"])
    next_issue = torch.where(wake, cycle.view(D, 1) + 1, st["next_issue"])
    req_valid = st["req_valid"] & ~((C.tt == leader) & comp.view(D, 1))
    eng_active = st["eng_active"] & ~comp

    can = ~eng_active & req_valid.any(-1) & go
    row = _floordiv(st["req_mram"], cfg.row_bytes)
    hit = row == st["open_row"].view(D, 1)
    score = torch.where(req_valid, hit.to(torch.int32) * INF - st["req_enq"],
                        -INF)
    j = torch.argmax(score, -1, keepdim=True)
    service = st["req_service"].gather(1, j).view(D)
    m_j = st["req_mram"].gather(1, j).view(D)
    b_j = st["req_bytes"].gather(1, j).view(D)
    hit_j = hit.gather(1, j).view(D)
    end_row = _floordiv(m_j + b_j.clamp(min=1) - 1, cfg.row_bytes)

    new = dict(st)
    new.update(
        status=status, next_issue=next_issue, req_valid=req_valid,
        eng_active=eng_active | can,
        eng_thread=torch.where(can, j.view(D).to(torch.int32),
                               st["eng_thread"]),
        eng_finish=torch.where(can, cycle + service, st["eng_finish"]),
        open_row=torch.where(can, end_row, st["open_row"]),
        c_row_hit=st["c_row_hit"] + (can & hit_j).to(torch.int32),
        c_row_miss=st["c_row_miss"] + (can & ~hit_j).to(torch.int32),
    )
    return new


def _landing(C: SimtConsts, t, base, n, writes, top: int, src, cur):
    """The value that lands on each copy entry's target ``t`` (D, W, nw):
    the last writing lane's word for it, else ``cur`` (the target's value
    before the copy).  Lane m writes targets ``clip(base[m] + k)`` for
    k < n[m], an interval; its last k onto target t is ``n[m] - 1`` at
    the top word, else ``t - base[m]`` (at most ``n[m] - 1``)."""
    D, W, nw = t.shape
    tf = t.view(D, -1)
    lo = base.clamp(0, top)
    hi = (base + n - 1).clamp(0, top)
    m = _last_lane(tf, lo, hi, writes & (n > 0), C.lane1)
    mc = m.clamp(min=0)
    n_m, b_m = n.gather(1, mc), base.gather(1, mc)
    kp = torch.where(tf == top, n_m - 1, torch.minimum(n_m - 1, tf - b_m))
    val = src.gather(1, mc * nw + kp.clamp(0, nw - 1))
    return torch.where(m >= 0, val, cur)


def _lane_copy(C: SimtConsts, wram, mram, do_dma, a, breg, size, is_w):
    """The DMA's functional copy, every lane's ``COPY_WORDS`` window at
    once, in place.  Every read happens before any write; where windows
    meet on one word (overlapping buffers, or the clip onto the first or
    last word) the last (lane, word) in row-major order wins."""
    D = do_dma.shape[0]
    Wn, M = wram.shape[1], mram.shape[1]
    n = (size + 3) >> 2                                   # 0 unless DMA
    wb0 = (a * do_dma) >> 2
    mb0 = (breg * do_dma) >> 2
    wt = (wb0.unsqueeze(-1) + C.kk).clamp(0, Wn - 1)      # (D, W, nw)
    mt = (mb0.unsqueeze(-1) + C.kk).clamp(0, M - 1)
    wi = wt.view(D, -1).to(torch.int64)
    mi = mt.view(D, -1).to(torch.int64)
    rd_m = mram.gather(1, mi)
    rd_w = wram.gather(1, wi)
    new_w = _landing(C, wt, wb0, n, do_dma & ~is_w, Wn - 1, rd_m, rd_w)
    new_m = _landing(C, mt, mb0, n, do_dma & is_w, M - 1, rd_w, rd_m)
    wram.scatter_(1, wi, new_w)
    mram.scatter_(1, mi, new_m)


def _step(cfg: DPUConfig, C: SimtConsts, ir, st):
    dec = C.decode(ir)
    W = C.W
    cycle = st["cycle"]
    D, T = st["status"].shape
    nW = T // W
    R = st["regs"].shape[2]
    P = dec.shape[1]
    alive = (st["status"] != DONE).any(-1)
    running = alive & (cycle < cfg.max_cycles)
    go = running.any()

    st = _dram_step(cfg, C, st, cycle, go)

    # ---- barrier release (all live lanes arrived) ----
    status = st["status"]
    bar = status == BLK_BAR
    n_bar = bar.sum(-1)
    rel = (n_bar > 0) & (n_bar == (status != DONE).sum(-1)) & go
    status = torch.where(rel.view(D, 1) & bar, RUN, status)

    # ---- warp selection ----
    status_w = status.view(D, nW, W)
    blocked = ((status_w == BLK_DMA) | (status_w == BLK_BAR)).any(-1)
    n_run = (status_w == RUN).sum(-1)
    has_run = n_run > 0
    warp_ready = has_run & ~blocked & (st["warp_next"] <= cycle.view(D, 1)) \
        & running.view(D, 1)
    n_ready0 = torch.where(warp_ready, n_run, 0).sum(-1)

    prio = torch.remainder(C.warps - st["rr"].view(D, 1), nW)
    wsel = torch.argmin(torch.where(warp_ready, prio, INF), -1, keepdim=True)
    valid = warp_ready.any(-1).view(D, 1)

    lanes = (wsel * W + C.lane).to(torch.int64)               # (D, W)
    lane_stat = status.gather(1, lanes)
    lane_pc = st["pc"].gather(1, lanes)
    warp_pc = torch.where(lane_stat == RUN, lane_pc, INF).amin(
        -1, keepdim=True)                                     # (D, 1)
    active = (lane_stat == RUN) & (lane_pc == warp_pc) & valid

    fi = dec.index_select(1, warp_pc.clamp(0, P - 1).view(D)).view(8, D, 1)
    op, rdv, rav, rbv, immv, uiv, wrd, cls = fi.unbind(0)
    uiv, wrd = uiv != 0, wrd != 0

    regs = st["regs"]
    rflat = regs.view(-1)
    rbase = torch.arange(D, device=regs.device).view(D, 1) * (T * R) \
        + lanes * R
    a = rflat.take(rbase + rav)                               # (D, W)
    breg = rflat.take(rbase + rbv)
    b = torch.where(uiv, immv, breg)

    alu = alu_exec(op.expand(D, W).contiguous(), a, b)
    wram = st["wram"]
    addr = a + immv
    widx = (addr >> 2).clamp(0, wram.shape[1] - 1).to(torch.int64)
    ldval = wram.gather(1, widx)
    res = torch.where(op <= Op.SLTU, alu,
                      torch.where(op == Op.LW, ldval, warp_pc + 1))

    writes = wrd & active
    fidx = rbase + torch.where(writes, rdv, 0)
    regs = rflat.index_put((fidx.view(-1),), torch.where(
        writes, res, rflat.take(fidx)).view(-1)).view(regs.shape)

    # ---- SW: several lanes may store to one word (the last lane wins) ----
    do_sw = active & (op == Op.SW)
    sw_last = _last_lane(widx, widx, widx, do_sw, C.lane1)
    wram.scatter_(1, widx, torch.where(
        sw_last >= 0, breg.gather(1, sw_last.clamp(min=0)), ldval))

    # ---- atomics: lane-serialised (lowest active lane wins per cycle) ----
    atomic = st["atomic"]
    mid = immv.clamp(0, atomic.shape[1] - 1).to(torch.int64)
    aold = atomic.gather(1, mid)
    is_acq = op == Op.ACQUIRE
    first_active = torch.argmax(active.to(torch.int32), -1, keepdim=True)
    is_first = C.lane == first_active
    acq_ok = active & is_acq & is_first & (aold == 0)
    rel_op = active & (op == Op.RELEASE)
    aval = torch.where(acq_ok.any(-1, keepdim=True), 1,
                       torch.where(rel_op.any(-1, keepdim=True), 0, aold))
    atomic = atomic.scatter(1, mid, aval)
    acq_stall = active & is_acq & ~acq_ok

    # ---- DMA: merge the lanes' requests (coalescer) ----
    is_dma = (op == Op.LDMA) | (op == Op.SDMA)
    do_dma = active & is_dma
    any_dma = do_dma.any(-1, keepdim=True)
    size = torch.where(uiv, immv, regs.view(-1).take(rbase + rdv))
    size = (size * do_dma).clamp(0, engine.MAX_DMA_BYTES)
    total_bytes = size.sum(-1, keepdim=True, dtype=torch.int32)
    if cfg.coalescing:
        # one activate per unique row among the lanes
        rows = torch.where(do_dma, _floordiv(breg, cfg.row_bytes), -1)
        seen = ((rows.unsqueeze(1) == rows.unsqueeze(2))
                & do_dma.unsqueeze(1) & C.before).any(-1)
        n_act = (do_dma & ~seen).sum(-1, keepdim=True, dtype=torch.int32)
    else:
        n_act = do_dma.sum(-1, keepdim=True, dtype=torch.int32)
    transfer = torch.ceil(total_bytes.to(torch.float32) * C.inv_bw) \
        .to(torch.int32)
    service = n_act * cfg.row_miss_overhead + transfer

    leader = wsel * W + first_active                          # (D, 1)
    sel = (C.tt == leader) & any_dma
    is_w = op == Op.SDMA
    req = dict(
        req_valid=st["req_valid"] | sel,
        req_mram=torch.where(sel, breg.gather(1, first_active), st["req_mram"]),
        req_bytes=torch.where(sel, total_bytes, st["req_bytes"]),
        req_enq=torch.where(sel, cycle.view(D, 1), st["req_enq"]),
        req_service=torch.where(sel, service, st["req_service"]))

    mram = st["mram"]
    _lane_copy(C, wram, mram, do_dma, a, breg, size, is_w)

    # ---- control flow / status ----
    eq, lt = a == b, a < b
    ltu = (a ^ _INT32_MIN) < (b ^ _INT32_MIN)   # unsigned compare
    taken = torch.where(op == Op.BEQ, eq,
            torch.where(op == Op.BNE, ~eq,
            torch.where(op == Op.BLT, lt,
            torch.where(op == Op.BGE, ~lt,
            torch.where(op == Op.BLTU, ltu,
            (op == Op.BGEU) & ~ltu)))))
    pc1 = warp_pc + 1
    new_pc = torch.where((op >= Op.BEQ) & (op <= Op.BGEU),
                         torch.where(taken, immv, pc1),
             torch.where((op == Op.JUMP) | (op == Op.JAL), immv,
             torch.where(op == Op.JR, a,
             torch.where(acq_stall | (op == Op.STOP), warp_pc, pc1))))
    pc = st["pc"].scatter(1, lanes, torch.where(active, new_pc, lane_pc))
    new_stat = torch.where(active & (op == Op.STOP), DONE,
               torch.where(do_dma, BLK_DMA,
               torch.where(active & (op == Op.BARRIER), BLK_BAR, lane_stat)))
    status = status.scatter(1, lanes, new_stat)

    gap = 1 + torch.where(op == Op.MUL, cfg.mul_extra, torch.where(
        op == Op.DIV, cfg.div_extra, 0)).to(torch.int32)
    wsel_w = C.warps == wsel
    warp_next = torch.where(wsel_w & valid, cycle.view(D, 1) + gap,
                            st["warp_next"])
    rr = torch.where(valid.view(D), ((wsel.view(D) + 1) % nW).to(torch.int32),
                     st["rr"])

    vi = valid.view(D)
    n_active = active.sum(-1, dtype=torch.int32)
    issued = n_active * vi
    c_cls = st["c_cls"].scatter_add(1, (cls * valid).to(torch.int64),
                                    issued.view(D, 1))
    rd_m = do_dma & ~is_w
    wr_m = do_dma & is_w

    # ---- classify + advance (warp-level events) ----
    runnable_w = has_run & ~blocked
    ni = torch.where(runnable_w, warp_next, INF).amin(-1)
    df = torch.where(st["eng_active"], st["eng_finish"], INF)
    nxt = torch.minimum(ni, df)
    idle = running & ~vi
    cycle_p1 = cycle + 1
    if cfg.event_skip:
        new_cycle = torch.where(running, torch.where(
            idle & (nxt < INF), torch.maximum(cycle_p1, nxt), cycle_p1),
            cycle)
    else:
        new_cycle = torch.where(running, cycle_p1, cycle)
    delta = new_cycle - cycle
    mem = idle & (df <= ni)
    hist = st["c_hist"].scatter_add(
        1, n_ready0.clamp(0, T).to(torch.int64).view(D, 1),
        running.to(torch.int32).view(D, 1))

    new = dict(st)
    new.update(
        regs=regs, wram=wram, mram=mram, atomic=atomic, pc=pc,
        status=status, warp_next=warp_next, rr=rr, **req,
        c_issued=st["c_issued"] + issued,
        c_cls=c_cls,
        c_acq_retry=st["c_acq_retry"] + acq_stall.sum(-1, dtype=torch.int32),
        c_dma_rd=st["c_dma_rd"] + rd_m.sum(-1, dtype=torch.int32),
        c_dma_wr=st["c_dma_wr"] + wr_m.sum(-1, dtype=torch.int32),
        c_dma_rd_bytes=st["c_dma_rd_bytes"]
        + (size * rd_m).sum(-1, dtype=torch.int32).to(torch.float32),
        c_dma_wr_bytes=st["c_dma_wr_bytes"]
        + (size * wr_m).sum(-1, dtype=torch.int32).to(torch.float32),
        cycle=new_cycle,
        c_active=st["c_active"] + vi.to(torch.int32),
        c_idle_mem=st["c_idle_mem"] + delta * mem,
        c_idle_rev=st["c_idle_rev"] + delta * (idle & ~mem),
        c_hist=hist,
    )
    return new


def make_step_traced(cfg: DPUConfig, n_threads: int = None, device=None):
    """One SIMT cycle as a function ``(ir, state) -> state`` (see
    :func:`repro_torch.core.engine.make_step_traced` for ``ir`` and
    ``device``).  Gated on the termination predicate: a step taken after
    no DPU runs leaves every leaf unchanged.  WRAM and MRAM are updated
    in place; the other leaves are new tensors."""
    C = SimtConsts(cfg, n_threads or cfg.n_tasklets, resolve_device(device))

    def step(ir, st):
        return _step(cfg, C, ir, st)

    return step


def run(cfg: DPUConfig, binary, wram_init, mram_init, n_threads=None,
        ndpus_reg=None, device=None):
    """Simulate on the ``"simt"`` backend (its ``validate`` enforces
    ``simt_width > 0`` and warp-divisible tasklet counts) through
    :mod:`repro_torch.core.compile_cache` on ``device`` (None = the CUDA
    card; ``"cpu"`` for the CPU)."""
    from repro_torch.core import compile_cache
    return compile_cache.run(cfg, binary, wram_init, mram_init,
                             n_threads=n_threads, backend="simt",
                             ndpus_reg=ndpus_reg, device=device)
