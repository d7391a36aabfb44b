"""Vectorized cycle-level DPU engine, in torch.

The port of :mod:`repro.core.engine`.  All microarchitectural state is a
dict of int32/bool/float32 tensors with a leading DPU axis; one simulated
cycle is a function ``(ir, state) -> state`` (:func:`make_step_traced`)
that advances every DPU of the system in the same vectorized step.  The
driver (:mod:`repro_torch.core.compile_cache`) runs it eagerly on the
CPU; on the CUDA card the driver runs the hand-written kernel
:mod:`repro_torch.kernels.cycle_step`, which computes this step K times
per launch, and this eager step is the kernel's plain version.  Every
issue slot's ALU goes through
:func:`repro_torch.kernels.alu_exec.ops.alu_exec`.

The timing model is the reference's, bit for bit (same int32 state, same
float32 counters); see that module for what is modeled.  What differs is
how the step is written, because eager torch has neither a tracer nor
immutable arrays:

* ``.at[dd, tsel].set(...)`` on a (D, T) array becomes a ``torch.where``
  over a one-hot thread mask;
* the DMA copy under a two-width ``lax.cond`` becomes one masked copy
  whose window width is a device-side scalar, so a step never syncs the
  host;
* gathers whose index the reference lets JAX clamp (``iop[pcv]``, where
  a ``JR`` target is arbitrary) clamp explicitly;
* duplicate scatter indices made by clipping at the last WRAM/MRAM word
  are resolved last-write-wins, as XLA's CPU scatter does, so no two
  lanes write different values to one word;
* XLA turns a division by a constant into a multiplication by its
  float32 reciprocal; the port multiplies by the same reciprocal;
* WRAM and MRAM (the large arrays) are updated in place; everything else
  is rebuilt per step.

The step is gated on the termination predicate computed on the device:
once no DPU is running, a step changes nothing, so the driver may run
several steps between host checks of the predicate.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.carry import resolve_device
from repro_torch.core.config import DPUConfig
from repro_torch.core.isa import Op
from repro_torch.kernels.alu_exec.ops import alu_exec

# thread status
RUN, BLK_DMA, BLK_BAR, DONE = 0, 1, 2, 3
INF = 1 << 30
MAX_DMA_BYTES = 2048  # UPMEM DMA transfer limit
_INT32_MIN = -(1 << 31)

# special registers in the order of the SPC immediate (TID, NT, DPU, NDPU)
_SPECIAL_REGS = (isa.R_TID, isa.R_NT, isa.R_DPU, isa.R_NDPU)


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def make_state_np(cfg: DPUConfig, binary: isa.Binary, wram_init, mram_init,
                  n_threads: int = None) -> Dict:
    """Initial microarchitectural state as a host-numpy pytree (the
    compile cache pads/masks this before device placement;
    :func:`make_state` is the device-array convenience wrapper)."""
    D = cfg.n_dpus
    T = n_threads or cfg.n_tasklets
    W = cfg.wram_words
    M = mram_init.shape[1]
    regs = np.zeros((D, T, isa.N_REGS), np.int32)
    regs[:, :, isa.R_DPU] = np.arange(D)[:, None]
    regs[:, :, isa.R_NDPU] = D
    regs[:, :, isa.R_TID] = np.arange(T)[None, :]
    regs[:, :, isa.R_NT] = T

    wram = np.zeros((D, W), np.int32)
    wram[:, : wram_init.shape[1]] = wram_init

    n_sets = max(1, cfg.dcache_bytes // cfg.line_bytes // cfg.dcache_ways)
    ways = cfg.dcache_ways if cfg.cache_mode else 1
    sets = n_sets if cfg.cache_mode else 1

    st = {
        "cycle": np.zeros(D, np.int32),
        "pc": np.zeros((D, T), np.int32),
        "regs": regs,
        "status": np.full((D, T), RUN, np.int32),
        "next_issue": np.zeros((D, T), np.int32),
        "last_dest": np.full((D, T), -1, np.int32),
        "last_ready": np.zeros((D, T), np.int32),
        "port_busy": np.zeros(D, np.int32),
        "rr": np.zeros(D, np.int32),
        "wram": wram,
        "mram": mram_init.astype(np.int32),
        "atomic": np.zeros((D, cfg.atomic_bits), np.int32),
        # DMA request latches (one per thread)
        "req_valid": np.zeros((D, T), bool),
        "req_wram": np.zeros((D, T), np.int32),
        "req_mram": np.zeros((D, T), np.int32),
        "req_bytes": np.zeros((D, T), np.int32),
        "req_write": np.zeros((D, T), bool),
        "req_enq": np.zeros((D, T), np.int32),
        # DRAM engine
        "eng_active": np.zeros(D, bool),
        "eng_thread": np.zeros(D, np.int32),
        "eng_finish": np.zeros(D, np.int32),
        "open_row": np.full(D, -1, np.int32),
        # MMU
        "tlb_tags": np.full((D, cfg.tlb_entries), -1, np.int32),
        "tlb_lru": np.zeros((D, cfg.tlb_entries), np.int32),
        # D$ (cache mode)
        "dc_tags": np.full((D, sets, ways), -1, np.int32),
        "dc_lru": np.zeros((D, sets, ways), np.int32),
        "dc_dirty": np.zeros((D, sets, ways), bool),
        # counters
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
        # TLP time series
        "ts_buf": np.zeros((D, cfg.timeseries_len), np.float32),
        "ts_acc": np.zeros(D, np.float32),
    }
    return st


# ---------------------------------------------------------------------------
# Step constants, the decoded instruction image, indexing helpers
# ---------------------------------------------------------------------------

def decode_image(cfg: DPUConfig, img: np.ndarray):
    """(6, P) instruction image (numpy) -> ((10, P) int32, (19, P) bool):
    the register indices, operands and isa-table lookups of every slot,
    in the row order :func:`_issue_one` unpacks (the four register
    indices first, for one gather)."""
    op = np.clip(img[0], 0, isa.N_OPS - 1)
    rd, ra, rb, imm, uiv = img[1], img[2], img[3], img[4], img[5] != 0
    extra = np.where(op == Op.MUL, cfg.mul_extra,
                     np.where(op == Op.DIV, cfg.div_extra, 0))
    lat = np.where(op == Op.LW, cfg.wram_load_latency, 1)
    ints = np.stack([
        ra, rb, rd, np.asarray(_SPECIAL_REGS)[np.clip(imm, 0, 3)], img[0],
        imm, isa.OP_CLASS_TABLE[op], extra, lat,
        np.clip(op - Op.BEQ, 0, 5)]).astype(np.int32)
    is_dma = (op == Op.LDMA) | (op == Op.SDMA)
    if cfg.cache_mode:
        is_dma = np.zeros_like(is_dma)  # cache-mode programs address memory directly
    flags = np.stack([
        uiv, op <= Op.SLTU, op == Op.LW, op == Op.SW,
        (op == Op.LW) | (op == Op.SW), op == Op.JAL,
        (op == Op.JUMP) | (op == Op.JAL), op == Op.JR, op == Op.STOP,
        op == Op.BARRIER, (op >= Op.BEQ) & (op <= Op.BGEU),
        op == Op.ACQUIRE, op == Op.RELEASE, is_dma, op == Op.SDMA,
        isa.WRITES_RD[op], isa.READS_RA[op], isa.READS_RB[op] & ~uiv,
        isa.READS_RA[op] & isa.READS_RB[op] & ~uiv])
    return ints, flags


class StepConsts:
    """Device tensors a step reads every cycle, built once per driver
    (index ranges, float32 reciprocals), and the decoder that turns an
    instruction image into per-instruction fields and flags once per
    launch (the isa tables applied to every slot of the image)."""

    def __init__(self, cfg: DPUConfig, n_threads: int, device):
        dev = torch.device(device)
        self.cfg = cfg
        self.device = dev
        self.tt = torch.arange(n_threads, dtype=torch.int32,
                               device=dev).view(1, -1)
        nwin = max(cfg.small_dma_words, MAX_DMA_BYTES // 4)
        self.kk = torch.arange(nwin, dtype=torch.int32, device=dev).view(1, -1)
        self.ts_lanes = torch.arange(cfg.timeseries_len, dtype=torch.int32,
                                     device=dev).view(1, -1)
        self.tlb_ways = torch.arange(cfg.tlb_entries, dtype=torch.int32,
                                     device=dev).view(1, -1)
        # XLA rewrites x / c (c a constant) as x * (1/c) in float32
        self.inv_bw = torch.tensor(
            np.float32(1) / np.float32(cfg.effective_mram_bw), device=dev)
        self.inv_win = torch.tensor(
            np.float32(1) / np.float32(cfg.timeseries_window), device=dev)
        self._rows: Dict[int, torch.Tensor] = {}
        self._image = (None, None)

    def rows(self, D: int) -> torch.Tensor:
        """``arange(D)`` as an int64 column on the device (cached)."""
        r = self._rows.get(D)
        if r is None:
            r = self._rows[D] = torch.arange(D, device=self.device).view(-1, 1)
        return r

    def decode(self, ir: torch.Tensor):
        """(6, P) instruction image -> :func:`decode_image` of it, on the
        device.  Cached for the image last seen, so a launch decodes
        once."""
        if self._image[0] is ir:
            return self._image[1]
        ints, flags = decode_image(self.cfg, ir.cpu().numpy())
        dec = (torch.from_numpy(ints).to(self.device),
               torch.from_numpy(flags).to(self.device))
        self._image = (ir, dec)
        return dec


def _clamp_index(i, n):
    """JAX gather semantics: negative indices wrap once, then clamp."""
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1).to(torch.int64)


def _floordiv(x, d: int):
    return torch.div(x, d, rounding_mode="floor")


def _pick(cond, x: int, y: int):
    """``jnp.where(cond, x, y)`` of two Python ints, as int32 (torch would
    make it int64)."""
    return torch.where(cond, x, y).to(torch.int32)


# ---------------------------------------------------------------------------
# One issue slot
# ---------------------------------------------------------------------------
#
# Per-DPU values of a slot are (D, 1) columns: they broadcast against the
# (D, T) per-thread arrays without reshaping.


class StepControl:
    """What one rank of a sharded run (``compile_cache``'s sharded driver)
    sets and reads of a step of its block of DPUs.

    Two values of a step cross DPUs: ``go`` (some DPU runs: a stopped DPU
    still retires DMAs, releases barriers, drains its port and accumulates
    the time series while others run) and, per issue slot, whether some
    DPU's DMA is wider than ``small_dma_words`` (the copy window, which
    decides what a clipped DMA writes).  ``go`` forces the first (None:
    this rank's own predicate); ``wide`` forces the second, a bool per
    slot (None: this rank's widest DMA).  After the step ``wide_bits`` and
    ``clip_bits`` hold, per slot, whether one of this rank's DMAs was wide
    and whether one was of exactly ``small_dma_words`` reaching the last
    word of its destination row or lying that far below word 0: the only
    DMA whose result depends on the window (host bools)."""

    def __init__(self, go=None, wide=None):
        self.go = go
        self.wide = wide
        self.wide_bits = []
        self.clip_bits = []


def _dma_copy(C: StepConsts, cfg: DPUConfig, wram, mram, do_dma, a, breg,
              size, is_w, ctl: StepControl = None):
    """Functional DMA copy of this issue slot, in place on WRAM/MRAM.

    The reference runs a 64-word or a 512-word masked copy, picked by
    the largest DMA of the slot across all DPUs.  Here the window width
    ``nw`` is a device-side scalar: lanes past it repeat the window's
    last lane, so they write the same word with the same value.  Lanes
    clipped onto the first or last word of a row write the value of the
    last lane that lands there (the order XLA's CPU scatter applies)."""
    W = wram.shape[1]
    M = mram.shape[1]
    small = cfg.small_dma_words
    sz = size * do_dma
    wide = (sz.amax() + 3) >> 2 > small
    wb0 = (a * do_dma) >> 2                                   # (D, 1)
    mb0 = (breg * do_dma) >> 2
    if ctl is not None:
        b0 = torch.where(is_w, mb0, wb0)
        top = torch.where(is_w, M - 1, W - 1)
        clip = do_dma & ((sz + 3) >> 2 == small) \
            & ((b0 + small - 1 >= top) | (b0 <= -small))
        ctl.wide_bits.append(bool(wide))
        ctl.clip_bits.append(bool(clip.any()))
        if ctl.wide is not None:
            wide = torch.tensor(bool(ctl.wide[len(ctl.wide_bits) - 1]),
                                device=sz.device)
    nw = torch.where(wide, MAX_DMA_BYTES // 4, small)
    last = nw - 1
    kc = torch.minimum(C.kk, last)                            # (1, nwin)
    wc = (wb0 + kc).clamp(0, W - 1).to(torch.int64)
    mc = (mb0 + kc).clamp(0, M - 1).to(torch.int64)
    mask = kc < (sz + 3) >> 2
    rd_m = mram.gather(1, mc)
    rd_w = wram.gather(1, wc)
    ld = mask & (do_dma & ~is_w)
    stm = mask & (do_dma & is_w)
    wval = torch.where(ld, rd_m, rd_w)
    mval = torch.where(stm, rd_w, rd_m)

    def winner(clipped, base, top):
        # last lane of each run of equal clipped indices
        rep = torch.where(clipped == top, last,
                          torch.where(clipped == 0,
                                      torch.minimum(-base, last), kc))
        return rep.to(torch.int64)

    wram.scatter_(1, wc, wval.gather(1, winner(wc, wb0, W - 1)))
    mram.scatter_(1, mc, mval.gather(1, winner(mc, mb0, M - 1)))


def _issue_one(cfg: DPUConfig, C: StepConsts, img, st, cycle1, running,
               already, slot_block, ctl: StepControl = None):
    """Try to issue one instruction per DPU.  Returns (st, issued,
    hazard, issued_mask); ``cycle1`` is the cycle as a (D, 1) column."""
    D, T = st["status"].shape
    img_i, img_b = img
    regs = st["regs"]
    R = regs.shape[2]

    ready = (st["status"] == RUN) & (st["next_issue"] <= cycle1)
    if already is not None:
        ready = ready & ~already  # superscalar: a thread dual-issuing is not allowed
    valid = (running & (st["port_busy"] == 0) & ready.any(-1)
             & ~slot_block).view(D, 1)

    prio = torch.remainder(C.tt - st["rr"].view(D, 1), T)
    tsel = torch.argmin(torch.where(ready, prio, INF), dim=-1, keepdim=True)
    sel = C.tt == tsel
    selv = sel & valid

    pcv = st["pc"].gather(1, tsel)
    pidx = _clamp_index(pcv.view(D), img_i.shape[1])
    fi = img_i.index_select(1, pidx).view(-1, D, 1)
    (ra_, rb_, rd_, _, op, immv, cls, extra, lat, bidx) = fi.unbind(0)
    (uiv, is_alu, is_lw, is_sw, is_mem, is_jal, is_jmp, is_jr, is_stop,
     is_bar, is_br, is_acq, is_rel, is_dma, is_sdma, wrd, rd_ra, rb_dep,
     two) = img_b.index_select(1, pidx).view(-1, D, 1).unbind(0)

    # every register read of the slot in one gather: ra, rb, rd, special
    rbase = C.rows(D) * (T * R) + tsel * R
    a, breg, rd_old, spc = regs.take(fi[:4] + rbase).unbind(0)
    b = torch.where(uiv, immv, breg)

    # ---- datapath ----
    alu = alu_exec(op, a, b)
    wram = st["wram"]
    addr = a + immv
    widx = (addr >> 2).clamp(0, wram.shape[1] - 1).to(torch.int64)
    ldval = wram.gather(1, widx)
    res = torch.where(is_alu, alu,
          torch.where(is_lw, ldval,
          torch.where(is_jal, pcv + 1, spc)))

    writes_rd = wrd & valid
    fidx = rbase + torch.where(writes_rd, rd_, 0)
    rflat = regs.view(-1)
    regs = rflat.index_put((fidx.view(D),), torch.where(
        writes_rd, res, rflat.take(fidx)).view(D)).view(regs.shape)

    # ---- stores (in place: WRAM is large) ----
    do_sw = valid & is_sw
    sidx = widx * do_sw
    wram.scatter_(1, sidx, torch.where(do_sw, breg, wram.gather(1, sidx)))

    # ---- cache-centric mode: LW/SW go through the D$ timing model ----
    status = st["status"]
    req_valid, req_wram, req_mram = st["req_valid"], st["req_wram"], st["req_mram"]
    req_bytes, req_write, req_enq = st["req_bytes"], st["req_write"], st["req_enq"]
    dc_tags, dc_lru, dc_dirty = st["dc_tags"], st["dc_lru"], st["dc_dirty"]
    c_dc_hit, c_dc_miss = st["c_dc_hit"], st["c_dc_miss"]
    if cfg.cache_mode:
        mem_v = valid & is_mem
        line = _floordiv(addr, cfg.line_bytes)
        n_sets, ways = dc_tags.shape[1], dc_tags.shape[2]
        cset = torch.where(mem_v, torch.remainder(line, n_sets), 0)
        cset = cset.to(torch.int64)
        row_idx = cset.view(D, 1, 1).expand(D, 1, ways)
        tags_s = dc_tags.gather(1, row_idx).view(D, ways)
        lru_s = dc_lru.gather(1, row_idx).view(D, ways)
        dirty_s = dc_dirty.gather(1, row_idx).view(D, ways)
        match = tags_s == line
        any_match = match.any(-1, keepdim=True)
        hit = mem_v & any_match
        miss = mem_v & ~any_match
        hitway = torch.argmax(match.to(torch.int32), -1, keepdim=True)
        victim = torch.argmin(lru_s, -1, keepdim=True)
        way = torch.where(hit, hitway, victim)
        # dirty-victim writeback folded into the fill size
        vic_dirty = dirty_s.gather(1, victim) & (tags_s.gather(1, victim) >= 0)
        fill_bytes = cfg.line_bytes + _pick(vic_dirty, cfg.line_bytes, 0)
        # install on miss (data is functionally in WRAM already)
        cidx = cset * ways + way

        def put(arr, vals):
            return arr.view(D, -1).scatter(1, cidx, vals).view(arr.shape)

        way_dirty = dirty_s.gather(1, way)
        dc_tags = put(dc_tags, torch.where(mem_v, line, tags_s.gather(1, way)))
        dc_lru = put(dc_lru, torch.where(mem_v, cycle1, lru_s.gather(1, way)))
        new_dirty = torch.where(miss, is_sw, way_dirty | is_sw)
        dc_dirty = put(dc_dirty, torch.where(mem_v, new_dirty, way_dirty))
        # miss blocks the tasklet behind a DRAM fill of the line
        selm = sel & miss
        status = torch.where(selm, BLK_DMA, status)
        req_valid = req_valid | selm
        req_mram = torch.where(selm, line * cfg.line_bytes, req_mram)
        req_bytes = torch.where(selm, fill_bytes, req_bytes)
        req_write = req_write & ~selm
        req_enq = torch.where(selm, cycle1, req_enq)
        c_dc_hit = c_dc_hit + hit.view(D).to(torch.int32)
        c_dc_miss = c_dc_miss + miss.view(D).to(torch.int32)

    # ---- atomics ----
    atomic = st["atomic"]
    mid = immv.clamp(0, atomic.shape[1] - 1).to(torch.int64)
    aold = atomic.gather(1, mid)
    held = aold != 0
    acq = valid & is_acq
    acq_ok = acq & ~held
    acq_retry = acq & held
    aval = torch.where(acq_ok, 1, torch.where(valid & is_rel, 0, aold))
    atomic = atomic.scatter(1, mid, aval)

    # ---- DMA ----
    do_dma = valid & is_dma
    size = torch.where(uiv, immv, rd_old).clamp(0, MAX_DMA_BYTES)
    seld = sel & do_dma
    status = torch.where(seld, BLK_DMA, status)
    req_valid = req_valid | seld
    req_wram = torch.where(seld, a, req_wram)
    req_mram = torch.where(seld, breg, req_mram)
    req_bytes = torch.where(seld, size, req_bytes)
    req_write = torch.where(seld, is_sdma, req_write)
    req_enq = torch.where(seld, cycle1, req_enq)

    # functional copy now (timing handled by the DRAM engine); data-race-free
    # programs observe identical results
    mram = st["mram"]
    _dma_copy(C, cfg, wram, mram, do_dma, a, breg, size, is_sdma, ctl)

    # ---- control flow ----
    eq = a == b
    lt = a < b
    ltu = (a ^ _INT32_MIN) < (b ^ _INT32_MIN)   # unsigned compare
    taken = torch.stack([eq, ~eq, lt, ~lt, ltu, ~ltu]).gather(
        0, bidx.to(torch.int64).view(1, D, 1)).view(D, 1)
    pc1 = pcv + 1
    new_pc = torch.where(is_br, torch.where(taken, immv, pc1),
             torch.where(is_jmp, immv,
             torch.where(is_jr, a,
             torch.where(acq_retry | is_stop, pcv, pc1))))
    pc = torch.where(selv, new_pc, st["pc"])

    status = torch.where(selv & is_stop, DONE,
             torch.where(selv & is_bar, BLK_BAR, status))

    # ---- issue gap: revolver / forwarding / long ops ----
    if cfg.forwarding:
        ld = st["last_dest"].gather(1, tsel)
        raw = (ld >= 0) & ((rd_ra & (ra_ == ld)) | (rb_dep & (rb_ == ld)))
        nxt = torch.maximum(cycle1 + 1, torch.where(
            raw, st["last_ready"].gather(1, tsel), 0))
    else:
        nxt = cycle1 + cfg.revolver_cycles
    next_issue = torch.where(selv, nxt + extra, st["next_issue"])
    last_dest = torch.where(selv, torch.where(wrd, rd_, -1), st["last_dest"])
    last_ready = torch.where(selv, cycle1 + lat, st["last_ready"])

    # ---- odd/even RF structural hazard ----
    valid = valid.view(D)
    if cfg.unified_rf:
        hazard = torch.zeros_like(valid)
    else:
        hazard = (valid.view(D, 1) & two & ((ra_ & 1) == (rb_ & 1))).view(D)
    # +2: the end-of-cycle decrement eats one, leaving the port busy for
    # exactly the next cycle (the second same-parity RF read slot)
    port_busy = st["port_busy"] + 2 * hazard.to(torch.int32)

    rr = torch.where(valid, ((tsel.view(D) + 1) % T).to(torch.int32),
                     st["rr"])

    # ---- counters ----
    vi = valid.to(torch.int32)
    c_cls = st["c_cls"].scatter_add(1, (cls * vi.view(D, 1)).to(torch.int64),
                                    vi.view(D, 1))
    rd_bytes = (size * (do_dma & ~is_sdma)).view(D)
    wr_bytes = (size * (do_dma & is_sdma)).view(D)
    new_st = dict(st)
    new_st.update(
        regs=regs, wram=wram, mram=mram, atomic=atomic, pc=pc, status=status,
        next_issue=next_issue, last_dest=last_dest, last_ready=last_ready,
        port_busy=port_busy, rr=rr,
        req_valid=req_valid, req_wram=req_wram, req_mram=req_mram,
        req_bytes=req_bytes, req_write=req_write, req_enq=req_enq,
        dc_tags=dc_tags, dc_lru=dc_lru, dc_dirty=dc_dirty,
        c_dc_hit=c_dc_hit, c_dc_miss=c_dc_miss,
        c_issued=st["c_issued"] + vi,
        c_cls=c_cls,
        c_acq_retry=st["c_acq_retry"] + acq_retry.view(D).to(torch.int32),
        c_dma_rd=st["c_dma_rd"] + (do_dma & ~is_sdma).view(D).to(torch.int32),
        c_dma_wr=st["c_dma_wr"] + (do_dma & is_sdma).view(D).to(torch.int32),
        c_dma_rd_bytes=st["c_dma_rd_bytes"] + rd_bytes.to(torch.float32),
        c_dma_wr_bytes=st["c_dma_wr_bytes"] + wr_bytes.to(torch.float32),
    )
    return new_st, valid, hazard, selv


# ---------------------------------------------------------------------------
# DRAM engine (per-DPU bank, FR-FCFS)
# ---------------------------------------------------------------------------


def _dram_step(cfg: DPUConfig, C: StepConsts, st, cycle, cycle1, go):
    D, T = st["status"].shape

    # completions (none once the run is over: ``go`` is the predicate)
    comp = st["eng_active"] & (st["eng_finish"] <= cycle) & go
    selc = (C.tt == st["eng_thread"].view(D, 1)) & comp.view(D, 1)
    status = torch.where(selc, RUN, st["status"])
    next_issue = torch.where(selc, cycle1 + 1, st["next_issue"])
    req_valid = st["req_valid"] & ~selc
    eng_active = st["eng_active"] & ~comp

    # FR-FCFS selection
    can = ~eng_active & req_valid.any(-1) & go
    row = _floordiv(st["req_mram"], cfg.row_bytes)
    hit = row == st["open_row"].view(D, 1)
    score = torch.where(req_valid, hit.to(torch.int32) * INF - st["req_enq"],
                        -INF)
    j = torch.argmax(score, -1, keepdim=True)
    b_j, m_j, row_j = torch.stack([st["req_bytes"], st["req_mram"], row]) \
        .gather(2, j.view(1, D, 1).expand(3, D, 1)).view(3, D).unbind(0)
    hit_j = row_j == st["open_row"]
    end_row = _floordiv(m_j + torch.clamp(b_j, min=1) - 1, cfg.row_bytes)
    overhead = _pick(hit_j, cfg.row_hit_overhead, cfg.row_miss_overhead)
    overhead = overhead + (end_row - row_j) * cfg.row_miss_overhead
    transfer = torch.ceil(b_j.to(torch.float32) * C.inv_bw).to(torch.int32)

    tlb_tags, tlb_lru = st["tlb_tags"], st["tlb_lru"]
    c_tlb_hit, c_tlb_miss = st["c_tlb_hit"], st["c_tlb_miss"]
    service = overhead + transfer
    if cfg.mmu:
        page = _floordiv(m_j, cfg.page_bytes).view(D, 1)
        match = tlb_tags == page
        t_hit = match.any(-1)
        way = torch.where(t_hit, torch.argmax(match.to(torch.int32), -1),
                          torch.argmin(tlb_lru, -1))
        selw = (C.tlb_ways == way.view(D, 1)) & can.view(D, 1)
        tlb_tags = torch.where(selw, page, tlb_tags)
        tlb_lru = torch.where(selw, cycle1, tlb_lru)
        c_tlb_hit = c_tlb_hit + (can & t_hit).to(torch.int32)
        c_tlb_miss = c_tlb_miss + (can & ~t_hit).to(torch.int32)
        service = service + _pick(t_hit, 0, cfg.row_miss_overhead)

    new = dict(st)
    new.update(
        status=status, next_issue=next_issue, req_valid=req_valid,
        eng_active=eng_active | can,
        eng_thread=torch.where(can, j.view(D).to(torch.int32),
                               st["eng_thread"]),
        eng_finish=torch.where(can, cycle + service, st["eng_finish"]),
        open_row=torch.where(can, end_row, st["open_row"]),
        tlb_tags=tlb_tags, tlb_lru=tlb_lru,
        c_tlb_hit=c_tlb_hit, c_tlb_miss=c_tlb_miss,
        c_row_hit=st["c_row_hit"] + (can & hit_j).to(torch.int32),
        c_row_miss=st["c_row_miss"] + (can & ~hit_j).to(torch.int32),
    )
    return new


# ---------------------------------------------------------------------------
# Full cycle step + main loop
# ---------------------------------------------------------------------------


def _classify_and_advance(cfg, C: StepConsts, st, cycle, running, issued_any,
                          n_ready0, go):
    D, T = st["status"].shape
    ni = torch.where(st["status"] == RUN, st["next_issue"], INF).amin(-1)
    df = torch.where(st["eng_active"], st["eng_finish"], INF)
    nxt = torch.minimum(ni, df)

    port_blocked = st["port_busy"] > 0
    idle = running & ~issued_any
    cycle_p1 = cycle + 1
    if cfg.event_skip:
        can_skip = idle & ~port_blocked & (nxt < INF)
        new_cycle = torch.where(
            running, torch.where(can_skip, torch.maximum(cycle_p1, nxt),
                                 cycle_p1), cycle)
    else:
        new_cycle = torch.where(running, cycle_p1, cycle)
    delta = new_cycle - cycle

    rf = idle & port_blocked & (n_ready0 > 0)
    mem = idle & ~rf & (df <= ni)
    rev = idle & ~rf & ~mem

    new = dict(st)
    if cfg.collect_detail:
        ri = running.to(torch.int32)
        hist = st["c_hist"].scatter_add(
            1, n_ready0.clamp(0, T).to(torch.int64).view(D, 1), ri.view(D, 1))
        hist[:, 0] += (delta - 1) * ri

        # TLP time series
        win = cfg.timeseries_window
        L = st["ts_buf"].shape[1]
        ts_acc = st["ts_acc"] + (n_ready0 * go).to(torch.float32)
        w_old = _floordiv(cycle, win)
        crossed = _floordiv(new_cycle, win) > w_old
        sels = (C.ts_lanes == w_old.clamp(0, L - 1).view(D, 1)) \
            & crossed.view(D, 1)
        ts_buf = torch.where(sels, (ts_acc * C.inv_win).view(D, 1),
                             st["ts_buf"])
        ts_acc = torch.where(crossed, 0.0, ts_acc)
        new.update(c_hist=hist, ts_buf=ts_buf, ts_acc=ts_acc)

    port_busy = st["port_busy"]
    new.update(cycle=new_cycle,
               port_busy=port_busy - (port_blocked & go).to(torch.int32),
               c_active=st["c_active"] + issued_any.to(torch.int32),
               c_idle_mem=st["c_idle_mem"] + delta * mem,
               c_idle_rev=st["c_idle_rev"] + delta * rev,
               c_idle_rf=st["c_idle_rf"] + delta * rf)
    return new


def _running(cfg: DPUConfig, st):
    alive = (st["status"] != DONE).any(-1)
    return alive & (st["cycle"] < cfg.max_cycles)


def make_cond(cfg: DPUConfig):
    """Termination predicate shared by every backend's driver: a 0-dim
    bool tensor on the state's device (reading it syncs the host)."""

    def cond(st):
        return _running(cfg, st).any()

    return cond


def _step(cfg: DPUConfig, C: StepConsts, ir, st, ctl: StepControl = None):
    """One simulated cycle: the new state (``ctl``: a rank's
    :class:`StepControl` of a sharded run)."""
    img = C.decode(ir)
    cycle = st["cycle"]
    D = cycle.shape[0]
    cycle1 = cycle.view(D, 1)
    running = _running(cfg, st)
    go = running.any()
    if ctl is not None and ctl.go is not None:
        go = torch.tensor(bool(ctl.go), device=go.device)

    st = _dram_step(cfg, C, st, cycle, cycle1, go)

    # barrier release
    status = st["status"]
    bar = status == BLK_BAR
    n_bar = bar.sum(-1)
    rel = (n_bar > 0) & (n_bar == (status != DONE).sum(-1)) & go
    relm = rel.view(D, 1) & bar
    st = dict(st)
    st["status"] = torch.where(relm, RUN, status)
    st["next_issue"] = torch.where(relm, cycle1 + 1, st["next_issue"])

    n_ready0 = ((st["status"] == RUN) & (st["next_issue"] <= cycle1)) \
        .sum(-1).to(torch.int32)

    issued_any = torch.zeros_like(running)
    already = None
    slot_block = torch.zeros_like(running)
    for s in range(cfg.superscalar):
        st, valid, hazard, im = _issue_one(
            cfg, C, img, st, cycle1, running, already, slot_block, ctl)
        issued_any = issued_any | valid
        already = im if already is None else (already | im)
        # an RF-hazard instruction consumes the second read slot:
        # block further same-cycle issue too
        slot_block = slot_block | hazard | ~valid

    return _classify_and_advance(cfg, C, st, cycle, running, issued_any,
                                 n_ready0, go)


def make_step_traced(cfg: DPUConfig, n_threads: int = None, device=None):
    """One simulated cycle as a function ``(ir, state) -> state``.

    ``ir`` is the instruction image: the 6 SoA int32 vectors of
    :class:`isa.Binary` stacked into one (6, P) tensor on the state's
    device.  The step decodes it once per image (:class:`StepConsts`,
    built here once per driver, on ``device``: None = the CUDA card, see
    :func:`~repro_torch.core.carry.resolve_device`).

    The step is gated on the termination predicate ``go`` (a device-side
    0-dim bool, no host sync): every state update is masked by
    ``running`` (so by ``go``) or by ``go`` itself, so a step taken
    after the run ended leaves every leaf unchanged.  WRAM and MRAM are
    updated in place; the other leaves are new tensors."""
    C = StepConsts(cfg, n_threads or cfg.n_tasklets,
                   resolve_device(device))

    def step(ir, st, ctl: StepControl = None):
        return _step(cfg, C, ir, st, ctl)

    return step


def run(cfg: DPUConfig, binary: isa.Binary, wram_init, mram_init,
        n_threads: int = None, ndpus_reg: int = None, device=None):
    """Simulate to completion; returns the final state (host numpy pytree).

    Launches the ``"scalar"`` backend through
    :mod:`repro_torch.core.compile_cache` on ``device`` (None = the CUDA
    card; pass ``"cpu"`` for the CPU)."""
    from repro_torch.core import compile_cache
    return compile_cache.run(cfg, binary, wram_init, mram_init,
                             n_threads=n_threads, backend="scalar",
                             ndpus_reg=ndpus_reg, device=device)
