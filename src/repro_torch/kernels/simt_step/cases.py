"""Launches that drive every branch of the SIMT step, for holding the
kernel against its plain version (the card tests and ``chip_smoke.py``)
and the plain version against the JAX package (the CPU tests).

:data:`CASES` maps a name to ``(program builder, tasklets, DPUConfig
fields, MRAM filled with its word index?)``: a divergent branch,
``ACQUIRE``/``RELEASE`` serialised across warps, a barrier, FR-FCFS
between several warps' DMAs, the coalescer on and off with lanes in the
same and in different rows, ``mram_bw_scale`` 4 and 16, ``event_skip``
off, colliding SW, DMA windows over the last WRAM and MRAM words and
overlapping each other, warps of 4, 8, 16 and 32 tasklets, the HBM-PIM
all-bank compat target, an ``ACQUIRE`` livelock capped by
``max_cycles`` (HST-L's and TRNS's spin), and ``xdpu``: 40 DPUs (padded to
64, 10 blocks of the kernel) that stop at different cycles and hit
``max_cycles`` in one run.  :func:`launch` turns a case into ``(cfg,
binary, wram, mram, T)``, which
``repro_torch.kernels.cycle_step.cases.hold_against_plain`` holds against
the plain version.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.asm import DPU_ID, TID, ZERO, Program
from repro_torch.core.config import DPUConfig
from repro_torch.kernels.cycle_step.cases import (_barrier_prog,
                                                  _frfcfs_prog, _mutex_prog)


def _diverge_prog(nt=8):
    """Odd and even lanes take different paths of a loop whose trip count
    depends on the lane, then reconverge and store."""
    p = Program("diverge", nt)
    out = p.walloc("out", 4 * nt)
    v, t, i, n, addr = p.regs("v", "t", "i", "n", "addr")
    odd, join = p.newlabel("odd"), p.newlabel("join")
    p.and_(t, TID, 1)
    p.add(n, TID, 1)
    p.bne(t, ZERO, odd)
    with p.for_range(i, 0, n):
        p.add(v, v, 3)
    p.jump(join)
    p.label(odd)
    p.mul(v, TID, 7)
    p.div(v, v, 2)
    p.label(join)
    p.sll(addr, TID, 2)
    p.add(addr, addr, out)
    p.sw(addr, 0, v)
    p.stop()
    return p


def _lane0_mutex_prog(nt=8, W=4):
    """The first lane of each warp takes a mutex-guarded count (serialised
    across warps; the other lanes branch past it), then a barrier."""
    p = Program("mutexw", nt)
    cnt = p.walloc("cnt", 8)
    v, t = p.regs("v", "t")
    sk = p.newlabel("sk")
    p.and_(t, TID, W - 1)
    p.bne(t, ZERO, sk)
    p.acquire(0)
    p.lw(v, ZERO, cnt)
    p.add(v, v, 1)
    p.sw(ZERO, cnt, v)
    p.release(0)
    p.label(sk)
    p.barrier()
    p.lw(v, ZERO, cnt)
    p.stop()
    return p


def _rows_prog(nt=8, stride=64):
    """Each lane DMAs ``stride`` bytes apart in MRAM (64: lanes share a
    1 KiB row; 1024: one row a lane), three rounds, in and out."""
    p = Program("rows", nt)
    buf = p.walloc("buf", nt * 64)
    w, m, i, o = p.regs("w", "m", "i", "o")
    p.mul(w, TID, 64)
    p.add(w, w, buf)
    p.mul(m, TID, stride)
    with p.for_range(i, 0, 3):
        p.ldma(w, m, 64)
        p.add(o, m, 8192)
        p.sdma(w, o, 32)
        p.add(m, m, 2048)
    p.stop()
    return p


def _sw_collide_prog(nt=8):
    """Every lane stores its TID to one word (the last lane wins), lanes
    in pairs to a second word, then each reads both back."""
    p = Program("swc", nt)
    buf = p.walloc("buf", 64)
    v, t, addr = p.regs("v", "t", "addr")
    p.add(v, TID, 100)
    p.sw(ZERO, buf, v)
    p.srl(t, TID, 1)
    p.sll(addr, t, 2)
    p.add(addr, addr, buf + 4)
    p.sw(addr, 0, v)
    p.lw(v, ZERO, buf)
    p.lw(t, addr, 0)
    p.add(v, v, t)
    p.sll(addr, TID, 2)
    p.sw(addr, buf + 128, v)
    p.stop()
    return p


def _tail_prog(nt=4, W=16384, M=4096):
    """DMA windows that run past the last WRAM word and the last MRAM word
    (clipped onto it), lie below word 0, and overlap other lanes'
    windows."""
    p = Program("tailw", nt)
    w, m, sz, t = p.regs("w", "m", "sz", "t")
    p.mul(t, TID, 8)
    p.li(w, 4 * (W - 16))
    p.add(w, w, t)                 # lane windows overlap, run past the end
    p.mul(m, TID, 4)
    p.ldma(w, m, 64)
    p.li(w, 4 * (M - 6))
    p.add(m, w, t)
    p.li(w, 64)
    p.sdma(w, m, 40)               # MRAM windows past the last word
    p.mul(w, TID, -16)
    p.li(sz, 32)
    p.ldma(w, m, sz)               # WRAM below word 0 for lanes 1..
    p.stop()
    return p


def _mix_prog(nt=16):
    """A DMA in, LW/SW on what came in, a DMA out, a barrier, a branch on
    the lane and a multiply-divide chain (widths 4-32)."""
    p = Program("mixs", nt)
    buf = p.walloc("buf", nt * 64)
    w, m, v, t = p.regs("w", "m", "v", "t")
    sk = p.newlabel("sk")
    p.mul(w, TID, 64)
    p.add(w, w, buf)
    p.mul(m, TID, 64)
    p.ldma(w, m, 64)
    p.lw(v, w, 4)
    p.add(v, v, TID)
    p.sw(w, 0, v)
    p.add(t, m, 4096)
    p.sdma(w, t, 64)
    p.barrier()
    p.and_(t, TID, 3)
    p.bne(t, ZERO, sk)
    p.mul(v, v, 13)
    p.div(v, v, 5)
    p.label(sk)
    p.sw(w, 8, v)
    p.stop()
    return p


def _xdpu_prog(nt=8):
    """1 + DPU_ID % 3 rounds of a DMA per lane, then a barrier: DPUs stop
    at different cycles."""
    p = Program("xdpus", nt)
    buf = p.walloc("buf", nt * 64)
    w, m, i, n, t = p.regs("w", "m", "i", "n", "t")
    p.mul(w, TID, 64)
    p.add(w, w, buf)
    p.mul(m, TID, 256)
    p.li(n, 3)
    p.div(t, DPU_ID, n)
    p.mul(t, t, n)
    p.sub(n, DPU_ID, t)
    p.add(n, n, 1)
    with p.for_range(i, 0, n):
        p.ldma(w, m, 128)
        p.add(m, m, 2048)
    p.barrier()
    p.stop()
    return p


#: name -> (program builder, tasklets, DPUConfig fields, MRAM data?)
CASES = {
    "diverge": (_diverge_prog, 8, {"simt_width": 4}, False),
    "mutex_warps": (_lane0_mutex_prog, 8, {"simt_width": 4}, False),
    "barrier": (lambda: _barrier_prog(8), 8, {"simt_width": 4}, False),
    "frfcfs": (lambda: _frfcfs_prog(8), 8, {"simt_width": 4}, True),
    "rows_ac": (_rows_prog, 8, {"simt_width": 8, "coalescing": True}, True),
    "rows_no_ac": (_rows_prog, 8, {"simt_width": 8}, True),
    "rows_apart_ac": (lambda: _rows_prog(8, 1024), 8,
                      {"simt_width": 8, "coalescing": True}, True),
    "bw_4x": (_rows_prog, 8, {"simt_width": 4, "coalescing": True,
                              "mram_bw_scale": 4.0}, True),
    "bw_16x": (lambda: _rows_prog(8, 1024), 8, {
        "simt_width": 8, "coalescing": True, "mram_bw_scale": 16.0}, True),
    "event_skip_off": (lambda: _frfcfs_prog(8), 8,
                       {"simt_width": 4, "event_skip": False}, True),
    "sw_collide": (_sw_collide_prog, 8, {"simt_width": 8}, False),
    "dma_tail": (_tail_prog, 4, {"simt_width": 4}, True),
    "width_4": (lambda: _mix_prog(16), 16, {"simt_width": 4}, True),
    "width_8": (lambda: _mix_prog(16), 16, {"simt_width": 8,
                                            "coalescing": True}, True),
    "width_16": (lambda: _mix_prog(16), 16, {"simt_width": 16}, True),
    "width_32": (lambda: _mix_prog(32), 32, {"simt_width": 32,
                                             "coalescing": True}, True),
    "allbank": (lambda: _mix_prog(16), 16, {"backend": "hbmpim"}, True),
    "livelock_capped": (lambda: _mutex_prog(8), 8,
                        {"simt_width": 4, "max_cycles": 3000}, False),
    "xdpu": (_xdpu_prog, 8, {"n_dpus": 40, "simt_width": 4,
                             "max_cycles": 2500}, True),
    "padded_lanes": (_xdpu_prog, 8, {"n_dpus": 3, "simt_width": 8,
                                     "coalescing": True}, True),
}


def launch(name: str, n_dpus: int = None):
    """``(cfg, binary, wram, mram, T)`` of case ``name`` (``n_dpus``
    overrides the case's DPU count)."""
    build, T, kw, mram_data = CASES[name]
    fields = dict(n_dpus=1, n_tasklets=T, mram_bytes=1 << 14)
    fields.update(kw)
    if n_dpus is not None:
        fields["n_dpus"] = n_dpus
    cfg = DPUConfig(**fields)
    binary = build().binary(cfg.iram_instrs)
    wram = np.zeros((cfg.n_dpus, 16), np.int32)
    if mram_data:
        mram = np.arange(cfg.n_dpus * cfg.mram_words,
                         dtype=np.int32).reshape(cfg.n_dpus, -1)
    else:
        mram = np.zeros((cfg.n_dpus, cfg.mram_words), np.int32)
    return cfg, binary, wram, mram, T
