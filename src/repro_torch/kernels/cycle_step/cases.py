"""Launches that drive every branch of the cycle step, for holding the
fused kernel against its plain version (the card tests and
``chip_smoke.py``) and the plain version against the JAX package (the CPU
tests).

:data:`CASES` maps a name to ``(program builder, tasklets, DPUConfig
fields, MRAM filled with its word index?)``: the programs of
``tests/test_engine.py`` and the case studies' knobs (which
``tests/test_torch_engine.py`` holds against the JAX package), the widest
DPUs the kernel takes (24 and 32 tasklets, 4 and 8 issue slots), and
``cross_dpu``: 40 DPUs (padded to 64, 16 blocks of the kernel)
that stop at different cycles, hit ``max_cycles`` in one run, and issue,
in one slot of one cycle, 256-byte DMAs that cover the last WRAM word
beside 1500-byte ones on other DPUs, so the copy window is the widest
DMA's across DPUs; ``cross_pair`` the same on 8 DPUs, sized by DPU pair,
for a run split over 4 ranks.  :func:`cache_va` is the cache-mode VA (case study
#4), :func:`va` VA's launch at any DPU count.  :func:`launch` turns a
case into ``(cfg, binary, wram, mram, T)``; :func:`hold_against_plain`
holds the card kernel of any backend's launch against its plain version
(the SIMT and CRF kernels' cases use it too).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.asm import CACHE_DATA_BASE, DPU_ID, TID, ZERO, Program
from repro_torch.core.config import DPUConfig
from repro_torch.core.isa import Op


def _alu_prog(seed=0, n=24):
    rng = np.random.default_rng(seed)
    ops = [Op.ADD, Op.SUB, Op.AND, Op.OR, Op.XOR, Op.SLL, Op.SRL, Op.SRA,
           Op.MUL, Op.DIV, Op.SLT, Op.SLTU]
    p = Program("alu", 1)
    ra, rb, rd = p.regs("a", "b", "d")
    for i in range(n):
        a, b = (int(x) for x in rng.integers(-2**31, 2**31 - 1, 2))
        if i % 5 == 0:
            b = int(rng.integers(-3, 40))
        if i == 1:
            a, b = -2**31, -1
        p.li(ra, a)
        p.li(rb, b)
        p._emit(ops[i % 12], rd, ra, rb)
        p.sw(ZERO, 64 + 4 * i, rd)
    p.stop()
    return p


def _chain_prog(n_instr=20):
    p = Program("chain", 1)
    r = p.reg("r")
    for _ in range(n_instr):
        p.add(r, r, 1)
    p.stop()
    return p


def _rf_prog():
    p = Program("rf", 2)
    a = p.reg("a")
    _ = p.reg("pad")
    b = p.reg("b")
    for _ in range(30):
        p.add(a, a, b)
    p.stop()
    return p


def _ss_prog(nt=2):
    p = Program("ss", nt)
    r = p.reg("r")
    for _ in range(64):
        p.add(r, r, 1)
        p.mul(r, r, 3)
    p.stop()
    return p


def _dma_prog():
    p = Program("skip", 2)
    buf = p.walloc("buf", 64)
    w, m = p.regs("w", "m")
    p.li(w, buf)
    p.li(m, 128)
    for _ in range(4):
        p.ldma(w, m, 64)
        p.sdma(w, m, 64)
    p.barrier()
    p.stop()
    return p


def _mutex_prog(nt=4):
    p = Program("mutex", nt)
    cnt = p.walloc("cnt", 8)
    v, i = p.regs("v", "i")
    with p.for_range(i, 0, 3):
        p.acquire(0)
        p.lw(v, ZERO, cnt)
        p.add(v, v, 1)
        p.sw(ZERO, cnt, v)
        p.release(0)
    p.stop()
    return p


def _barrier_prog(nt=4):
    p = Program("bar", nt)
    flag = p.walloc("flag", 8)
    out = p.walloc("out", 4 * nt)
    v, addr = p.regs("v", "addr")
    sk = p.newlabel("sk")
    p.bne(TID, ZERO, sk)
    p.li(v, 1234)
    p.sw(ZERO, flag, v)
    p.label(sk)
    p.barrier()
    p.lw(v, ZERO, flag)
    p.sll(addr, TID, 2)
    p.add(addr, addr, out)
    p.sw(addr, 0, v)
    p.stop()
    return p


def _frfcfs_prog(nt=4):
    p = Program("fr", nt)
    buf = p.walloc("buf", nt * 64)
    w, m, i = p.regs("w", "m", "i")
    p.mul(w, TID, 64)
    p.add(w, w, buf)
    p.mul(m, TID, 64)
    with p.for_range(i, 0, 8):
        p.ldma(w, m, 64)
        p.add(m, m, 256)
    p.stop()
    return p


def _dyn_dma_prog():
    p = Program("dyn", 1)
    buf = p.walloc("buf", 2048)
    w, m, sz = p.regs("w", "m", "sz")
    p.li(w, buf)
    p.li(m, 256)
    p.li(sz, 32)
    p.ldma(w, m, sz)
    p.li(sz, 1500)          # past the 64-word fast path: full-width copy
    p.ldma(w, m, sz)
    p.sdma(w, m, 8)
    p.stop()
    return p


def _tail_dma_prog(W=16384):
    """DMAs whose copy window runs past the last WRAM / MRAM word: the
    clipped lanes collide on the last word (last write wins)."""
    p = Program("tail", 1)
    w, m = p.regs("w", "m")
    p.li(w, 4 * (W - 2))
    p.li(m, 0)
    p.ldma(w, m, 8)          # covers the last WRAM word
    p.li(w, 4 * (W - 40))
    p.ldma(w, m, 64)         # window past the end, data inside
    p.li(m, 4 * ((1 << 14) // 4 - 4))
    p.sdma(w, m, 16)         # covers the last MRAM word
    p.li(w, -64)
    p.ldma(w, m, 16)         # negative WRAM address: clipped to word 0
    p.stop()
    return p


def _jr_prog():
    """A JR to a target past the program and a negative one: the image
    gather clamps (JAX semantics) instead of faulting."""
    p = Program("jr", 2)
    t = p.reg("t")
    sk = p.newlabel("sk")
    p.bne(TID, ZERO, sk)
    p.li(t, 5000)
    p._emit(Op.JR, 0, t)
    p.label(sk)
    p.li(t, -3)
    p._emit(Op.JR, 0, t)
    p.stop()
    return p


def _mix_prog(nt=24):
    """Every tasklet: a DMA in, LW/SW on what came in, a DMA out, one
    round of a mutex-guarded shared counter, a barrier, then tasklet 0
    reads the counter (wide DPUs: 24 and 32 tasklets, up to 8 slots)."""
    p = Program("mix", nt)
    buf = p.walloc("buf", nt * 64)
    cnt = p.walloc("cnt", 8)
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
    p.acquire(0)
    p.lw(v, ZERO, cnt)
    p.add(v, v, 1)
    p.sw(ZERO, cnt, v)
    p.release(0)
    p.barrier()
    p.bne(TID, ZERO, sk)
    p.lw(v, ZERO, cnt)
    p.sw(ZERO, cnt + 4, v)
    p.label(sk)
    p.stop()
    return p


def _cross_dpu_prog(nt=4, W=16384, pair=1):
    """Per DPU: 1 + DPU_ID % 3 rounds of one DMA per tasklet, 256 bytes
    onto the last 64 WRAM words on even DPUs, 1500 bytes (clipped at the
    end of WRAM) on odd ones; MRAM rows end-to-end so the last round of
    tasklet nt - 1 covers the last MRAM word of a 16 KiB bank.  ``pair``
    > 1: the size by DPU_ID // pair instead (DPUs 0 to pair - 1 even)."""
    p = Program("xdpu" if pair == 1 else "xpair", nt)
    w, m, sz, i, n, t = p.regs("w", "m", "sz", "i", "n", "t")
    p.li(w, 4 * (W - 64))
    p.mul(m, TID, 1024)
    if pair == 1:
        p.and_(t, DPU_ID, 1)
    else:
        p.div(t, DPU_ID, pair)
        p.and_(t, t, 1)
    p.mul(sz, t, 1244)
    p.add(sz, sz, 256)
    p.li(n, 3)
    p.div(t, DPU_ID, n)
    p.mul(t, t, n)
    p.sub(n, DPU_ID, t)
    p.add(n, n, 1)
    with p.for_range(i, 0, n):
        p.ldma(w, m, sz)
        p.add(t, m, 12544)
        p.sdma(w, t, 256)
        p.add(m, m, 256)
    p.barrier()
    p.stop()
    return p


#: name -> (program builder, tasklets, DPUConfig fields, MRAM data?)
CASES = {
    "alu": (_alu_prog, 1, {}, False),
    "revolver": (_chain_prog, 1, {}, False),
    "forwarding": (_chain_prog, 1, {"forwarding": True}, False),
    "rf_parity": (_rf_prog, 2, {}, False),
    "unified_rf": (_rf_prog, 2, {"unified_rf": True}, False),
    "superscalar": (_ss_prog, 2, {"forwarding": True, "unified_rf": True,
                                  "superscalar": 2}, False),
    "event_skip_off": (_dma_prog, 2, {"n_dpus": 2, "event_skip": False}, True),
    "event_skip_on": (_dma_prog, 2, {"n_dpus": 2}, True),
    "mutex": (_mutex_prog, 4, {}, False),
    "barrier": (_barrier_prog, 4, {}, False),
    "frfcfs": (_frfcfs_prog, 4, {}, True),
    "dma_dynamic": (_dyn_dma_prog, 1, {}, True),
    "dma_tail_clip": (_tail_dma_prog, 1, {}, True),
    "jr_clamp": (_jr_prog, 2, {"max_cycles": 400}, False),
    "mmu": (_frfcfs_prog, 4, {"mmu": True, "tlb_entries": 2,
                              "page_bytes": 256}, True),
    "mram_bw_scale": (_dma_prog, 2, {"mram_bw_scale": 1.3,
                                     "timeseries_window": 100}, True),
    "no_detail": (_dma_prog, 2, {"collect_detail": False}, True),
    "tasklets_24": (_mix_prog, 24, {}, True),
    "tasklets_32": (lambda: _mix_prog(32), 32, {"timeseries_window": 64},
                    True),
    "superscalar_4": (lambda: _ss_prog(8), 8, {
        "forwarding": True, "unified_rf": True, "superscalar": 4}, False),
    "superscalar_8": (lambda: _mix_prog(32), 32, {
        "forwarding": True, "unified_rf": True, "superscalar": 8}, True),
    "superscalar_8_alu": (lambda: _ss_prog(24), 24, {
        "forwarding": True, "superscalar": 8}, False),
    "cross_dpu": (_cross_dpu_prog, 4, {"n_dpus": 40, "superscalar": 2,
                                       "timeseries_window": 64}, True),
    "cross_dpu_max_cycles": (_cross_dpu_prog, 4, {
        "n_dpus": 40, "max_cycles": 1500, "mmu": True, "tlb_entries": 4,
        "page_bytes": 512}, True),
    # the DPU axis split 2 a rank over 4 ranks (compile_cache.Shard): DPUs
    # 0-1 and 4-5 (ranks 0 and 2) copy 256 bytes onto the last 64 WRAM
    # words (a DMA whose result depends on the window) in the step in
    # which DPUs 2-3 and 6-7 (ranks 1 and 3) copy 1,500 bytes, so ranks 0
    # and 2 replay with the system's windows; the DPUs stop at different
    # cycles, so ranks with stopped DPUs catch up
    "cross_pair": (lambda: _cross_dpu_prog(pair=2), 4, {
        "n_dpus": 8, "superscalar": 2, "timeseries_window": 64}, True),
    "cross_pair_max_cycles": (lambda: _cross_dpu_prog(pair=2), 4, {
        "n_dpus": 8, "max_cycles": 1500, "mmu": True, "tlb_entries": 4,
        "page_bytes": 512}, True),
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


def cache_va(n_dpus: int = 2, scale: float = 0.006):
    """``(cfg, binary, wram, mram, T)`` of a cache-centric VA (LW/SW
    through the D$ model, data linked above ``CACHE_DATA_BASE``)."""
    import repro_torch.workloads as wl
    cfg = DPUConfig(n_dpus=n_dpus, n_tasklets=4, mram_bytes=1 << 14,
                    cache_mode=True, dcache_bytes=1024)
    W = wl.get("VA")
    hd = W.host_data(cfg, scale, 0, cache_mode=True)
    binary = W.build(4, cache_mode=True).binary(cfg.iram_instrs)
    base = CACHE_DATA_BASE // 4
    wram = np.zeros((n_dpus, base + hd.mram.shape[1]), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    wram[:, base:] = hd.mram
    return cfg, binary, wram, np.zeros((n_dpus, 2), np.int32), 4


def va(n_dpus: int, scale: float = 0.02, T: int = 16):
    """``(cfg, binary, wram, mram, T)`` of VA's launch as the workload
    sets it up (its args and MRAM image, seed 0), on ``n_dpus`` DPUs."""
    import repro_torch.workloads as wl
    cfg = DPUConfig(n_dpus=n_dpus, n_tasklets=T, mram_bytes=1 << 14)
    W = wl.get("VA")
    hd = W.host_data(cfg, scale, 0)
    binary = W.build(T).binary(cfg.iram_instrs)
    wram = np.zeros((n_dpus, 16), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    return cfg, binary, wram, hd.mram, T


def hold_against_plain(case, k: int, device="cuda", checkpoints=(1, 7),
                       max_steps: int = 1 << 20, edit=None,
                       routes=None, dpus: int = None) -> dict:
    """Run the card kernel of the case's backend (``ExecBackend
    .card_kernel``: ``cycle_step``, ``simt_step`` or ``crf_step``) and its
    plain version (the backend's eager step on the same device) side by
    side from one padded initial state, as the driver pads it, until the
    predicate turns false: ``k`` steps per launch, and launches cut short
    at ``checkpoints``.  After each checkpoint and at the end every leaf
    must be bitwise equal (floats too) and the predicates equal; raises
    ``AssertionError`` naming the first leaf that differs.  ``case``:
    ``(cfg, binary, wram, mram, T)``; ``edit``: a function that changes
    the padded numpy state before both start (or None); ``routes``: the
    kernel's routes asked for (``StepDriver.like``), each driver on its
    own copy of the state, all held against the one plain run (None: one
    driver, the kernel's own pick); ``dpus``: the DPUs the state is padded
    to (None: the driver's bucket, ``compile_cache.dpu_bucket``).

    Returns ``{"steps", "launches", "alu_launches", "kernel", "route",
    "routes"}``: the steps taken, each kernel's launches, the ALU kernel's
    launches made inside them (the fused kernels launch none), the
    driver's class name, and its route (``CycleStep.route``; None for
    the others), and every route's."""
    import torch
    from repro_torch.core import backend, compile_cache
    from repro_torch.core.carry import state_to_torch
    from repro_torch.kernels.alu_exec import ops as alu_ops
    cfg, binary, wram, mram, T = case
    be = backend.get(backend.resolve_backend(cfg))
    Dp = dpus or compile_cache.dpu_bucket(cfg.n_dpus)
    assert Dp >= cfg.n_dpus, f"dpus {Dp} < the case's {cfg.n_dpus}"
    st0 = compile_cache._padded_state(cfg, be, binary,
                                      np.asarray(wram, np.int32),
                                      np.asarray(mram, np.int32), T, Dp)
    if edit is not None:
        edit(st0)
    P = compile_cache.program_bucket(binary.n_instrs,
                                     binary.opcode.shape[0])
    ir_np = np.stack([np.asarray(a[:P], np.int32) for a in binary.arrays])
    ir = torch.from_numpy(ir_np).to(device)
    plain = state_to_torch(st0, device)
    kcfg = cfg.replace(n_dpus=Dp)
    kern = be.card_kernel(kcfg, state_to_torch(st0, device), ir, ir_np)
    kerns = [kern] if routes is None else [
        kern.like(state_to_torch(st0, device), r) for r in routes]
    step, cond = be.step_driver(kcfg, T, torch.device(device))
    marks = sorted(checkpoints)
    n = launches = alu = 0
    while n < max_steps:
        size = min([k] + [m - n for m in marks if m > n])
        alu0 = alu_ops.launches
        for kern in kerns:
            kern.launch(size)
        alu += alu_ops.launches - alu0
        launches += 1
        for _ in range(size):
            plain.update(step(ir, plain))
        n += size
        going = bool(cond(plain))
        for kern in kerns:
            tag = f"after {n} steps ({getattr(kern, 'route', None)})"
            if n in marks or not going:
                _assert_same(plain, kern.st, tag)
            assert kern.predicate() == going, f"predicate {tag}"
        if not going:
            return {"steps": n, "launches": launches, "alu_launches": alu,
                    "kernel": type(kerns[0]).__name__,
                    "route": getattr(kerns[0], "route", None),
                    "routes": [getattr(kern, "route", None)
                               for kern in kerns]}
    raise AssertionError(f"still running after {max_steps} steps")


def _assert_same(want, got, tag):
    import torch
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.float32:     # bitwise, not by value
            w, g = w.view(torch.int32), g.view(torch.int32)
        if not torch.equal(w, g):
            bad = int((w != g).sum())
            raise AssertionError(f"{tag}: leaf {name!r} differs in {bad} "
                                 f"of {w.numel()} elements")
