"""The port's cycle engine and driver (repro_torch.core.engine and
compile_cache) against the JAX package, bit for bit: every state leaf
after 1, 7 and all steps on the programs of tests/test_engine.py, and
the driver's padding, cache counters and K-steps-per-check gating."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.workloads as ref_wl  # noqa: E402
from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.asm import DPU_ID, Program, TID, ZERO  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.isa import Op  # noqa: E402
from repro_torch.core import compile_cache as pt_cc  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core.carry import (binary_from, config_from,  # noqa: E402
                                    state_to_numpy, state_to_torch)

_REF_STEPS = {}


def _ref_driver(cfg):
    key = cfg.static_key()
    if key not in _REF_STEPS:
        _REF_STEPS[key] = (jax.jit(ref_engine.make_step_traced(cfg)),
                           jax.jit(ref_engine.make_cond(cfg)))
    return _REF_STEPS[key]


def _assert_same(ref, got, tag):
    assert sorted(ref) == sorted(got), tag
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert r.dtype == g.dtype and r.shape == g.shape, (tag, k)
        assert r.tobytes() == g.tobytes(), (tag, k)   # bitwise, floats too


def _lockstep(cfg, binary, wram, mram, T, checkpoints=(1, 7)):
    """Step the JAX engine and the port side by side until the reference
    predicate turns false; compare every leaf at the checkpoints and at
    the end.  Returns (steps, final reference state)."""
    st_np = ref_engine.make_state_np(cfg, binary, wram, mram, T)
    pcfg, pbin = config_from(cfg), binary_from(binary)
    pt_np = pt_engine.make_state_np(pcfg, pbin, wram, mram, T)
    _assert_same(st_np, pt_np, "initial state")
    step, cond = _ref_driver(cfg)
    ref_st = jax.tree_util.tree_map(jnp.asarray, st_np)
    ir_ref = tuple(jnp.asarray(x) for x in binary.arrays)
    pstep = pt_engine.make_step_traced(pcfg, T, "cpu")
    pcond = pt_engine.make_cond(pcfg)
    ir_pt = torch.from_numpy(np.stack(pbin.arrays))
    pt_st = state_to_torch(pt_np, "cpu")
    n = 0
    while bool(cond(ref_st)):
        ref_st = step(ir_ref, ref_st)
        pt_st = pstep(ir_pt, pt_st)
        n += 1
        if n in checkpoints:
            _assert_same(jax.tree_util.tree_map(np.asarray, ref_st),
                         state_to_numpy(pt_st), f"step {n}")
    assert not bool(pcond(pt_st))
    ref_np = jax.tree_util.tree_map(np.asarray, ref_st)
    _assert_same(ref_np, state_to_numpy(pt_st), f"final (step {n})")
    return n, ref_np


def _cfg(T, **kw):
    base = dict(n_dpus=1, n_tasklets=T, mram_bytes=1 << 14)
    base.update(kw)
    return DPUConfig(**base)


def _images(cfg, args=(), mram=None):
    wram = np.zeros((cfg.n_dpus, 16), np.int32)
    for i, a in enumerate(args):
        wram[:, i] = a
    if mram is None:
        mram = np.zeros((cfg.n_dpus, cfg.mram_words), np.int32)
    return wram, mram


# ---------------------------------------------------------------------------
# programs of tests/test_engine.py (:76-268) and the case-study branches
# ---------------------------------------------------------------------------


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


def _ss_prog():
    p = Program("ss", 2)
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


def _tail_dma_prog(W):
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


def _mram_arange(cfg):
    return np.arange(cfg.n_dpus * cfg.mram_words,
                     dtype=np.int32).reshape(cfg.n_dpus, -1)


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
    "dma_tail_clip": (lambda: _tail_dma_prog(16384), 1, {}, True),
    "jr_clamp": (_jr_prog, 2, {"max_cycles": 400}, False),
    "mmu": (_frfcfs_prog, 4, {"mmu": True, "tlb_entries": 2,
                              "page_bytes": 256}, True),
    "mram_bw_scale": (_dma_prog, 2, {"mram_bw_scale": 1.3,
                                     "timeseries_window": 100}, True),
    "no_detail": (_dma_prog, 2, {"collect_detail": False}, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_leaf_matches_reference(name):
    build, T, kw, mram_data = CASES[name]
    cfg = _cfg(T, **kw)
    binary = build().binary(cfg.iram_instrs)
    wram, mram = _images(cfg, mram=_mram_arange(cfg) if mram_data else None)
    n, _ = _lockstep(cfg, binary, wram, mram, T)
    assert n >= 7


def test_cache_mode_matches_reference():
    """Case study #4: a cache-centric VA (LW/SW through the D$ model)."""
    cfg = DPUConfig(n_dpus=2, n_tasklets=4, mram_bytes=1 << 14,
                    cache_mode=True, dcache_bytes=1024)
    W = ref_wl.get("VA")
    hd = W.host_data(cfg, 0.006, 0, cache_mode=True)
    binary = W.build(4, cache_mode=True).binary(cfg.iram_instrs)
    from repro.core.asm import CACHE_DATA_BASE
    base = CACHE_DATA_BASE // 4
    wram = np.zeros((2, base + hd.mram.shape[1]), np.int32)
    wram[:, :hd.args.shape[1]] = hd.args
    wram[:, base:] = hd.mram
    n, st = _lockstep(cfg, binary, wram, np.zeros((2, 2), np.int32), 4)
    assert st["c_dc_miss"].sum() > 0 and st["c_dc_hit"].sum() > 0


# ---------------------------------------------------------------------------
# driver: padding, cache counters, K steps per predicate check
# ---------------------------------------------------------------------------


def _multi_prog(nt=4):
    """DPU- and tasklet-dependent DMA traffic (rows differ per DPU)."""
    p = Program("multi", nt)
    buf = p.walloc("buf", nt * 64)
    w, m, i, v = p.regs("w", "m", "i", "v")
    p.mul(w, TID, 64)
    p.add(w, w, buf)
    p.mul(m, DPU_ID, 1024)
    p.mul(i, TID, 64)
    p.add(m, m, i)
    with p.for_range(i, 0, 3):
        p.ldma(w, m, 64)
        p.lw(v, w, 4)
        p.add(v, v, DPU_ID)
        p.sw(w, 0, v)
        p.sdma(w, m, 32)
        p.add(m, m, 256)
    p.stop()
    return p


def _setup(n_dpus=3, n_threads=4, **kw):
    cfg = DPUConfig(n_dpus=n_dpus, n_tasklets=16, mram_bytes=1 << 14, **kw)
    binary = _multi_prog(n_threads).binary(cfg.iram_instrs)
    wram = np.zeros((n_dpus, 16), np.int32)
    return cfg, binary, wram, _mram_arange(cfg)


def test_padded_equals_unpadded_and_reference():
    cfg, binary, wram, mram = _setup(n_dpus=3)       # DPU bucket 4
    pcfg, pbin = config_from(cfg), binary_from(binary)
    padded = pt_cc.run(pcfg, pbin, wram, mram, 4, pad=True, device="cpu")
    exact = pt_cc.run(pcfg, pbin, wram, mram, 4, pad=False, device="cpu")
    _assert_same(exact, padded, "padded vs unpadded")
    ref = ref_cc.run(cfg, binary, wram, mram, 4)
    _assert_same(ref, padded, "port vs reference")


def test_same_shape_relaunch_adds_no_miss():
    cfg, binary, wram, mram = _setup(n_dpus=2)
    pcfg, pbin = config_from(cfg), binary_from(binary)
    pt_cc.clear()
    out0 = pt_cc.run(pcfg, pbin, wram, mram, 4, device="cpu")
    assert pt_cc.stats()["misses"] == 1
    out1 = pt_cc.run(pcfg, pbin, wram, mram, 4, device="cpu")
    s = pt_cc.stats()
    assert s["misses"] == 1 and s["hits"] == 1 and s["launches"] == 2, s
    assert s["steps"] > 0
    _assert_same(out0, out1, "relaunch")
    key = pt_cc.prewarm(pcfg, pbin, mram_words=mram.shape[1], n_threads=4,
                        device="cpu")
    assert pt_cc.stats()["misses"] == 1
    assert key in [i["key"] for i in pt_cc.cache_info()]


@pytest.mark.parametrize("max_cycles", [200_000_000, 150])
def test_steps_per_check_do_not_change_the_result(max_cycles):
    """K=1 and K=64 give identical states, including a run stopped by
    max_cycles mid-flight (the overshooting steps are gated off)."""
    cfg, binary, wram, mram = _setup(n_dpus=2, max_cycles=max_cycles)
    pcfg, pbin = config_from(cfg), binary_from(binary)
    k1 = pt_cc.run(pcfg, pbin, wram, mram, 4, device="cpu",
                   steps_per_check=1)
    k64 = pt_cc.run(pcfg, pbin, wram, mram, 4, device="cpu",
                    steps_per_check=64)
    _assert_same(k1, k64, "K=1 vs K=64")
    if max_cycles < 1000:
        assert (k1["status"] != pt_engine.DONE).any()
        assert (k1["cycle"] >= max_cycles).all()
        _, want = _lockstep(cfg, binary, wram, mram, 4, checkpoints=())
        _assert_same(want, k64, "stopped run vs reference")


def test_step_after_termination_changes_nothing():
    cfg, binary, wram, mram = _setup(n_dpus=2, max_cycles=150)
    pcfg, pbin = config_from(cfg), binary_from(binary)
    final = pt_cc.run(pcfg, pbin, wram, mram, 4, device="cpu",
                      steps_per_check=1)
    step = pt_engine.make_step_traced(pcfg, 4, "cpu")
    P = pt_cc.program_bucket(pbin.n_instrs, pbin.opcode.shape[0])
    ir = torch.from_numpy(np.stack([a[:P] for a in pbin.arrays]))
    st = state_to_torch(final, "cpu")
    for _ in range(5):
        st = step(ir, st)
    _assert_same(final, state_to_numpy(st), "gated steps")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg, binary, wram, mram = _setup(n_dpus=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cc.run(config_from(cfg), binary_from(binary), wram, mram, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_engine.run(config_from(cfg), binary_from(binary), wram, mram, 4)

