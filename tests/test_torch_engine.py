"""The port's cycle engine and driver (repro_torch.core.engine and
compile_cache) against the JAX package, bit for bit: every state leaf
after 1, 7 and all steps on the programs of tests/test_engine.py, and
the driver's padding, cache counters and K-steps-per-check gating."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import isa as ref_isa  # noqa: E402
from repro.core.asm import DPU_ID, Program, TID  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro_torch.core import compile_cache as pt_cc  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core.carry import (binary_from, config_from,  # noqa: E402
                                    state_to_numpy, state_to_torch)
from repro_torch.kernels.cycle_step import cases  # noqa: E402

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


def _ref_launch(case):
    """A launch of ``repro_torch.kernels.cycle_step.cases`` (the port's
    config and binary) as the JAX package's: ``(cfg, binary, wram, mram,
    T)``."""
    pcfg, pbin, wram, mram, T = case
    binary = ref_isa.Binary(*[np.array(a) for a in pbin.arrays],
                            pbin.n_instrs, dict(pbin.symbols))
    return DPUConfig(**dataclasses.asdict(pcfg)), binary, wram, mram, T


def _mram_arange(cfg):
    return np.arange(cfg.n_dpus * cfg.mram_words,
                     dtype=np.int32).reshape(cfg.n_dpus, -1)


# ---------------------------------------------------------------------------
# the programs of tests/test_engine.py (:76-268), the case-study branches
# and the widest DPUs (cases.CASES; the cross_dpu launches, 40 DPUs, are
# held against the JAX package at 4 DPUs in tests/test_torch_cycle_step.py)
# ---------------------------------------------------------------------------

CASES = sorted(n for n in cases.CASES if not n.startswith("cross_dpu"))


@pytest.mark.parametrize("name", CASES)
def test_every_leaf_matches_reference(name):
    n, _ = _lockstep(*_ref_launch(cases.launch(name)))
    assert n >= 7


def test_cache_mode_matches_reference():
    """Case study #4: a cache-centric VA (LW/SW through the D$ model)."""
    n, st = _lockstep(*_ref_launch(cases.cache_va()))
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

