"""Card-only tests of the port (marker ``cuda``; each skips without a
CUDA card).  This file imports neither jax nor the JAX package, so it
runs on a machine with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU-side parity against the JAX package is in the other
tests/test_torch_*.py files."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.workloads as pt_wl  # noqa: E402
from repro_torch.core import compile_cache  # noqa: E402
from repro_torch.core.asm import DPU_ID, Program, TID  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.kernels.alu_exec import ops  # noqa: E402
from repro_torch.kernels.alu_exec.ref import alu_exec_ref  # noqa: E402
from repro_torch.kernels.crf_step import cases as crf_cases  # noqa: E402
from repro_torch.kernels.cycle_step import cases as step_cases  # noqa: E402
from repro_torch.kernels.simt_step import cases as simt_cases  # noqa: E402
from repro_torch.workloads import goldens  # noqa: E402

INT_MIN, INT_MAX = -2**31, 2**31 - 1
EDGE = [(9, INT_MIN, -1), (9, 5, 0), (5, 1, 33), (7, -8, 1), (8, 2**30, 2),
        (6, -1, 32), (6, -1, -31), (7, -1, 64), (11, -1, 3), (0, INT_MAX, 1),
        (1, INT_MIN, 1), (8, INT_MIN, -1), (-1, 5, 1), (12, 6, 2), (30, 9, 5)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _random(n, seed):
    rng = np.random.default_rng(seed)
    op = rng.integers(-2, 14, n).astype(np.int32)
    a = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    b[::7] = rng.integers(-40, 40, b[::7].shape)
    return op, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 64, 127, 1 << 20],
                         ids=["edge", "1", "64", "127", "1M"])
def test_alu_kernel_matches_plain_version(card, n):
    case = tuple(np.asarray(c, np.int32) for c in zip(*EDGE)) if n == 0 \
        else _random(n, n)
    t = [torch.from_numpy(x).to(card) for x in case]
    before = ops.launches
    got = ops.alu_exec(*t)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(got, alu_exec_ref(*t))


@pytest.mark.cuda
def test_alu_wrapper_rejects_what_the_kernel_cannot_take(card):
    x = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        ops.alu_exec(x, x.to(torch.int64), x)
    with pytest.raises(ValueError):
        ops.alu_exec(x, x, torch.zeros(16, dtype=torch.int32,
                                       device=card)[::2])
    with pytest.raises(ValueError):
        ops.alu_exec(x, x.cpu(), x)


def _prog(nt=4):
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
        p.mul(v, v, 3)
        p.sw(w, 0, v)
        p.sdma(w, m, 32)
        p.add(m, m, 256)
    p.stop()
    return p


@pytest.mark.cuda
def test_card_driver_matches_cpu(card):
    """The card's driver (the fused cycle-step kernel) gives the CPU's
    state bit for bit: one launch per K-step block, and the one queued
    past the end counted as idle; no ALU launch."""
    from repro_torch.kernels.cycle_step import ops as cs_ops
    cfg = DPUConfig(n_dpus=3, n_tasklets=16, mram_bytes=1 << 14,
                    superscalar=2, forwarding=True, unified_rf=True)
    binary = _prog().binary(cfg.iram_instrs)
    wram = np.zeros((3, 16), np.int32)
    mram = np.arange(3 * cfg.mram_words, dtype=np.int32).reshape(3, -1)
    want = compile_cache.run(cfg, binary, wram, mram, 4, device="cpu")
    steps0, launches0 = compile_cache.stats()["steps"], ops.launches
    fused0, idle0 = cs_ops.launches, cs_ops.idle_launches
    got = compile_cache.run(cfg, binary, wram, mram, 4, device=card)
    for k in want:
        assert want[k].tobytes() == got[k].tobytes(), k
    steps = compile_cache.stats()["steps"] - steps0
    assert ops.launches == launches0
    assert cs_ops.idle_launches - idle0 == 1
    assert (cs_ops.launches - fused0 - 1) * compile_cache.STEPS_PER_CHECK \
        == steps > 0


def _step_case(name):
    from repro_torch.kernels.cycle_step import cases
    return cases.cache_va() if name == "cache_va" else cases.launch(name)


def _step_case_names():
    from repro_torch.kernels.cycle_step import cases
    return sorted(cases.CASES) + ["cache_va"]


STEP_ROUTES = ["resident_smem", "resident", "resident_carry", "stepwise"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", STEP_ROUTES)
@pytest.mark.parametrize("k", [1, 64])
@pytest.mark.parametrize("name", _step_case_names())
def test_cycle_step_matches_eager_card_step(card, name, k, route):
    """Every leaf bitwise after 1, 7 and all steps, ``k`` steps a launch,
    on each route: one launch per K-block (or checkpoint), no ALU launch
    inside them.  The cases' launches take resident_smem by themselves;
    resident_carry, asked for by name at their few DPUs, carries two DPUs
    a warp."""
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import ops as cs_ops
    before = cs_ops.launches
    res = cases.hold_against_plain(_step_case(name), k, device=card,
                                   routes=None if route == "resident_smem"
                                   else (route,))
    assert res["alu_launches"] == 0
    assert res["route"] == route
    assert cs_ops.launches - before == res["launches"]
    assert res["steps"] >= 7
    assert res["launches"] == 1 + -(-6 // k) + -(-(res["steps"] - 7) // k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dpus", [1, 5, 130, "smem", "smem+1"])
def test_cycle_step_dpu_counts_agree(card, n_dpus):
    """cross_dpu at 1 DPU (one block), 5 (padded to 8: a cooperative
    launch of 8 one-DPU blocks on resident_smem) and 130 (padded to 256),
    and, unpadded, at the resident_smem route's limit (396 DPUs on an
    H100: every block of the card resident, three an SM) and one past it
    (the resident route): the DMA-width waits cross blocks."""
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import ops as cs_ops
    from repro_torch.kernels.cycle_step.cycle_step import card_limits
    cfg = cases.launch("cross_dpu", 1)[0]
    limit = cs_ops.smem_dpus(4, cfg.wram_words, card_limits(4),
                             cfg.atomic_bits)
    assert limit >= 64                   # one 64-DPU rank at least
    n = {"smem": limit, "smem+1": limit + 1}.get(n_dpus, n_dpus)
    D = n if isinstance(n_dpus, str) else compile_cache.dpu_bucket(n)
    res = cases.hold_against_plain(cases.launch("cross_dpu", n), 64,
                                   device=card, dpus=D)
    assert res["route"] == ("resident_smem" if D <= limit else "resident")
    assert res["route"] == cs_ops.launch_route(D, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dpus", ["limit+1", 2560])
def test_cycle_step_runs_more_dpus_than_resident(card, n_dpus):
    """Above the resident limit (max_dpus: every block of the cooperative
    launch at once) a launch takes the resident_carry route by itself,
    two DPUs a warp, and is bitwise the eager card step, as is the
    stepwise route asked for by name: cross_dpu at one DPU past the limit
    and at a full 2,560-DPU UPMEM system (both padded to 4,096)."""
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import ops as cs_ops
    from repro_torch.kernels.cycle_step.cycle_step import card_limits
    from repro_torch.kernels.cycle_step.cycle_step import max_dpus
    limit = max_dpus(4)
    assert limit >= 64                   # one 64-DPU rank at least
    assert cs_ops.launch_route(limit, 4) == "resident"
    n = limit + 1 if n_dpus == "limit+1" else n_dpus
    assert n > limit
    for D in (n, compile_cache.dpu_bucket(n)):
        assert cs_ops.launch_route(D, 4) == "resident_carry"
        assert cs_ops.pick_route(D, 4, DPUConfig().wram_words,
                                 card_limits(4)) == "resident_carry"
    assert cs_ops.carry_factor(compile_cache.dpu_bucket(n), 4,
                               card_limits(4)) == 2
    res = cases.hold_against_plain(cases.launch("cross_dpu", n), 64,
                                   device=card,
                                   routes=("resident_carry", "stepwise"))
    assert res["routes"] == ["resident_carry", "stepwise"]
    assert res["alu_launches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [2, 3])
def test_cycle_step_carries_n_dpus_a_warp(card, factor):
    """cross_dpu unpadded at twice the resident limit L (n = 2: every
    resident warp carries two DPUs) and at 2L + 1 (n = 3), on the route
    the picker takes by itself, bitwise the eager card step; the
    picker's model of the carried kernel's blocks an SM is the card's
    occupancy query at each factor's shared memory."""
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import cycle_step as k_step
    from repro_torch.kernels.cycle_step import ops as cs_ops
    lim = k_step.card_limits(4)
    L = k_step.max_dpus(4)
    for n in (2, 3, 4):
        need = cs_ops.carry_bytes(n, 4)
        assert k_step.carry_bytes(n, 4) == need
        assert cs_ops.carry_held(n, 4, lim) == (
            lim.sms * k_step.carry_blocks(need) * k_step.DPUS_PER_BLOCK * n)
    D = 2 * L + (factor == 3)
    assert cs_ops.launch_route(D, 4) == "resident_carry"
    assert cs_ops.carry_factor(D, 4, lim) == factor
    res = cases.hold_against_plain(cases.launch("cross_dpu", D), 64,
                                   device=card, dpus=D)
    assert res["route"] == "resident_carry"


@pytest.mark.cuda
def test_cycle_step_wrapper_rejects_what_the_kernel_cannot_take(card):
    from repro_torch.core import engine
    from repro_torch.core.carry import state_to_torch
    from repro_torch.kernels.cycle_step import cases
    from repro_torch.kernels.cycle_step import ops as cs_ops
    from repro_torch.kernels.cycle_step.cycle_step import card_limits
    cfg, binary, wram, mram, T = cases.launch("frfcfs")
    st0 = engine.make_state_np(cfg, binary, wram, mram, T)
    P = compile_cache.program_bucket(binary.n_instrs, binary.opcode.shape[0])
    ir = torch.from_numpy(np.stack([a[:P] for a in binary.arrays])).to(card)
    before = cs_ops.launches

    def bad(**leaves):
        st = state_to_torch(st0, card)
        st.update(leaves)
        return st

    st = state_to_torch(st0, card)
    with pytest.raises(TypeError):
        cs_ops.cycle_step(cfg, bad(pc=st["pc"].long()), ir, 4)
    with pytest.raises(TypeError):
        cs_ops.cycle_step(cfg, bad(req_valid=st["req_valid"].int()), ir, 4)
    with pytest.raises(ValueError):
        cs_ops.cycle_step(cfg, bad(regs=st["regs"][:, :, :20].contiguous()),
                          ir, 4)
    with pytest.raises(ValueError):
        cs_ops.cycle_step(cfg, bad(pc=torch.zeros((1, 2 * T), dtype=torch
                                                  .int32, device=card)[:, ::2]),
                          ir, 4)
    with pytest.raises(ValueError):
        cs_ops.cycle_step(cfg, bad(wram=st["wram"].cpu()), ir, 4)
    with pytest.raises(ValueError):
        cs_ops.cycle_step(cfg, st, ir.long(), 4)
    with pytest.raises(ValueError):
        cs_ops.cycle_step(cfg.replace(n_tasklets=33), bad(
            **state_to_torch(engine.make_state_np(
                cfg, binary, wram, mram, 33), card)), ir, 4)
    with pytest.raises(ValueError, match="no route"):
        cs_ops.CycleStep(cfg, state_to_torch(st0, card), ir, route="fast")
    # resident_smem asked for past what the card holds at once: the
    # cooperative launch is refused, and that raises
    held = cs_ops.smem_dpus(T, cfg.wram_words, card_limits(T),
                            cfg.atomic_bits)
    n = held + 1
    big = engine.make_state_np(cfg.replace(n_dpus=n), binary,
                               np.repeat(wram[:1], n, 0),
                               np.repeat(mram[:1], n, 0), T)
    kern = cs_ops.CycleStep(cfg.replace(n_dpus=n), state_to_torch(big, card),
                            ir, route="resident_smem")
    with pytest.raises(RuntimeError, match="resident_smem"):
        kern.launch(4)
    assert cs_ops.launches == before
    assert cs_ops.cycle_step(cfg, state_to_torch(st0, card), ir, 4)
    assert cs_ops.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 24, 32])
def test_route_picker_mirrors_the_card(card, T):
    """The kernels' own shared-memory counts equal the pickers' mirror
    (at 64 KiB of WRAM and at the cache study's 8 MiB, whose rows fit in
    no block), and what the drivers run is the pure picker over the
    card's limits at every boundary."""
    from repro_torch.kernels.cycle_step import cycle_step as k_step
    from repro_torch.kernels.cycle_step import ops as cs_ops
    from repro_torch.kernels.simt_step import ops as simt_ops
    from repro_torch.kernels.simt_step import simt_step as k_simt
    from repro_torch.kernels.step_driver import smem_dpus_of
    lim, slim = k_step.card_limits(T), k_simt.card_limits()
    assert lim.resident_dpus == k_step.max_dpus(T)
    for W in (16384, 2 * 1024 * 1024):
        assert k_step.LIB.smem_bytes(T, W, 256) == cs_ops.smem_bytes(T, W)
        assert k_simt.LIB.smem_bytes(T, W, 256) \
            == simt_ops.smem_bytes(T, W)
        held = cs_ops.smem_dpus(T, W, lim)
        sheld = smem_dpus_of(simt_ops.smem_bytes(T, W), slim)
        assert (held > 0) == (sheld > 0) == (W == 16384)
        for D in (1, held, held + 1, lim.resident_dpus,
                  lim.resident_dpus + 1, 2 * lim.resident_dpus,
                  2 * lim.resident_dpus + 1):
            assert cs_ops.launch_route(D, T, W) \
                == cs_ops.pick_route(D, T, W, lim)
            assert simt_ops.launch_route(D, T, W) \
                == simt_ops.pick_route(D, T, W, slim)


def _run_with_checks(card, name, k):
    """``name`` on 8 DPUs through the driver with a predicate check every
    ``k`` steps: (the final states of its launches, its KernelReport, its
    Timeline, cycle_step's counted launches, of those the ones queued past
    a run's end, the driver's steps, the routes the kernel launched on)."""
    from repro_torch.core.host import PIMSystem
    from repro_torch.kernels.cycle_step import ops as cs_ops
    cfg = DPUConfig(n_dpus=8, n_tasklets=16, mram_bytes=1 << 16)
    states, routes = [], set()
    run, launch = compile_cache.run, cs_ops.LIB.launch

    def checked_run(*a, **kw):
        states.append(run(*a, **dict(kw, steps_per_check=k)))
        return states[-1]

    def recorded_launch(route, *a, **kw):
        routes.add(route)
        return launch(route, *a, **kw)

    compile_cache.run, cs_ops.LIB.launch = checked_run, recorded_launch
    try:
        l0, i0 = cs_ops.launches, cs_ops.idle_launches
        s0 = compile_cache.stats()["steps"]
        system = PIMSystem(cfg, device=card)
        _, rep = pt_wl.get(name).run(system, 16, scale=0.01, seed=0)
        return (states, rep, system.timeline, cs_ops.launches - l0,
                cs_ops.idle_launches - i0,
                compile_cache.stats()["steps"] - s0, routes)
    finally:
        compile_cache.run = run
        del cs_ops.LIB.launch           # the class's method again


@pytest.mark.cuda
@pytest.mark.parametrize("route", STEP_ROUTES)
@pytest.mark.parametrize("name", ["VA", "HST-L"])
def test_pipelined_loop_changes_no_count(card, name, route, monkeypatch):
    """The next K-block queued before the flag is read, on each route (the
    drivers' picker made to answer it): the launch queued past the end
    changes nothing and is counted apart as idle.  Two runs at K = 64 and
    one with a check every step give the same states, KernelReport and
    Timeline as a run with a check every step; each counts one launch per
    K steps and one idle launch per driver launch."""
    from repro_torch.kernels.cycle_step import ops as cs_ops
    monkeypatch.setattr(cs_ops, "launch_route", lambda *a: route)
    want = _run_with_checks(card, name, 1)
    for k in (64, 64, 1):
        states, rep, tl, launches, idle, steps, routes = \
            _run_with_checks(card, name, k)
        assert routes == {route}
        assert idle == len(states) > 0
        assert (launches - idle) * k == steps > 0
        for f in dataclasses.fields(rep):
            assert np.array_equal(getattr(rep, f.name),
                                  getattr(want[1], f.name)), f.name
        assert (tl.total, tl.kernel, tl.elapsed) == (
            want[2].total, want[2].kernel, want[2].elapsed)
        assert len(states) == len(want[0])
        for got, ref in zip(states, want[0]):
            for leaf in ref:
                assert got[leaf].tobytes() == ref[leaf].tobytes(), leaf


# ---------------------------------------------------------------------------
# LM kernels: flash attention and the SSD scan
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's flash cases (S, H, KV, Dk, Dv, causal, window)
FLASH_CASES = [(128, 4, 4, 32, 32, True, 0), (128, 8, 2, 16, 16, True, 0),
               (256, 4, 1, 32, 64, True, 0), (128, 4, 4, 32, 32, False, 0),
               (256, 4, 2, 32, 32, True, 64), (100, 4, 2, 32, 32, True, 0)]
#: shapes that stress the tensor-core kernel's tiling (bf16): S ragged to
#: its 128-row tiles, Dk 192 / Dv 128, Dk = Dv = 256, a window across
#: tiles, bidirectional, GQA with H / KV = 8
SM90_CASES = [(1000, 4, 2, 128, 128, True, 0), (256, 4, 2, 192, 128, True, 0),
              (256, 4, 2, 256, 256, True, 0), (1024, 4, 2, 128, 128, True, 300),
              (512, 4, 2, 128, 128, False, 0), (512, 16, 2, 128, 128, True, 0)]


def _normal(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=device, dtype=dtype)


def _check_flash(card, s, h, kv, dk, dv, causal, window, dtype, tol, sm90):
    """The wrapper's output against the plain version, one counted launch,
    on the tensor-core kernel iff ``sm90``; the CPU path launches none."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(s + h + dk)
    q, k, v = (_normal(rng, (2, s, n, d), dtype, card)
               for n, d in ((h, dk), (kv, dk), (kv, dv)))
    before = fops.launches, fops.launches_sm90
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fops.launches, fops.launches_sm90) == (before[0] + 1,
                                                   before[1] + int(sm90))
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    fops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                         window=window)
    assert fops.launches == before[0] + 1  # the CPU path launches nothing


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h,kv,dk,dv,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain_version(card, s, h, kv, dk, dv, causal,
                                            window, dtype, tol):
    """float32 runs on the scalar kernel, bf16 on the tensor-core one."""
    _check_flash(card, s, h, kv, dk, dv, causal, window, dtype, tol,
                 sm90=dtype == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kv,dk,dv,causal,window", SM90_CASES)
def test_flash_sm90_tiling_matches_plain_version(card, s, h, kv, dk, dv,
                                                 causal, window):
    _check_flash(card, s, h, kv, dk, dv, causal, window, torch.bfloat16,
                 1e-2, sm90=True)


@pytest.mark.cuda
def test_flash_bf16_width_sm90_cannot_take_runs_scalar(card):
    """Dk 24 is no multiple of 16: the rule sends bf16 to the scalar
    kernel, which agrees with the plain version."""
    _check_flash(card, 128, 4, 2, 24, 24, True, 0, torch.bfloat16, 1e-2,
                 sm90=False)


@pytest.mark.cuda
def test_flash_sm90_refuses_misaligned_data(card):
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.bfloat16,
                    device=card)[1:].view(2, 64, 2, 64)
    k = torch.zeros((2, 64, 2, 64), dtype=torch.bfloat16, device=card)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = fops.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fops.flash_attention(q, k, k)
    assert fops.launches == before


def _ssd_inputs(rng, b, s, h, g, p, n, dtype, device):
    x = _normal(rng, (b, s, h, p), dtype, device)
    dt = torch.nn.functional.softplus(_normal(rng, (b, s, h), torch.float32,
                                              device))
    A = -torch.exp(_normal(rng, (h,), torch.float32, device))
    Bm = _normal(rng, (b, s, g, n), dtype, device)
    Cm = _normal(rng, (b, s, g, n), dtype, device)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (1, 64, 3, 3, 8, 8, 16), (1, 128, 3, 3, 16, 8, 32),
    (1, 128, 3, 3, 32, 16, 64), (1, 96, 3, 3, 8, 8, 96),   # test_kernels.py
    (2, 64, 4, 2, 8, 8, 16), (2, 50, 4, 2, 8, 8, 16),       # groups, ragged
    (1, 512, 2, 1, 64, 128, 256),                           # mamba2 widths
])
def test_ssd_kernel_matches_plain_version(card, b, s, h, g, p, n, chunk):
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    rng = np.random.default_rng(s + h + n)
    args = _ssd_inputs(rng, b, s, h, g, p, n, torch.float32, card)
    before, before_tc = sops.launches, sops.launches_tc
    y, state = sops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sops.launches == before + 1
    assert sops.launches_tc == before_tc   # float32: the scalar kernel
    yw, sw = ssd_scan_ref(*args, chunk=chunk)
    torch.testing.assert_close(y, yw, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, sw, rtol=2e-4, atol=2e-4)
    sops.ssd_scan(*(t.cpu() for t in args), chunk=chunk)
    assert sops.launches == before + 1  # the CPU path launches nothing


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (1, 256, 4, 2, 16, 16, 64),       # Q 64, P 16, N 16, G = H / 2
    (2, 300, 4, 1, 64, 64, 128),      # Q 128, ragged last chunk
    (1, 512, 4, 2, 128, 128, 256),    # Q 256, the widest P and N
    (2, 1000, 6, 3, 64, 128, 256),    # ragged, G = H / 2
    (1, 100, 2, 1, 64, 128, 256),     # S shorter than the chunk
    (2, 200, 4, 2, 128, 16, 64),      # P 128 beside N 16
    (1, 192, 3, 3, 32, 32, 64),       # G = H, N = P = 32
])
def test_ssd_tensor_core_route_matches_plain_version(card, b, s, h, g, p, n,
                                                     chunk):
    """bf16 with N, P multiples of 16 and a multiple-of-64 chunk goes to
    the tensor-core route: y and the final state within 1e-2 (rtol =
    atol) of the plain version, counted in launches and launches_tc."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    assert sops.route(torch.bfloat16, n, p, chunk) == "tc"
    rng = np.random.default_rng(s + h + n + p)
    args = _ssd_inputs(rng, b, s, h, g, p, n, torch.bfloat16, card)
    before, before_tc = sops.launches, sops.launches_tc
    y, state = sops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (sops.launches, sops.launches_tc) == (before + 1, before_tc + 1)
    yw, sw = ssd_scan_ref(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), yw.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(state, sw, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m"])
def test_lm_prefill_on_card_matches_cpu(card, arch):
    """A smoke-size model in float32: prefill logits and cache on the card
    (kernels) equal the CPU's (plain versions), one launch per layer."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models.transformer import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).replace(dtype="float32")
    cpu = Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = Transformer(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    counter = fops if cfg.family == "dense" else sops
    before = counter.launches
    lg, cg = gpu.prefill({"tokens": toks.to(card)})
    torch.cuda.synchronize()
    assert counter.launches == before + cfg.n_layers
    lc, cc = cpu.prefill({"tokens": toks})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    for key in cc:
        if key != "pos":
            torch.testing.assert_close(cg[key].cpu(), cc[key], rtol=1e-3,
                                       atol=1e-3)


# ---- every workload against the JAX package's goldens ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(pt_wl.ALL))
def test_workload_matches_golden_on_card(card, name):
    from repro_torch.core.host import PIMSystem
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.workloads import goldens
    before = step_ops.launches
    rep, system, st = goldens.run_config(pt_wl, DPUConfig, PIMSystem, "g4",
                                         name, device="cuda")
    assert step_ops.launches > before, "the run launched no cycle_step"
    got = goldens.entry(rep, system, st)
    assert goldens.differences(goldens.load()["entries"]["g4"][name],
                               got) == []


@pytest.mark.cuda
def test_remap_scenario_matches_golden_on_card(card):
    from repro_torch.core.host import PIMSystem
    from repro_torch.faults import FaultPlan, kill_dpu
    from repro_torch.workloads import goldens
    rep, system, st = goldens.run_remap(pt_wl, DPUConfig, PIMSystem,
                                        FaultPlan, kill_dpu, device="cuda")
    got = goldens.remap_entry(rep, system, st)
    assert goldens.differences(goldens.load()["remap"], got) == []
    assert not system.active_mask[goldens.REMAP[2][0]]


# ---------------------------------------------------------------------------
# the SIMT and CRF step kernels: bitwise against their plain versions (the
# eager card steps) on every case, and the SIMT / HBM-PIM goldens
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident_smem", "global"])
@pytest.mark.parametrize("name", sorted(simt_cases.CASES))
def test_simt_step_matches_plain_version(card, name, route):
    res = step_cases.hold_against_plain(simt_cases.launch(name), 64,
                                        device="cuda",
                                        routes=None if route == "resident_smem"
                                        else (route,))
    assert res["kernel"] == "SimtStep" and res["alu_launches"] == 0
    assert res["route"] == route
    assert res["launches"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident_smem", "global"])
@pytest.mark.parametrize("name", sorted(crf_cases.CASES))
def test_crf_step_matches_plain_version(card, name, route):
    """Every leaf bitwise after 1, 7 and all commands on each route (the
    cases take resident_smem by themselves); resident_smem is one counted
    launch a K-block."""
    from repro_torch.kernels.crf_step import ops as crf_ops
    before = crf_ops.launches
    res = step_cases.hold_against_plain(crf_cases.launch(name), 4,
                                        device="cuda",
                                        edit=crf_cases.edit_of(name),
                                        routes=None if route == "resident_smem"
                                        else (route,))
    assert res["kernel"] == "CrfStep" and res["launches"] >= 2
    assert res["route"] == route
    assert crf_ops.launches - before == res["launches"]


@pytest.mark.cuda
def test_crf_route_picker_mirrors_the_card(card):
    """The CRF kernel's own shared-memory count equals the picker's
    mirror, and the route a launch takes is the pure picker over the
    card's limits."""
    from repro_torch.kernels.crf_step import crf_step as k_crf
    from repro_torch.kernels.crf_step import ops as crf_ops
    lim = k_crf.card_limits()
    for P, rows, W in ((64, 3, 16), (1024, 1134, 16), (2048, 5000, 32)):
        assert k_crf.LIB.smem_bytes(P, rows, W) == k_crf.smem_bytes(P, rows,
                                                                    W)
        held = crf_ops.smem_banks(P, rows, W, lim)
        for D in (1, 64, held, held + 1):
            assert crf_ops.launch_route(D, P, rows, W) \
                == crf_ops.pick_route(D, P, rows, W, lim)
    assert crf_ops.smem_banks(1024, 1134, 16, lim) >= 64


@pytest.mark.cuda
@pytest.mark.parametrize("key", goldens.SIMT_KEYS)
def test_simt_and_hbmpim_goldens_on_card(card, key):
    """Every workload of the SIMT and HBM-PIM configurations equals its
    JAX-made golden (a capped run raises the same error from the same
    capped state), through the configuration's kernel."""
    from repro_torch.core.host import PIMSystem
    from repro_torch.kernels.crf_step import ops as crf_ops
    from repro_torch.kernels.cycle_step import ops as step_ops
    from repro_torch.kernels.simt_step import ops as simt_ops
    kernels = {"crf_step": crf_ops, "simt_step": simt_ops,
               "cycle_step": step_ops}
    gold = goldens.load()["entries"][key]
    for name in goldens.workloads_of(key, pt_wl.ALL):
        mod = kernels[goldens.kernel_of(key, name)]
        before = mod.launches
        got = goldens.run_entry(pt_wl, DPUConfig, PIMSystem, compile_cache,
                                key, name, device="cuda")
        assert goldens.differences(gold[name], got) == [], name
        assert mod.launches > before, name
