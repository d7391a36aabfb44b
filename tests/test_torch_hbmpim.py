"""The port's HBM-PIM all-bank targets (repro_torch.core.hbmpim) against
the JAX package on the CPU: the nine scenarios of tests/test_hbmpim.py,
each with identical final state and KernelReport (and Timeline where a
system is charged), the CRF program builder's images, and the command
step's gating."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.core import backend as ref_backends  # noqa: E402
from repro.core import hbmpim as R  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro_torch.core import backend as pt_backends  # noqa: E402
from repro_torch.core import compile_cache, engine  # noqa: E402
from repro_torch.core import hbmpim as P  # noqa: E402
from repro_torch.core.carry import (config_from, state_to_numpy,  # noqa: E402
                                    state_to_torch)
from repro_torch.core.host import PIMSystem as PtSystem  # noqa: E402
from test_torch_workloads import (_assert_report, _assert_state,  # noqa: E402
                                  _assert_timeline)


def _cfg(**kw):
    return DPUConfig(n_dpus=4, n_ranks=2, n_channels=2, **kw)


def _bank_image(cfg, rows):
    D, n, W = rows.shape
    img = np.zeros((D, cfg.mram_words), np.int32)
    img[:, :n * W] = rows.reshape(D, -1)
    return img


def _both(build, cfg, mram, srf0=None):
    """Run the program ``build(module)`` (built with either package's
    CrfProgram and operand encoders) through each package's
    launch_commands on a fresh system of ``cfg``; assert identical state,
    report and Timeline; return the port's (state, report, system)."""
    ref_sys = RefSystem(cfg)
    ref_st, ref_rep = R.launch_commands(ref_sys, "k", build(R), mram, srf0)
    pt_sys = PtSystem(config_from(cfg), device="cpu")
    pt_st, pt_rep = P.launch_commands(pt_sys, "k", build(P), mram, srf0)
    _assert_state({k: np.asarray(v) for k, v in ref_st.items()}, pt_st)
    _assert_report(ref_rep, pt_rep)
    _assert_timeline(ref_sys.timeline, pt_sys.timeline)
    return pt_st, pt_rep, pt_sys


@pytest.fixture
def rng4():
    return np.random.default_rng(7)


def test_mov_fill_roundtrip(rng4):
    cfg = _cfg()
    W = cfg.hbm_lanes
    rows = rng4.integers(-100, 100, (4, 2, W), dtype=np.int32)

    def build(m):
        p = m.CrfProgram()
        p.fill(m.grf_a(3), m.bank(0))
        p.mov(m.bank(5), m.grf_a(3))
        p.exit_()
        return p

    st, _, _ = _both(build, cfg, _bank_image(cfg, rows))
    assert np.array_equal(st["mram"][:, 5 * W:6 * W], rows[:, 0])
    assert np.array_equal(st["grf_a"][:, 3], rows[:, 0])


def test_add_mul_mac_vs_numpy(rng4):
    cfg = _cfg()
    W = cfg.hbm_lanes
    rows = rng4.integers(-50, 50, (4, 3, W), dtype=np.int32)
    srf0 = rng4.integers(-50, 50, (4, 8), dtype=np.int32)

    def build(m):
        p = m.CrfProgram()
        p.add(m.grf_a(0), m.bank(0), m.bank(1))
        p.mul(m.grf_b(0), m.bank(0), m.srf(2))
        p.fill(m.grf_b(1), m.bank(2))
        p.mac(m.grf_b(1), m.bank(0), m.srf(5))
        p.mov(m.bank(7), m.grf_a(0))
        p.mov(m.bank(8), m.grf_b(0))
        p.mov(m.bank(9), m.grf_b(1))
        p.exit_()
        return p

    st, rep, _ = _both(build, cfg, _bank_image(cfg, rows), srf0)
    assert np.array_equal(st["mram"][:, 9 * W:10 * W],
                          rows[:, 2] + rows[:, 0] * srf0[:, 5:6])
    assert rep.issued == 4 * (7 * W + 1)


def test_jump_loop_trip_count(rng4):
    cfg = _cfg()
    W = cfg.hbm_lanes
    srf0 = rng4.integers(1, 9, (4, 8), dtype=np.int32)

    def build(m):
        p = m.CrfProgram()
        body = p.here()
        p.add(m.grf_a(0), m.grf_a(0), m.srf(0))
        p.jump(body, 4)
        p.mov(m.bank(0), m.grf_a(0))
        p.exit_()
        return p

    st, _, _ = _both(build, cfg, np.zeros((4, cfg.mram_words), np.int32),
                     srf0)
    assert np.array_equal(st["mram"][:, :W],
                          np.broadcast_to(5 * srf0[:, :1], (4, W)))


def test_crf_capacity_enforced():
    cfg = _cfg(hbm_crf_slots=4)
    for m, system in ((R, RefSystem(cfg)),
                      (P, PtSystem(config_from(cfg), device="cpu"))):
        p = m.CrfProgram()
        for _ in range(8):
            p.nop()
        p.exit_()
        with pytest.raises(AssertionError, match="hbm_crf_slots"):
            m.launch_commands(system, "big", p,
                              np.zeros((4, cfg.mram_words), np.int32))


def test_open_row_hit_miss_counters(rng4):
    cfg = _cfg()
    rows = rng4.integers(-5, 5, (4, 2, cfg.hbm_lanes), dtype=np.int32)

    def build(m):
        p = m.CrfProgram()
        p.fill(m.grf_a(0), m.bank(0))
        p.fill(m.grf_a(1), m.bank(0))
        p.fill(m.grf_a(2), m.bank(1))
        p.exit_()
        return p

    _, rep, _ = _both(build, cfg, _bank_image(cfg, rows))
    assert rep.row_hit == 4 * 1 and rep.row_miss == 4 * 2


def test_launch_charges_timeline_and_report():
    cfg = _cfg()

    def build(m):
        p = m.CrfProgram()
        p.fill(m.grf_a(0), m.bank(0))
        p.exit_()
        return p

    _, rep, system = _both(build, cfg,
                           np.zeros((4, cfg.mram_words), np.int32))
    assert system.timeline.kernel == rep.kernel_seconds > 0.0
    assert system.reports[-1] is rep
    assert rep.name == "k" and rep.n_dpus == 4


def _same_workload(name, cfg, threads, scale, seed):
    ref_sys = RefSystem(cfg)
    ref_st, ref_rep = ref_wl.get(name).run(ref_sys, threads, scale=scale,
                                           seed=seed)
    pt_sys = PtSystem(config_from(cfg), device="cpu")
    pt_st, pt_rep = pt_wl.get(name).run(pt_sys, threads, scale=scale,
                                        seed=seed)
    _assert_report(ref_rep, pt_rep)
    _assert_timeline(ref_sys.timeline, pt_sys.timeline)
    _assert_state(ref_st, pt_st)
    return pt_st, pt_rep


@pytest.mark.parametrize("wl_name", ["BFS", "GEMVS"])
def test_workloads_run_unmodified_allbank(wl_name):
    """(SSORT, the slowest on the CPU, is in test_torch_hbmpim_ssort.py.)"""
    _, rep = _same_workload(wl_name, _cfg(backend="hbmpim"), 8, 0.02, 0)
    assert rep.cycles > 0


def test_gemvs_native_cmd_path_matches_mimd_math():
    st, rep = _same_workload("GEMVS", _cfg(backend="hbmpim_cmd"), 8, 0.05, 3)
    assert rep.name == "GEMVS" and "loop_left" in st


def test_allbank_compat_collapses_simt_width_in_cache_key():
    be, rbe = pt_backends.get("hbmpim"), ref_backends.get("hbmpim")
    for kw in ({}, {"simt_width": 4}, {"simt_width": 8, "coalescing": False}):
        cfg = _cfg(backend="hbmpim", **kw)
        assert be.static_key(config_from(cfg)) == \
            be.static_key(config_from(_cfg(backend="hbmpim"))) \
            == rbe.static_key(cfg)


def test_crf_program_images_equal_reference():
    for cap in (4, 64):
        progs = []
        for m in (R, P):
            p = m.CrfProgram()
            body = p.here()
            p.mac(m.bank(3), m.grf_b(2), m.srf(9))
            p.jump(body, 3)
            p.exit_()
            progs.append(p.binary(cap))
        for a, b in zip(progs[0].arrays, progs[1].arrays):
            assert np.array_equal(a, b)
        assert progs[0].n_instrs == progs[1].n_instrs == 3
    assert [int(x) for x in R.CmdOp] == [int(x) for x in P.CmdOp]
    assert (P.bank(1 << 25), P.grf_a(9), P.srf(-1)) == \
        (R.bank(1 << 25), R.grf_a(9), R.srf(-1))


def test_cmd_step_after_termination_changes_nothing():
    cfg = config_from(_cfg(backend="hbmpim_cmd", max_cycles=150))
    p = P.CrfProgram()
    body = p.here()
    p.mac(P.bank(2), P.bank(1), P.srf(0))
    p.jump(body, 50)
    p.exit_()
    binary = p.binary(cfg.hbm_crf_slots)
    srf0 = np.ones((4, 8), np.int32)
    mram = np.arange(4 * cfg.mram_words, dtype=np.int32).reshape(4, -1)
    final = compile_cache.run(cfg, binary, srf0, mram, 1,
                              backend="hbmpim_cmd", device="cpu",
                              steps_per_check=1)
    assert (final["status"] != engine.DONE).all()   # stopped by the cap
    step = P.make_cmd_step(cfg, "cpu")
    P_ = compile_cache.program_bucket(binary.n_instrs, binary.opcode.shape[0])
    ir = torch.from_numpy(np.stack([a[:P_] for a in binary.arrays]))
    st = state_to_torch(final, "cpu")
    for _ in range(5):
        st = step(ir, st)
    out = state_to_numpy(st)
    for k in final:
        assert final[k].tobytes() == out[k].tobytes(), k
    k64 = compile_cache.run(cfg, binary, srf0, mram, 1, backend="hbmpim_cmd",
                            device="cpu")
    for k in final:
        assert final[k].tobytes() == k64[k].tobytes(), k


def test_cmd_backend_masks_padding_and_reports():
    """A 3-bank launch runs in a bucket of 4: the padded bank is DONE and
    never issues; the report equals the JAX package's."""
    cfg = DPUConfig(n_dpus=3, backend="hbmpim_cmd")
    rows = np.random.default_rng(1).integers(-9, 9, (3, 2, 16),
                                             dtype=np.int32)

    def build(m):
        p = m.CrfProgram()
        p.add(m.bank(4), m.bank(0), m.bank(1))
        p.exit_()
        return p

    st, rep, _ = _both(build, cfg, _bank_image(cfg, rows))
    assert dataclasses.asdict(rep)["n_dpus"] == 3
    assert st["c_active"].shape == (3,)
