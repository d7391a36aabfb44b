"""The port's SIMT engine (repro_torch.core.simt, the "simt" backend)
against the JAX package on the CPU: VA at tests/test_backend.py's golden,
SEL under divergence, with and without the coalescer; colliding stores and
DMA windows over the last words resolved as the reference resolves them;
the step's gating; the backend's checks; and Fig. 11's GEMV designs on a
max_cycles prefix of their launch (a whole run costs ~15 s a design on
the CPU; whole on the card against goldens.json)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.core import backend as ref_backends  # noqa: E402
from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core import simt as ref_simt  # noqa: E402
from repro.core.asm import TID, ZERO, Program  # noqa: E402
from repro.core.config import DPUConfig  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro_torch.core import backend, compile_cache, engine, simt  # noqa: E402
from repro_torch.core.carry import (binary_from, config_from,  # noqa: E402
                                    state_to_numpy, state_to_torch)
from repro_torch.workloads import goldens  # noqa: E402
from test_torch_workloads import _assert_state, _same_run  # noqa: E402

#: tests/test_backend.py GOLDENS["VA-simt"]
GOLDEN_VA_SIMT = (2133, 11488, 3.216378378378378e-05, 6.094285714285714e-06)


def _g4(**kw):
    return DPUConfig(n_dpus=4, n_ranks=2, n_channels=2, **kw)


def test_simt_backend_is_registered_and_validates():
    be, rbe = backend.get("simt"), ref_backends.get("simt")
    assert be.name == "simt"
    assert backend.names() == ref_backends.names()
    for cfg in (_g4(), _g4(simt_width=3)):     # width 0; 8 % 3 != 0
        for b in (be, rbe):
            with pytest.raises(AssertionError):
                b.validate(cfg, None, 8)


def test_va_simt_golden_on_cpu():
    system = _same_run("VA", _g4(simt_width=4), 8, scale=0.02)
    rep = system.reports[-1]
    assert (rep.cycles, rep.issued, system.timeline.total,
            system.timeline.kernel) == GOLDEN_VA_SIMT


@pytest.mark.parametrize("kw", [dict(simt_width=4),
                                dict(simt_width=8, coalescing=True)],
                         ids=["simt4", "simt8_ac"])
def test_sel_under_divergence_matches_reference(kw):
    """SEL's predicate splits each warp's lanes every element."""
    cfg = DPUConfig(n_dpus=2, n_ranks=1, n_channels=1, n_tasklets=8,
                    mram_bytes=1 << 16, **kw)
    _same_run("SEL", cfg, 8, scale=0.006, seed=1)


def _run_both(cfg, prog, T, mram=None):
    binary = prog.binary(cfg.iram_instrs)
    wram = np.zeros((cfg.n_dpus, 16), np.int32)
    if mram is None:
        mram = np.arange(cfg.n_dpus * cfg.mram_words,
                         dtype=np.int32).reshape(cfg.n_dpus, -1)
    want = ref_simt.run(cfg, binary, wram, mram, T)
    got = simt.run(config_from(cfg), binary_from(binary), wram, mram, T,
                   device="cpu")
    _assert_state({k: np.asarray(v) for k, v in want.items()}, got)
    return got


def test_colliding_stores_last_lane_wins():
    """Eight lanes of one warp store eight values to one word, and lanes
    in pairs to four others, in one cycle: each word holds the highest
    lane's value, in both packages."""
    p = Program("swc", 8)
    buf = p.walloc("buf", 64)
    v, t, addr = p.regs("v", "t", "addr")
    p.add(v, TID, 100)
    p.sw(ZERO, buf, v)
    p.srl(t, TID, 1)
    p.sll(addr, t, 2)
    p.add(addr, addr, buf + 4)
    p.sw(addr, 0, v)
    p.stop()
    got = _run_both(DPUConfig(n_tasklets=8, simt_width=8,
                              mram_bytes=1 << 14), p, 8)
    w = got["wram"][0, buf // 4:buf // 4 + 5]
    assert list(w) == [107, 101, 103, 105, 107]


def test_dma_over_the_last_mram_word():
    """Four lanes SDMA 10-word windows that start 6, 4, 2 and 0 words
    before the end of MRAM: the windows overlap and are clipped onto the
    last word, which keeps the highest covering lane's last word; the
    rest as the reference writes it."""
    M = (1 << 14) // 4
    p = Program("tail", 4)
    src = p.walloc("src", 4 * 64)
    w, m, t = p.regs("w", "m", "t")
    p.mul(t, TID, 8)
    p.li(m, 4 * (M - 6))
    p.add(m, m, t)
    p.mul(w, TID, 64)
    p.add(w, w, src)
    p.sw(w, 0, TID)
    p.add(t, TID, 50)
    p.sw(w, 36, t)
    p.sdma(w, m, 40)
    p.stop()
    got = _run_both(DPUConfig(n_tasklets=4, simt_width=4,
                              mram_bytes=1 << 14), p, 4)
    mram = got["mram"][0]
    # lane 3's window starts at word M: its k = 9 word lands on M - 1
    assert mram[-1] == 53
    assert list(mram[M - 6:M - 4]) == [0, 0]          # lane 0's first words
    assert mram[M - 4] == 1 and mram[M - 2] == 2      # lanes 1, 2 overwrite


def test_simt_step_after_termination_changes_nothing():
    cfg = config_from(_g4(n_tasklets=8, simt_width=4, mram_bytes=1 << 14,
                          max_cycles=300))
    from repro_torch.kernels.simt_step import cases
    binary = cases._frfcfs_prog(8).binary(cfg.iram_instrs)
    wram = np.zeros((4, 16), np.int32)
    mram = np.arange(4 * cfg.mram_words, dtype=np.int32).reshape(4, -1)
    final = compile_cache.run(cfg, binary, wram, mram, 8, device="cpu",
                              steps_per_check=1)
    assert (final["cycle"] >= 300).all()
    step = simt.make_step_traced(cfg, 8, "cpu")
    P = compile_cache.program_bucket(binary.n_instrs, binary.opcode.shape[0])
    ir = torch.from_numpy(np.stack([a[:P] for a in binary.arrays]))
    st = state_to_torch(final, "cpu")
    for _ in range(5):
        st = step(ir, st)
    out = state_to_numpy(st)
    for k in final:
        assert final[k].tobytes() == out[k].tobytes(), k
    k64 = compile_cache.run(cfg, binary, wram, mram, 8, device="cpu")
    for k in final:
        assert final[k].tobytes() == k64[k].tobytes(), k


def test_simt_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = config_from(_g4(simt_width=4))
    binary = pt_wl.get("VA").build(8).binary(cfg.iram_instrs)
    wram = np.zeros((4, 4), np.int32)
    mram = np.zeros((4, 16), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simt.run(cfg, binary, wram, mram, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simt.make_step_traced(cfg, 8)


# ---------------------------------------------------------------------------
# Fig. 11: GEMV, one DPU x 16 tasklets, scale 0.05, each design
# ---------------------------------------------------------------------------

#: the simulated cycles of the prefix each design runs on the CPU
FIG11_PREFIX = 2500


class _Recorded(Exception):
    """Stops a workload once its launch's inputs are recorded."""


@pytest.mark.parametrize("design", list(goldens.FIG11))
def test_fig11_design_prefix_matches_reference(design):
    """GEMV's launch (its args and MRAM image, as the JAX package's
    workload hands them to the driver) through each package's driver,
    stopped by max_cycles: identical state at the cap."""
    fields, T, scale, seed = goldens.CONFIGS[f"fig11/{design}"]
    calls = []
    run = ref_cc.run

    def recording_run(*a, **kw):
        calls.append((a, kw))
        raise _Recorded                # the launch's inputs are enough

    ref_cc.run = recording_run
    try:
        with pytest.raises(_Recorded):
            ref_wl.get("GEMV").run(RefSystem(DPUConfig(**fields)), T,
                                   scale=scale, seed=seed)
    finally:
        ref_cc.run = run
    (cfg, binary, wram, mram), kw = calls[0][0][:4], calls[0][1]
    cfg = cfg.replace(max_cycles=FIG11_PREFIX)
    want = ref_cc.run(cfg, binary, wram, mram, **kw)
    got = compile_cache.run(config_from(cfg), binary_from(binary), wram,
                            mram, device="cpu", **kw)
    assert (got["cycle"] >= FIG11_PREFIX).all()          # really capped
    assert (got["status"] != engine.DONE).any()
    _assert_state({k: np.asarray(v) for k, v in want.items()}, got)
