"""The fused cycle-step kernel's CPU side (repro_torch.kernels.cycle_step):
its plain version against the driver and the JAX package, the leaf table
and constants its wrapper hands the kernel, and its routing rule.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import isa as ref_isa  # noqa: E402
from repro.core.config import DPUConfig as RefConfig  # noqa: E402
from repro_torch.core import compile_cache, engine  # noqa: E402
from repro_torch.core.carry import state_to_numpy, state_to_torch  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.kernels.cycle_step import cases, ops  # noqa: E402
from repro_torch.kernels.cycle_step.cycle_step import (  # noqa: E402
    CONFIG, LEAVES, N_FIELDS, config_fields, leaf_table, pack_image)
from repro_torch.kernels.cycle_step.ref import cycle_step_ref  # noqa: E402

#: knob combinations of the scalar engine (each covered by the kernel)
KNOBS = [
    {}, {"forwarding": True}, {"unified_rf": True},
    {"forwarding": True, "unified_rf": True, "superscalar": 2},
    {"mmu": True, "tlb_entries": 2, "page_bytes": 256},
    {"cache_mode": True, "dcache_bytes": 1024},
    {"event_skip": False}, {"collect_detail": False},
    {"mram_bw_scale": 1.3, "timeseries_window": 100},
    {"n_tasklets": 24, "superscalar": 8, "timeseries_len": 64},
]


def _knob_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items()) or "table1"


def _image(binary):
    P = compile_cache.program_bucket(binary.n_instrs, binary.opcode.shape[0])
    return np.stack([np.asarray(a[:P], np.int32) for a in binary.arrays])


def _assert_same(want, got, tag):
    assert sorted(want) == sorted(got), tag
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, (tag, k)
        assert w.tobytes() == g.tobytes(), (tag, k)


@pytest.mark.parametrize("name", ["dma_tail_clip", "jr_clamp", "superscalar",
                                  "mmu", "cross_dpu"])
def test_plain_version_matches_driver_and_jax(name):
    """K = 64 steps of the plain version then the predicate, until it is
    false, give the driver's CPU run and the JAX package's run bit for
    bit (cross_dpu cut to 4 DPUs)."""
    cfg, binary, wram, mram, T = cases.launch(
        name, 4 if name.startswith("cross") else None)
    ir_np = _image(binary)
    st = state_to_torch(engine.make_state_np(cfg, binary, wram, mram, T),
                        "cpu")
    ir = torch.from_numpy(ir_np)
    step = engine.make_step_traced(cfg, T, "cpu")
    blocks = 0
    while cycle_step_ref(cfg, st, ir, compile_cache.STEPS_PER_CHECK, step):
        blocks += 1
        assert blocks < 1000
    got = state_to_numpy(st)
    driver = compile_cache.run(cfg, binary, wram, mram, T, device="cpu")
    _assert_same(driver, got, "plain version vs driver")
    ref_cfg = RefConfig(**dataclasses.asdict(cfg))
    ref_bin = ref_isa.Binary(*[np.array(a) for a in binary.arrays],
                             binary.n_instrs, dict(binary.symbols))
    want = ref_engine.run(ref_cfg, ref_bin, wram, mram, T)
    _assert_same(want, got, "plain version vs JAX package")


def test_wrapper_cpu_path_is_the_plain_version():
    cfg, binary, wram, mram, T = cases.launch("frfcfs")
    st0 = engine.make_state_np(cfg, binary, wram, mram, T)
    ir = torch.from_numpy(_image(binary))
    a, b = state_to_torch(st0, "cpu"), state_to_torch(st0, "cpu")
    before = ops.launches
    assert ops.cycle_step(cfg, a, ir, 40) == cycle_step_ref(cfg, b, ir, 40)
    assert ops.launches == before          # the CPU path launches nothing
    _assert_same(state_to_numpy(b), state_to_numpy(a), "wrapper vs plain")


@pytest.mark.parametrize("kw", KNOBS, ids=_knob_id)
def test_leaf_table_covers_make_state_np(kw):
    """Every key of the engine's state, in the kernel's order, with its
    dtype and shape, for every knob combination."""
    fields = dict(n_dpus=3, n_tasklets=16, mram_bytes=1 << 14)
    fields.update(kw)
    cfg = DPUConfig(**fields)
    binary = cases._frfcfs_prog().binary(cfg.iram_instrs)
    st = engine.make_state_np(cfg, binary, np.zeros((3, 16), np.int32),
                              np.zeros((3, cfg.mram_words), np.int32),
                              cfg.n_tasklets)
    table = leaf_table(cfg, 3, cfg.n_tasklets, cfg.wram_words,
                       cfg.mram_words)
    assert tuple(st) == LEAVES == tuple(table)
    for name, (dtype, shape) in table.items():
        t = torch.from_numpy(st[name])
        assert (t.dtype, tuple(t.shape)) == (dtype, shape), name


@pytest.mark.parametrize("kw", KNOBS, ids=_knob_id)
def test_constants_passed_to_the_kernel_equal_step_consts(kw):
    cfg = DPUConfig(n_dpus=2, mram_bytes=1 << 14, **kw)
    T = cfg.n_tasklets
    fields, inv_bw, inv_win = config_fields(cfg, 2, T, cfg.wram_words,
                                            cfg.mram_words, 64, 64)
    C = engine.StepConsts(cfg, T, "cpu")
    assert inv_bw.dtype == inv_win.dtype == np.float32
    assert inv_bw.tobytes() == C.inv_bw.numpy().tobytes()
    assert inv_win.tobytes() == C.inv_win.numpy().tobytes()
    got = dict(zip(CONFIG, fields))
    assert len(fields) == len(CONFIG)
    st = engine.make_state_np(cfg, cases._chain_prog().binary(),
                              np.zeros((2, 1), np.int32),
                              np.zeros((2, cfg.mram_words), np.int32), T)
    assert (got["D"], got["T"], got["W"], got["M"], got["P"], got["K"]) == (
        2, T, cfg.wram_words, cfg.mram_words, 64, 64)
    assert (got["n_sets"], got["ways"]) == st["dc_tags"].shape[1:]
    assert (got["A"], got["E"], got["L"]) == (
        st["atomic"].shape[1], st["tlb_tags"].shape[1], st["ts_buf"].shape[1])
    assert got["row_hit_overhead"] == cfg.row_hit_overhead
    assert got["row_miss_overhead"] == cfg.row_miss_overhead
    for name in ("max_cycles", "row_bytes", "page_bytes", "line_bytes",
                 "small_dma_words", "revolver_cycles", "timeseries_window",
                 "superscalar", "forwarding", "unified_rf", "mmu",
                 "cache_mode", "event_skip", "collect_detail"):
        assert got[name] == int(getattr(cfg, name)), name


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_packed_image_holds_the_decoded_fields(name):
    cfg, binary, _, _, _ = cases.launch(name, 1)
    img = _image(binary)
    packed = pack_image(cfg, img)
    ints, flags = engine.decode_image(cfg, img)
    assert packed.shape == (img.shape[1], N_FIELDS)
    assert (packed[:, :10] == ints.T).all()
    bits = (packed[:, 10][None, :] >> np.arange(flags.shape[0])[:, None]) & 1
    assert (bits.astype(bool) == flags).all()
    assert (packed[:, 10] >> flags.shape[0] == 0).all()


def test_pack_image_refuses_a_register_outside_the_file():
    cfg, binary, _, _, _ = cases.launch("alu")
    img = _image(binary)
    img[2, 3] = 24                          # ra of slot 3
    with pytest.raises(ValueError, match="register"):
        pack_image(cfg, img)


@pytest.mark.parametrize("kw", KNOBS + [{"n_tasklets": 32},
                                        {"n_tasklets": 1, "superscalar": 3}],
                         ids=_knob_id)
def test_route_picks_the_kernel(kw):
    assert ops.route(DPUConfig(**kw)) == "cycle_step"


@pytest.mark.parametrize("kw", [{"n_tasklets": 33}, {"superscalar": 9},
                                {"superscalar": 0}, {"row_bytes": 0},
                                {"max_cycles": 2**31}],
                         ids=_knob_id)
def test_route_refuses_what_the_kernel_cannot_take(kw):
    with pytest.raises(ValueError):
        ops.route(DPUConfig(**kw))


def test_wrapper_refuses_cpu_state_for_the_kernel():
    cfg, binary, wram, mram, T = cases.launch("alu")
    st = state_to_torch(engine.make_state_np(cfg, binary, wram, mram, T),
                        "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.CycleStep(cfg, st, torch.from_numpy(_image(binary)))
