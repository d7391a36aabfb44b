"""The SIMT and CRF step kernels' CPU side (repro_torch.kernels.simt_step,
repro_torch.kernels.crf_step): each case's plain version against the JAX
package on every leaf after 1, 7 and every K steps, and against the
driver; the leaf tables, images and constants the wrappers hand the
kernels; the routing rules; and the driver's refusal to run a backend
without a kernel on the card.  The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backend as ref_backend  # noqa: E402
from repro.core import compile_cache as ref_cc  # noqa: E402
from repro.core import isa as ref_isa  # noqa: E402
from repro.core.config import DPUConfig as RefConfig  # noqa: E402
from repro_torch.core import backend, compile_cache, engine, simt  # noqa: E402
from repro_torch.core.carry import state_to_numpy, state_to_torch  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.kernels.crf_step import cases as crf_cases  # noqa: E402
from repro_torch.kernels.crf_step import crf_step as k_crf  # noqa: E402
from repro_torch.kernels.crf_step import ops as crf_ops  # noqa: E402
from repro_torch.kernels.simt_step import cases  # noqa: E402
from repro_torch.kernels.simt_step import ops  # noqa: E402
from repro_torch.kernels.simt_step import simt_step as k_simt  # noqa: E402
from repro_torch.kernels.simt_step.ref import simt_step_ref  # noqa: E402

K = compile_cache.STEPS_PER_CHECK
_REF_STEPS = {}


def _assert_same(want, got, tag):
    assert sorted(want) == sorted(got), tag
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, (tag, k)
        assert w.tobytes() == g.tobytes(), (tag, k)


def _image(binary):
    P = compile_cache.program_bucket(binary.n_instrs, binary.opcode.shape[0])
    return np.stack([np.asarray(a[:P], np.int32) for a in binary.arrays])


def _ref(cfg, binary):
    ref_cfg = RefConfig(**dataclasses.asdict(cfg))
    ref_bin = ref_isa.Binary(*[np.array(a) for a in binary.arrays],
                             binary.n_instrs, dict(binary.symbols))
    return ref_cfg, ref_bin


def _lockstep(case, edit=None):
    """Step the JAX package's backend and the port's plain step side by
    side from the same (padded) initial state until the reference
    predicate turns false; every leaf equal after 1, 7 and every K steps
    and at the end.  Returns (steps, final state)."""
    cfg, binary, wram, mram, T = case
    name = backend.resolve_backend(cfg)
    be, rbe = backend.get(name), ref_backend.get(name)
    ref_cfg, ref_bin = _ref(cfg, binary)
    Dp = compile_cache.dpu_bucket(cfg.n_dpus)
    st0 = compile_cache._padded_state(cfg, be, binary, wram, mram, T, Dp)
    ref0 = ref_cc._padded_state(ref_cfg, rbe, ref_bin, wram, mram, T, Dp)
    if edit is not None:
        edit(st0)
        ref0 = {k: np.array(v) for k, v in ref0.items()}
        edit(ref0)
        ref0 = jax.tree_util.tree_map(jnp.asarray, ref0)
    _assert_same(jax.tree_util.tree_map(np.asarray, ref0), st0, "initial")
    key = (name, rbe.static_key(ref_cfg.replace(n_dpus=Dp)), T)
    if key not in _REF_STEPS:
        step, cond = rbe.step_driver(ref_cfg.replace(n_dpus=Dp), T)
        _REF_STEPS[key] = (jax.jit(step), jax.jit(cond))
    rstep, rcond = _REF_STEPS[key]
    ir_np = _image(binary)
    rir = tuple(jnp.asarray(x) for x in ir_np)
    pstep, pcond = be.step_driver(cfg.replace(n_dpus=Dp), T,
                                  torch.device("cpu"))
    ir = torch.from_numpy(ir_np)
    st, rst = state_to_torch(st0, "cpu"), ref0
    n = 0
    while bool(rcond(rst)):
        rst = rstep(rir, rst)
        st = pstep(ir, st)
        n += 1
        if n in (1, 7) or n % K == 0:
            _assert_same(jax.tree_util.tree_map(np.asarray, rst),
                         state_to_numpy(st), f"step {n}")
    assert not bool(pcond(st))
    out = jax.tree_util.tree_map(np.asarray, rst)
    _assert_same(out, state_to_numpy(st), f"final (step {n})")
    return n, out


# ---------------------------------------------------------------------------
# SIMT cases: the plain version against the JAX package and the driver
# ---------------------------------------------------------------------------

SIMT_CASES = sorted(n for n in cases.CASES if n != "xdpu")


@pytest.mark.parametrize("name", SIMT_CASES)
def test_simt_case_matches_jax(name):
    n, st = _lockstep(cases.launch(name))
    assert n >= 7
    if name == "livelock_capped":      # the spin never ends: capped
        assert (st["status"] != engine.DONE).any()
        assert (st["cycle"] >= 3000).any()


def test_simt_many_dpus_match_jax_and_driver():
    """xdpu cut to 12 DPUs (bucket 16): DPUs stop at different cycles, some
    at max_cycles; the driver (K steps a check) gives the same."""
    case = cases.launch("xdpu", 12)
    _, want = _lockstep(case)
    cfg, binary, wram, mram, T = case
    got = compile_cache.run(cfg, binary, wram, mram, T, device="cpu")
    _assert_same({k: v[:12] for k, v in want.items()}, got, "driver")


@pytest.mark.parametrize("name", ["sw_collide", "dma_tail", "allbank"])
def test_simt_plain_version_matches_driver(name):
    """K steps of the plain version then the predicate, until it is
    false, give the driver's CPU run (the traced step) bit for bit."""
    cfg, binary, wram, mram, T = cases.launch(name)
    be = backend.get(backend.resolve_backend(cfg))
    st = state_to_torch(be.make_state(cfg, binary, wram, mram, T), "cpu")
    ir = torch.from_numpy(_image(binary))
    step, _ = be.step_driver(cfg, T, torch.device("cpu"))
    scfg = cfg if name != "allbank" else cfg.replace(simt_width=T,
                                                     coalescing=True)
    blocks = 0
    while simt_step_ref(scfg, st, ir, K, step):
        blocks += 1
        assert blocks < 1000
    got = state_to_numpy(st)
    _assert_same(compile_cache.run(cfg, binary, wram, mram, T, device="cpu"),
                 got, "plain version vs driver")


def test_simt_wrapper_cpu_path_is_the_plain_version():
    cfg, binary, wram, mram, T = cases.launch("frfcfs")
    st0 = simt.make_state_np(cfg, binary, wram, mram, T)
    ir = torch.from_numpy(_image(binary))
    a, b = state_to_torch(st0, "cpu"), state_to_torch(st0, "cpu")
    before = ops.launches
    assert ops.simt_step(cfg, a, ir, 40) == simt_step_ref(cfg, b, ir, 40)
    assert ops.launches == before          # the CPU path launches nothing
    _assert_same(state_to_numpy(b), state_to_numpy(a), "wrapper vs plain")


@pytest.mark.parametrize("name", ["width_4", "width_32", "allbank", "xdpu"])
def test_simt_leaf_table_covers_make_state_np(name):
    cfg, binary, wram, mram, T = cases.launch(name)
    be = backend.get(backend.resolve_backend(cfg))
    st = be.make_state(cfg, binary, wram, mram, T)
    kcfg = cfg if name != "allbank" else cfg.replace(simt_width=T)
    table = k_simt.leaf_table(kcfg, cfg.n_dpus, T, st["wram"].shape[1],
                              st["mram"].shape[1])
    assert set(table) <= set(st) == ops.SimtStep.state_keys(None, kcfg, st)
    assert tuple(table) == k_simt.LEAVES
    for k, (dtype, shape) in table.items():
        t = torch.from_numpy(st[k])
        assert (t.dtype, tuple(t.shape)) == (dtype, shape), k


@pytest.mark.parametrize("name", ["rows_ac", "bw_16x", "width_4"])
def test_simt_constants_equal_the_plain_step(name):
    cfg, binary, wram, mram, T = cases.launch(name)
    fields, inv_bw = k_simt.config_fields(cfg, 2, T, 16384, 4096, 64, 64)
    C = simt.SimtConsts(cfg, T, "cpu")
    assert inv_bw.dtype == np.float32
    assert inv_bw.tobytes() == C.inv_bw.numpy().tobytes()
    got = dict(zip(k_simt.CONFIG, fields))
    assert (got["D"], got["T"], got["W"], got["M"], got["P"], got["K"]) == (
        2, T, 16384, 4096, 64, 64)
    for f in ("simt_width", "max_cycles", "row_bytes", "row_miss_overhead",
              "coalescing", "mul_extra", "div_extra", "event_skip"):
        assert got[f] == int(getattr(cfg, f)), f
    assert got["A"] == cfg.atomic_bits


def test_simt_pack_image_holds_the_decoded_fields_and_checks_registers():
    cfg, binary, _, _, _ = cases.launch("width_8")
    img = _image(binary)
    packed = k_simt.pack_image(img)
    assert packed.shape == (img.shape[1], k_simt.N_FIELDS)
    assert (packed.T == simt.decode_image(img)).all()
    img[2, 3] = 24                          # ra of slot 3
    with pytest.raises(ValueError, match="register"):
        k_simt.pack_image(img)


def test_simt_route_refuses_only_more_than_32_tasklets():
    for T in (1, 4, 16, 32):
        assert ops.route(DPUConfig(simt_width=1), T) == "simt_step"
    assert ops.route(DPUConfig(simt_width=4, max_cycles=2**40, row_bytes=3,
                               coalescing=True), 8) == "simt_step"
    with pytest.raises(ValueError, match="33 tasklets"):
        ops.route(DPUConfig(simt_width=1), 33)


def test_simt_wrapper_refuses_cpu_state_for_the_kernel():
    cfg, binary, wram, mram, T = cases.launch("diverge")
    st = state_to_torch(simt.make_state_np(cfg, binary, wram, mram, T), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.SimtStep(cfg, st, torch.from_numpy(_image(binary)))


# ---------------------------------------------------------------------------
# CRF cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(crf_cases.CASES))
def test_crf_case_matches_jax(name):
    n, st = _lockstep(crf_cases.launch(name), crf_cases.edit_of(name))
    assert n >= 5
    if "max_cycles" not in crf_cases.CASES[name][1]:
        assert (st["status"] == engine.DONE).all()


def test_crf_bank_past_max_cycles_keeps_executing():
    """max_cycles: bank 0 starts 30 cycles before the cap and passes it
    while bank 1 runs; it still executes commands (its pc moves on)."""
    case = crf_cases.launch("max_cycles")
    cfg, binary, srf0, mram, T = case
    be = backend.get("hbmpim_cmd")
    st0 = compile_cache._padded_state(cfg, be, binary, srf0, mram, T, 2)
    crf_cases.edit_of("max_cycles")(st0)
    step = be.step_driver(cfg, T, torch.device("cpu"))[0]
    ir = torch.from_numpy(_image(binary))
    st = state_to_torch(st0, "cpu")
    passed = None
    for n in range(200):
        st = step(ir, st)
        if passed is None and int(st["cycle"][0]) >= cfg.max_cycles:
            passed = (n, int(st["pc"][0]))
    assert passed is not None and int(st["pc"][0]) > passed[1]


def test_crf_wrapper_cpu_path_leaf_table_and_image():
    cfg, binary, srf0, mram, T = crf_cases.launch("ops")
    from repro_torch.core import hbmpim
    st0 = hbmpim.make_cmd_state_np(cfg, binary, srf0, mram, T)
    assert set(st0) == k_crf.STATE_KEYS
    table = k_crf.leaf_table(cfg, 4, cfg.mram_words, 2)
    assert tuple(table) == k_crf.LEAVES
    for k, (dtype, shape) in table.items():
        t = torch.from_numpy(st0[k])
        assert (t.dtype, tuple(t.shape)) == (dtype, shape), k
    img = _image(binary)
    packed = k_crf.pack_image(img)
    assert (packed[:, :5].T == img[:5]).all() and (packed[:, 5:] == 0).all()
    fields = dict(zip(k_crf.CONFIG, k_crf.config_fields(cfg, 4, 100, 64, 8,
                                                        2)))
    # 16 lanes x 4 bytes at 2 x 3.4 bytes a cycle: ceil(9.41)
    assert fields["xfer"] == 10 and fields["hbm_lanes"] == 16
    ir = torch.from_numpy(img)
    a, b = state_to_torch(st0, "cpu"), state_to_torch(st0, "cpu")
    from repro_torch.kernels.crf_step.ref import crf_step_ref
    before = crf_ops.launches
    assert crf_ops.crf_step(cfg, a, ir, 5) == crf_step_ref(cfg, b, ir, 5)
    assert crf_ops.launches == before
    _assert_same(state_to_numpy(b), state_to_numpy(a), "wrapper vs plain")
    with pytest.raises(ValueError, match="CUDA"):
        crf_ops.CrfStep(cfg, a, ir)


def test_crf_route_refuses_more_than_32_lanes():
    assert crf_ops.route(DPUConfig(hbm_lanes=32)) == "crf_step"
    with pytest.raises(ValueError, match="hbm_lanes 33"):
        crf_ops.route(DPUConfig(hbm_lanes=33))


# ---------------------------------------------------------------------------
# the driver picks the card kernel by backend (no engine runs another's)
# ---------------------------------------------------------------------------


def test_each_backend_names_its_card_kernel():
    """On the card each backend's driver is its own kernel's: the scalar
    engine's cycle_step, the SIMT engine's and the all-bank compat
    target's simt_step, the command model's crf_step (given CPU tensors,
    each refuses them by its kernel's name)."""
    want = {"scalar": "cycle_step", "simt": "simt_step",
            "hbmpim": "simt_step", "hbmpim_cmd": "crf_step"}
    for name, kernel in want.items():
        with pytest.raises(ValueError,
                           match=f"^{kernel}: the kernel runs on CUDA"):
            backend.get(name).card_kernel(
                DPUConfig(simt_width=1),
                {"status": torch.zeros((1, 1), dtype=torch.int32)},
                torch.zeros((6, 1), dtype=torch.int32), None)


def test_backend_without_a_card_kernel_raises(monkeypatch):
    """A backend that registers no kernel raises when asked for one (the
    driver asks on the card): no other engine's kernel runs its state,
    and nothing falls back.  On the CPU it runs its plain step."""

    class Dummy(backend.ExecBackend):
        name = "dummy"

        def make_state(self, cfg, binary, wram_init, mram_init, n_threads):
            return simt.make_state_np(cfg.replace(simt_width=1), binary,
                                      wram_init, mram_init, n_threads)

        def step_driver(self, cfg, n_threads, device):
            return (simt.make_step_traced(cfg.replace(simt_width=1),
                                          n_threads, device),
                    engine.make_cond(cfg))

    monkeypatch.setitem(backend._REGISTRY, "dummy", Dummy())
    cfg, binary, wram, mram, T = cases.launch("diverge")
    st = state_to_torch(backend.get("dummy").make_state(
        cfg, binary, wram, mram, T), "cpu")
    with pytest.raises(NotImplementedError, match="'dummy' has no CUDA"):
        backend.get("dummy").card_kernel(cfg, st, torch.from_numpy(
            _image(binary)), _image(binary))
    out = compile_cache.run(cfg, binary, wram, mram, T, backend="dummy",
                            device="cpu")
    assert (out["status"] == engine.DONE).all()
