"""repro_torch.launch.roofline against repro.launch.roofline on the CPU:
the reference's roofline cases (tests/test_roofline_serve.py) on the
port's module, and ``to_row()``, ``model_flops`` and
``model_bytes_decode`` equal to the reference's for every arch x shape
and kind; the H100 pricing the dry-run uses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.launch import roofline as ref  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: E402
                                      get_config)
from repro_torch.launch import roofline  # noqa: E402

HLO = """
ENTRY main {
  %p = bf16[1024,512]{1,0} parameter(0)
  %ar = bf16[1024,512]{1,0} all-reduce(%p), replica_groups={}
  %ag.1 = f32[64,2048]{1,0} all-gather(%x), dimensions={0}
  %t = (f32[8,128]{1,0}, f32[4]{0}) all-to-all(%a, %b)
  %cp = u8[100]{0} collective-permute(%c)
  %rs-start = bf16[256]{0} reduce-scatter-start(%d)
  %dot = f32[16,16]{1,0} dot(%e, %f)
}
"""


def test_collective_bytes_parser():
    got = roofline.collective_bytes(HLO)
    assert got == ref.collective_bytes(HLO)
    assert got["all-reduce"] == 1024 * 512 * 2
    assert got["all-gather"] == 64 * 2048 * 4
    assert got["all-to-all"] == 8 * 128 * 4 + 4 * 4
    assert got["collective-permute"] == 100
    assert got["reduce-scatter"] == 256 * 2


def test_shape_bytes_tuple_and_scalar():
    assert roofline._shape_bytes("(f32[2,3], bf16[4])") == 24 + 8
    assert roofline._shape_bytes("pred[]") == 1


def test_model_flops_scaling():
    cfg = get_config("llama3-8b")
    tr = roofline.model_flops(cfg, SHAPES["train_4k"], "train")
    de = roofline.model_flops(cfg, SHAPES["decode_32k"], "decode")
    n = cfg.param_count()
    assert abs(tr - 6 * n * 256 * 4096) / tr < 1e-6
    assert abs(de - 2 * n * 128) / de < 1e-6


def test_moe_active_params_smaller():
    cfg = get_config("qwen3-moe-30b-a3b")
    assert cfg.param_count(active_only=True) < 0.25 * cfg.param_count()


def test_param_counts_match_published():
    """Sanity: analytic totals land near the nameplate sizes."""
    expect = {"llama3-8b": 8.0e9, "yi-34b": 34.4e9,
              "deepseek-v3-671b": 671e9, "qwen3-moe-30b-a3b": 30.5e9,
              "recurrentgemma-9b": 9.2e9, "mamba2-130m": 0.13e9}
    for arch, want in expect.items():
        got = get_config(arch).param_count()
        assert abs(got - want) / want < 0.2, (arch, got, want)


def test_reference_constants_kept():
    """The reference's TPU constants under their names (the planner twin
    prints its estimate with them), and the default hardware."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (ref.PEAK_FLOPS, ref.HBM_BW, ref.LINK_BW)
    assert roofline.RooflineReport("a", "s", "m", 1, 1.0, 1.0, 0.0, {},
                                   1.0).hw == roofline.TPU_V5E


def _fields(rng):
    return dict(flops_per_device=float(rng.uniform(1e12, 1e16)),
                bytes_per_device=float(rng.uniform(1e9, 1e13)),
                coll_bytes_per_device=float(rng.uniform(0, 1e11)),
                coll_breakdown={"all-reduce": int(rng.integers(0, 1e9)),
                                "all-gather": 0},
                bytes_in=float(rng.uniform(0, 1e11)),
                bytes_out=float(rng.uniform(0, 1e11)),
                bytes_temp=float(rng.uniform(0, 1e11)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rows_match_reference(arch):
    """For every shape and kind: model_flops, model_bytes_decode and
    to_row() equal the reference's for the same inputs."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    rng = np.random.default_rng(ARCH_IDS.index(arch))
    for shape in SHAPES.values():
        assert roofline.model_bytes_decode(cfg, shape) == \
            ref.model_bytes_decode(rcfg, shape)
        for kind in ("train", "prefill", "decode"):
            mf = roofline.model_flops(cfg, shape, kind)
            assert mf == ref.model_flops(rcfg, shape, kind)
            mb = roofline.model_bytes_decode(cfg, shape) \
                if kind == "decode" else 0.0
            f = _fields(rng)
            chips = int(rng.integers(1, 512))
            args = dict(arch=arch, shape=shape.name, mesh="16x16",
                        chips=chips, model_flops=mf, kind=kind,
                        model_bytes=mb, notes="n", **f)
            got = roofline.RooflineReport(**args)
            want = ref.RooflineReport(**args)
            assert got.to_row() == want.to_row()
            assert (got.compute_s, got.memory_s, got.collective_s,
                    got.useful_ratio, got.roofline_fraction) == \
                (want.compute_s, want.memory_s, want.collective_s,
                 want.useful_ratio, want.roofline_fraction)


def test_h100_pricing():
    h = roofline.H100
    assert (h.peak_flops, h.hbm_bw) == (989e12, 3.35e12)
    rep = roofline.RooflineReport("a", "s", "1x1", 1, 989e12, 3.35e12 / 2,
                                  0.0, {}, 989e12 / 2, kind="prefill",
                                  hw=h)
    assert (rep.compute_s, rep.memory_s, rep.collective_s) == (1.0, 0.5, 0.0)
    assert rep.bottleneck == "compute" and rep.roofline_fraction == 0.5
    dec = roofline.RooflineReport("a", "s", "1x1", 1, 0.0, 6.7e12, 0.0, {},
                                  1.0, kind="decode", model_bytes=3.35e12,
                                  hw=h)
    assert dec.bottleneck == "memory" and dec.roofline_fraction == 0.5
