"""repro_torch.launch.{specs,cost,dryrun} against the JAX package on the
CPU.

* ``input_specs``: every cell's meta tensors have the reference's shapes
  and dtypes (decode caches too; the position is a Python int in the
  port).
* A row has the reference's keys (``RooflineReport.to_row()``'s and those
  ``launch/dryrun.py``'s ``row.update`` adds, read off its source).
* The counter's FLOPs equal FlopCounterMode's (flash and GQA, the SSD
  scan, MLA with MoE and Adafactor).
* Depth extrapolation: the counts at units 2 and 4 extrapolate exactly to
  the count at 3 units (every family, whole units, smoke width): the
  port's layers are a loop, so its counts are linear in depth.
* FLOPs against XLA's: tests/test_torch_dryrun_xla.py.
* Bytes of the arguments: those of the real (CPU) model and optimizer
  state and of the batch.
* Every family's train, prefill and decode cells run on meta, mamba2's
  included; ``Transformer`` and ``init_train_state`` build on meta with no
  generator; ``main`` writes an OK or ``SKIP(policy)`` row a cell at full
  width (``--mesh 1x1``; ``--multi-pod``, the 2x16x16 mesh's:
  tests/test_torch_dryrun_mesh.py); ``run_pim_cell`` on the CPU.
"""
import ast
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: E402
                                      ShapeSpec, get_config,
                                      get_smoke_config)
from repro_torch.launch import cost, dryrun, specs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import get_optimizer, warmup_cosine  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: a small cell of each kind at smoke width
MINI = {"train": ShapeSpec("mini_train", "train", 64, 4),
        "prefill": ShapeSpec("mini_prefill", "prefill", 64, 2),
        "decode": ShapeSpec("mini_decode", "decode", 64, 2)}
#: one architecture of each family (moe twice: GQA and MLA)
FAMILIES = ("llama3-8b", "mamba2-130m", "qwen3-moe-30b-a3b",
            "deepseek-v3-671b", "recurrentgemma-9b",
            "seamless-m4t-large-v2", "llava-next-mistral-7b")

_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def _same_spec(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), what
    assert got.dtype == _DTYPES[str(want.dtype)], what
    assert got.device.type == "meta", what


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in SHAPES:
        if not cfg.supports_shape(SHAPES[shape]):
            continue
        got = specs.input_specs(cfg, shape)
        want = ref_specs.input_specs(rcfg, shape)
        if SHAPES[shape].kind == "decode":
            assert set(got["cache"]) == set(want["cache"])
            for k, v in want["cache"].items():
                if k == "pos":
                    assert got["cache"][k] == 0 and v.shape == ()
                    continue
                _same_spec(got["cache"][k], v, (arch, shape, k))
            _same_spec(got["tokens"], want["tokens"], (arch, shape))
            continue
        assert set(got) == set(want), (arch, shape)
        for k, v in want.items():
            _same_spec(got[k], v, (arch, shape, k))


def test_row_keys_match_reference():
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    added = {kw.arg for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", None) == "update"
             for kw in node.keywords}
    rep = ref_roofline.RooflineReport("a", "s", "m", 1, 1.0, 1.0, 0.0, {},
                                      1.0)
    want = set(rep.to_row()) | added
    row = dryrun.run_cell("mamba2-130m", "decode_32k", verbose=False)
    assert row["status"] == "OK" and set(row) == want
    assert set(row["bytes_per_device"]) == {"args", "out", "temp"}
    assert row["mesh"] == "1x1" and row["coll"] == {}
    assert "meta device" in row["notes"]
    skip = dryrun.run_cell("llama3-8b", "long_500k")
    assert skip["status"] == "SKIP(policy)" and skip["mesh"] == "1x1"


def _units_cfg(arch, u):
    """``arch``'s smoke config at ``u`` units, microbatches 1."""
    return dryrun._with_units(get_smoke_config(arch), u)


@pytest.mark.parametrize("arch", FAMILIES)
def test_depth_extrapolation_is_exact(arch):
    """Units 2 and 4 extrapolate to 3 units exactly; every kind runs on
    meta (mamba2's SSD scan among them)."""
    for kind, shape in MINI.items():
        if not get_smoke_config(arch).supports_shape(shape):
            continue
        c2, k, _, _ = dryrun.count_cell(_units_cfg(arch, 2), shape)
        c4, _, _, _ = dryrun.count_cell(_units_cfg(arch, 4), shape)
        c3, _, _, _ = dryrun.count_cell(_units_cfg(arch, 3), shape)
        assert k == kind
        got = c2.scaled(c4, (3 - 2) / 2.0)
        assert c4.flops > c2.flops > 0, (arch, kind)
        assert got.flops == c3.flops, (arch, kind)
        assert got.args == c3.args, (arch, kind)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_holds_only_its_cache_across_layers(arch):
    """What a prefill's peak gains with depth is its cache's growth (at
    most twice it: the per-layer leaves and their stack): no layer's
    activations outlive it, as a cache entry that is a view of one would
    keep them (the ssm conv tail, the hybrid window)."""
    shape = ShapeSpec("p", "prefill", 1024, 2)
    c2, _, _, _ = dryrun.count_cell(_units_cfg(arch, 2), shape)
    c4, _, _, _ = dryrun.count_cell(_units_cfg(arch, 4), shape)
    assert 0 < c4.out - c2.out <= c4.temp - c2.temp <= 2 * (c4.out - c2.out)


@pytest.mark.parametrize("arch", ("llama3-8b", "deepseek-v3-671b",
                                  "seamless-m4t-large-v2"))
def test_args_bytes_are_the_real_arguments(arch):
    """The meta cell's argument bytes are those of the real model (and
    optimizer state) built on the CPU, and of the batch."""
    cfg = get_smoke_config(arch)
    opt = get_optimizer(cfg.optimizer, warmup_cosine(3e-4))
    state = train_loop.init_train_state(cfg, opt, device="cpu")
    for kind in ("train", "prefill"):
        shape = MINI[kind]
        counts, _, _, _ = dryrun.count_cell(cfg, shape)
        batch = (specs.batch_specs(cfg, shape) if kind == "train"
                 else specs.prefill_specs(cfg, shape))
        real = cost.tree_bytes(state if kind == "train"
                               else state["params"])
        assert counts.args == real + cost.tree_bytes(batch), (arch, kind)


def test_models_build_on_meta_without_a_generator():
    for arch in FAMILIES:
        cfg = get_config(arch).replace(n_layers=2, n_dense_layers=0) \
            if arch == "deepseek-v3-671b" else get_smoke_config(arch)
        model = T.Transformer(cfg, device="meta")
        assert all(p.device.type == "meta" for p in model.parameters())
    state = train_loop.init_train_state(
        get_config("llama3-8b"), get_optimizer("adamw", warmup_cosine(1e-3)),
        device="meta")
    assert state["opt"]["m"]["embed.tok"].device.type == "meta"


@pytest.mark.parametrize("arch", ("llama3-8b", "mamba2-130m",
                                  "deepseek-v3-671b"))
def test_flops_equal_flop_counter_mode(arch):
    """The counter's FLOPs (FlopCounterMode's formulas read per op) are
    FlopCounterMode's own count of the same cells."""
    cfg = get_smoke_config(arch)
    for shape in MINI.values():
        cell = specs.make_cell(cfg, shape)
        with torch.utils.flop_counter.FlopCounterMode(
                display=False, custom_mapping=cost.KERNEL_FLOPS) as fc:
            cell["fn"](*cell["args"])
        cell = specs.make_cell(cfg, shape)
        assert cost.count(cell["fn"], *cell["args"]).flops == \
            fc.get_total_flops() > 0, (arch, shape.kind)


def test_counts_flash_as_the_kernel():
    """One flash call a layer, its FLOPs those of the visible pairs."""
    cfg = get_smoke_config("llama3-8b").replace(n_layers=1)
    shape = ShapeSpec("p", "prefill", 256, 1)
    cell = specs.make_cell(cfg, shape)
    with torch.utils.flop_counter.FlopCounterMode(
            display=False, custom_mapping=cost.KERNEL_FLOPS) as fc:
        cell["fn"](*cell["args"])
    flash = fc.get_flop_counts()["Global"][
        torch.ops.repro_torch.flash_attention_meta]
    assert flash == 2 * cfg.n_heads * (256 * 257 // 2) * 2 * cfg.d_head
    assert cost.visible_pairs(6, False, 0) == 36
    assert cost.visible_pairs(6, True, 2) == 11


def test_counts_ssd_as_the_kernel():
    """One SSD scan a layer on meta, forward and backward (the forward
    twice in training: block remat runs it again in the backward): its
    FLOPs those of each chunk's causal pairs and state products (a ragged
    last chunk), its bytes its inputs read and its outputs written
    once."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    cfg = get_smoke_config("mamba2-130m").replace(n_layers=1)
    H, P, G, N = (cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_ngroups,
                  cfg.ssm_state)
    assert cfg.ssm_chunk == 16 and cfg.remat == "block"
    rows = (16, 16, 8)                          # 40 positions
    fwd = sum(G * r * (r + 1) * N + H * (r * (r + 1) * P + 4 * r * N * P)
              for r in rows)
    bwd = sum(G * r * (r + 1) * N
              + H * (r * (r + 1) * (2 * P + 2 * N) + 10 * r * N * P)
              for r in rows)
    ops = torch.ops.repro_torch
    for kind, want in (("prefill", {ops.ssd_scan_meta: fwd}),
                       ("train", {ops.ssd_scan_meta: 2 * fwd,
                                  ops.ssd_scan_bwd_meta: bwd})):
        cell = specs.make_cell(cfg, ShapeSpec("s", kind, 40, 1))
        with torch.utils.flop_counter.FlopCounterMode(
                display=False, custom_mapping=cost.KERNEL_FLOPS) as fc:
            cell["fn"](*cell["args"])
        got = fc.get_flop_counts()["Global"]
        assert {op: got[op] for op in want} == want, kind

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    x, Bm, Cm = meta(1, 40, H, P), meta(1, 40, G, N), meta(1, 40, G, N)
    dt, A = meta(1, 40, H, dtype=torch.float32), meta(H, dtype=torch.float32)
    with cost.Counter() as c:
        y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    assert c.flops == fwd
    assert c.bytes == sum(cost.tree_bytes(t) for t in
                          (x, dt, A, Bm, Cm, y, state))
    assert state.shape == (1, H, N, P) and state.dtype == torch.float32


def test_main_writes_every_cell(tmp_path):
    """One architecture's four cells at full width on one card (``--mesh
    1x1``, ``__1x1`` rows): OK or SKIP(policy) rows, read back by
    benchmarks/lm_roofline.py's table; ``--multi-pod`` writes the
    2x16x16 mesh's row (``__mp``)."""
    assert dryrun.main(["--arch", "llama3-8b", "--mesh", "1x1", "--device",
                        "cpu", "--out", str(tmp_path)]) == 0
    paths = sorted(tmp_path.iterdir())
    assert all(p.name.endswith("__1x1.json") for p in paths)
    rows = [json.loads(p.read_text()) for p in paths]
    assert [r["shape"] for r in rows] == sorted(REF_SHAPES)
    assert {r["status"] for r in rows} == {"OK", "SKIP(policy)"}
    assert {r["mesh"] for r in rows} == {"1x1"}
    ok = [r for r in rows if r["status"] == "OK"]
    assert all(r["compute_ms"] > 0 and r["memory_ms"] > 0 for r in ok)
    assert dryrun.main(["--multi-pod", "--arch", "llama3-8b", "--shape",
                        "decode_32k", "--device", "cpu",
                        "--out", str(tmp_path / "mp")]) == 0
    (row,) = [json.loads(p.read_text())
              for p in (tmp_path / "mp").iterdir()]
    assert (tmp_path / "mp" / "llama3-8b__decode_32k__mp.json").exists()
    assert row["status"] == "OK" and row["mesh"] == "2x16x16"


def test_run_pim_cell_on_the_cpu():
    row = dryrun.run_pim_cell("cpu", n_dpus=4)
    assert row["status"] == "OK" and row["kind"] == "simulate"
    assert row["bytes_per_device"]["args"] > 0
    assert row["bytes_per_device"]["temp"] is None   # not measured
    assert row["cycle_step_launches"] == 0           # the card's kernel
