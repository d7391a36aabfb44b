"""The dry-run on the production meshes (``launch/dryrun.py``): the port's
sharded program counted as one rank of a ``fake`` process group
(``launch.mesh.fake_group``), on the CPU.  Each fake group is made and
destroyed inside its test (the group is process-wide state).

* The small mesh, against XLA's own memory analysis (the reference's
  ``scenario_dryrun_cell_small_mesh``): llama3-smoke's train (64 x 8),
  prefill and decode cells on a (pod 2, data 2, model 2) mesh, counted
  by the port as ranks 0 and 7 of a fake group of 8, and compiled by the
  JAX package on 8 host devices (``tests/_torch_dist.py dryrun``, a
  process of its own).  Each rank's argument bytes equal XLA's
  ``argument_size_in_bytes`` but for one scalar: the reference's step
  count (train) and cache position (decode) are int32 arguments, 4 bytes,
  where the port's are Python ints.  Both hold the same blocks of the
  same dtypes; the temporaries are each program's own.  Both sides take
  the train cell in one microbatch (the smoke config's 4 microbatches of
  2 rows do not split over the port's 4 data-parallel ranks, which its
  sharded step requires; the arguments are the same either way).
* The cells' blocks on the production meshes at full width: each rank's
  parameters, batch rows and cache blocks have the shapes their specs
  give, and the sharded cache's specs are the reference's
  ``cache_sharding`` on an ``AbstractMesh`` of the same shape.
* The count's arithmetic on 16x16, llama3-8b at full width cut to 2
  layers (the docstring of :func:`test_collective_bytes_closed_form`
  derives the collectives of the tensor- and sequence-parallel program);
  the corner ranks' counts agree but for the cache write of a decode
  step.
* ``main``: ``--single-pod`` writes ``__sp`` rows, ``--multi-pod``
  ``__mp`` rows (the memory pass), neither both; the PIM cell's mesh rows.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import AbstractMesh  # noqa: E402

import _torch_dist as td  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.parallel import api as ref_par  # noqa: E402
from repro_torch.configs.base import (ShapeSpec, get_config,  # noqa: E402
                                      get_smoke_config)
from repro_torch.launch import cost, dryrun, specs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.parallel import api as par  # noqa: E402

#: the int32 scalar argument the reference has and the port has not
SCALAR_BYTES = {"train": 4, "prefill": 0, "decode": 4}


@pytest.fixture(scope="module")
def xla_mem(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_xla")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(Path(td.__file__)),
                           "dryrun", str(out)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((out / "xla_mem.json").read_text())


def _small_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(td.SMALL_MESH.values()),
                            mesh_dim_names=tuple(td.SMALL_MESH))


@pytest.mark.parametrize("kind", sorted(td.DRYRUN_CELLS))
def test_args_bytes_equal_xla_on_a_small_mesh(xla_mem, kind):
    name, seq, batch = td.DRYRUN_CELLS[kind]
    shape = ShapeSpec(name, kind, seq, batch)
    cfg = get_smoke_config("llama3-8b").replace(train_microbatches=1)
    for rank in (0, 7):
        with mesh_mod.fake_group(8, rank):
            cell = specs.make_cell(cfg, shape, _small_mesh())
            counts = cost.count(cell["fn"], *cell["args"])
        assert counts.args + SCALAR_BYTES[kind] == xla_mem[kind]["args"], \
            (kind, rank, counts.args, xla_mem[kind])


def _block_shape(shape, spec, axes):
    return tuple(d // par.block_index(e, axes, {a: 0 for a in axes})[1]
                 for d, e in zip(shape, spec))


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", ("llama3-8b", "mamba2-130m",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"))
def test_cells_place_blocks_by_the_reference_specs(arch, multi_pod):
    """Each rank's blocks on the production mesh have the shapes their
    specs give: the parameters (``param_shardings``), the prompt's rows
    (``batch_sharding``) and the decode cache, whose specs equal the
    reference's ``cache_sharding`` on an ``AbstractMesh``."""
    axes = mesh_mod.production_shape(multi_pod)
    cfg = get_config(arch).replace(n_layers=3 if arch.startswith("rec")
                                   else 2, n_enc_layers=2, n_dec_layers=2)
    ref_mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    ref_cache = ref_specs.decode_specs(
        ref_config(arch).replace(n_layers=cfg.n_layers, n_enc_layers=2,
                                 n_dec_layers=2), _shape("decode_32k"))[0]
    want = {k: tuple(v.spec) for k, v in ref_par.cache_sharding(
        ref_cache, ref_mesh).items() if k != "pos"}
    with mesh_mod.fake_group(math.prod(axes.values()), 0):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        pre = specs.make_cell(cfg, "prefill_32k", mesh)
        dec = specs.make_cell(cfg, "decode_32k", mesh)
    model = pre["args"][0]
    for n, p in model.named_parameters():
        assert p.shape == _block_shape(
            specs.abstract_params(cfg).get_parameter(n).shape,
            model.shardings[n], axes), n
    for k, v in pre["args"][1].items():
        whole = specs.prefill_specs(cfg, _shape("prefill_32k"))[k]
        spec = par.batch_sharding({k: whole}, axes)[k]
        assert v.shape == _block_shape(whole.shape, spec, axes), k
    cache = dec["args"][1]
    assert cache["specs"] == want
    for k, spec in want.items():
        assert cache[k].shape == _block_shape(ref_cache[k].shape, spec,
                                              axes), k


def _shape(name):
    from repro_torch.configs.base import SHAPES
    return SHAPES[name]


def _llama_cells(rank):
    """llama3-8b at full width, 2 layers: (config, {kind: counts}) of its
    prefill_32k and decode_32k cells as ``rank`` of the 16x16 mesh."""
    cfg = get_config("llama3-8b").replace(n_layers=2)
    with mesh_mod.fake_group(256, rank):
        mesh = mesh_mod.make_production_mesh(device_type="cpu")
        return cfg, {kind: dryrun.count_cell(cfg, f"{kind}_32k", mesh)[0]
                     for kind in ("prefill", "decode")}


def test_parameter_bytes_are_the_sum_of_blocks():
    """A rank's argument bytes of the prefill cell: its parameter blocks
    (float32) and its rows of the prompt (int32), each block the leaf's
    size over the ranks its spec splits it across."""
    axes = mesh_mod.production_shape(False)
    cfg, counts = _llama_cells(0)
    whole = specs.abstract_params(cfg)
    params = sum(4 * math.prod(_block_shape(p.shape, par.param_spec(
        n, p.shape, axes), axes)) for n, p in whole.named_parameters())
    rows = 4 * (32 // 16) * 32768
    assert counts["prefill"].args == params + rows


def test_collective_bytes_closed_form():
    """The collectives of llama3-8b's prefill_32k and decode_32k cells (2
    layers, full width) on one rank of 16x16, in result bytes on the rank,
    serving's dtype bf16 (2 bytes) but for the softmax merge.

    Weights: the sharded model keeps every leaf's ``model`` block and
    gathers it over ``data`` (each spec names both, or none: the 1-D norm
    scales stay whole), once a pass: each block's leaves where the layer
    runs, the embedding table in ``_inputs``, the final norm and LM head
    in ``_logits``.  A gather is counted as an all-gather whose result is
    the leaf's ``model`` block: 2 x sum(numel) / 16 over the named leaves.

    Prefill (B_loc = 32 / 16 rows of S = 32,768; the residual stream is
    the rank's S / 16 positions): the vocab-parallel embedding's partial
    rows reduce-scattered over the sequence, then in each layer the
    attention's and the MLP's input all-gathered over the sequence and
    their row-parallel outputs reduce-scattered back, each (B_loc, S, D);
    k's and v's column blocks (1,024 / 16 columns: half a head, the 8 KV
    heads do not divide 16) all-gathered whole, (B_loc, S, KV Dh) each.
    Then the last position of each sequence block gathered, (16, B_loc,
    D), and the logits of the rank's vocabulary block all-gathered,
    (B_loc, V).  A reduce-scatter is counted with what its all-to-all
    returns, the 16 blocks: (B_loc, S, D).  The cache's blocks are cut
    from the whole KV heads: nothing more.

    A decode step (B_loc = 128 / 16, one position: nothing splits along
    the sequence): the embedding's partial rows all-reduced, (B_loc, D);
    in each layer the step's q heads (2 a rank) all-gathered, (B_loc, H,
    Dh), k's and v's column blocks likewise, (B_loc, KV Dh); the partial
    softmax over the rank's block of the cache's sequence merged by three
    float32 all-reduces (the partial maximum and sum, (B_loc, H), and P.V,
    (B_loc, H, Dh)); the row-parallel wo and the MLP's all-reduced,
    (B_loc, D) each; the logits all-gathered, (B_loc, V)."""
    axes = mesh_mod.production_shape(False)
    cfg, counts = _llama_cells(0)
    whole = specs.abstract_params(cfg)
    gathered = sum(2 * p.numel() // 16 for n, p in whole.named_parameters()
                   if par.spec_axes(par.param_spec(n, p.shape, axes)))
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, S = 32 // 16, 32768
    bsd = 2 * b * S * D
    assert counts["prefill"].coll_by_kind() == {
        "all-gather": gathered + L * (2 * bsd + 2 * 2 * b * S * KV * Dh)
        + 2 * 16 * b * D + 2 * b * V,
        "reduce-scatter": (1 + 2 * L) * bsd}
    b = 128 // 16
    merge = L * 4 * b * H * (2 + Dh)
    assert counts["decode"].coll_by_kind() == {
        "all-gather": gathered + L * 2 * b * (H * Dh + 2 * KV * Dh)
        + 2 * b * V,
        "all-reduce": 2 * b * D * (1 + 2 * L) + merge}


def test_corner_ranks_agree_but_for_the_cache_write():
    """Ranks 0 (coordinate all-0) and 255 (all-last) of 16x16 count the
    same FLOPs, argument, result and temporary bytes and collectives in
    both cells, and the same bytes accessed in the prefill: their blocks
    of every leaf, of the vocabulary, of the heads and of the sequence are
    all of one size, and every rank gathers the last position of each
    sequence block.  In the decode step at position 0 the write of the new
    K and V (every KV head: the step's k and v are gathered whole) lands
    in rank 0's block alone: its bytes exceed rank 255's by that
    ``copy_``'s operands (the slot and the new row) and result (the slot),
    3 x (B_loc, KV, Dh) bf16 for K and for V in each layer."""
    cfg, c0 = _llama_cells(0)
    _, c1 = _llama_cells(255)
    for kind in ("prefill", "decode"):
        a, b = c0[kind], c1[kind]
        assert (a.flops, a.args, a.out, a.temp) == \
            (b.flops, b.args, b.out, b.temp), kind
        assert a.coll_by_kind() == b.coll_by_kind(), kind
    assert c0["prefill"].bytes == c1["prefill"].bytes
    write = cfg.n_layers * 2 * 3 * (128 // 16) * cfg.n_kv_heads \
        * cfg.d_head * 2
    assert c0["decode"].bytes - c1["decode"].bytes == write


def test_main_writes_the_meshes_rows(tmp_path):
    """``--single-pod`` writes the 16x16 row (``__sp``), ``--multi-pod``
    the 2x16x16 row (``__mp``, its bytes a device: the memory pass), and
    neither flag both; each row says in its notes how it was counted."""
    cell = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--device",
            "cpu"]
    for flags, want in ((["--single-pod"], {"sp": "16x16"}),
                        (["--multi-pod"], {"mp": "2x16x16"}),
                        ([], {"sp": "16x16", "mp": "2x16x16"})):
        out = tmp_path / "-".join(want)
        assert dryrun.main(cell + flags + ["--out", str(out)]) == 0
        got = {p.name: json.loads(p.read_text()) for p in out.iterdir()}
        assert sorted(got) == sorted(
            f"mamba2-130m__decode_32k__{s}.json" for s in want)
        for s, mesh in want.items():
            row = got[f"mamba2-130m__decode_32k__{s}.json"]
            assert row["status"] == "OK" and row["mesh"] == mesh
            assert row["chips"] == (512 if s == "mp" else 256)
            assert set(row["bytes_per_device"]) == {"args", "out", "temp"}
            assert row["collective_ms"] >= 0
            assert "all-last" in row["notes"] and "InfiniBand" in \
                row["notes"]


@pytest.mark.parametrize("multi_pod", (False, True))
def test_pim_cell_on_the_meshes(multi_pod):
    """The PIM cell's row on a production mesh: the DPU axis split over
    every rank (512 DPUs standing for 2,560: 2 a rank on 16x16, 1 on
    2x16x16), each rank's state padded to its bucket, and one all-reduce
    a K-block of 2 + K x slots int32 over K: 264 / 64 bytes a cycle."""
    row = dryrun.run_pim_cell("cpu", n_dpus=512, multi_pod=multi_pod)
    assert row["status"] == "OK" and row["kind"] == "simulate"
    assert row["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert row["dpus_per_device"] == [1 if multi_pod else 2]
    assert row["collective_bytes_per_cycle"] == {"all-reduce": 264 / 64}
    assert row["bytes_per_device"]["args"] > 0
