"""Tensor and sequence parallelism on the ``model`` axis: the port's
sharded program divides a cell's work over the ``model`` ranks as XLA
partitions the reference's, and each tensor-parallel layer computes what
the JAX package's computes, its gradients ``jax.grad``'s.

* The counts (``launch.cost``, the dry-run's): llama3-smoke's
  ``mini_train`` (64 x 8, one microbatch) and ``mini_prefill`` cells
  counted as ranks 0 and 7 of a fake group of 8 on (pod 2, data 2, model
  2) and (2, 4, 1): each rank's FLOPs and temporaries on the first mesh
  within 10% of the second's, where the JAX package's compiled cells
  (``tests/_torch_dist.py dryrun DIR SHAPE``, XLA's ``cost_analysis`` on
  8 host devices) are within 1.5%.  (1, 1, 8) is printed, not gated: its
  4 heads do not divide the axis, so every rank computes the attention
  whole, as the reference's gating has it.
* Placement: every leaf whose spec names ``model`` is gathered over the
  other axes alone (``gather_plans``), its gradient not summed over
  ``model``; every other leaf's is.
* The flash kernel's GQA groups and the tensor-core routes at each
  rank's head block of every family, at model 2 and 16.
* The layers on 4 gloo ranks, (data 1, model 4)
  (``_torch_dist.torch_tp_worker``), each on its sequence block and its
  weights' ``model`` blocks, against the JAX package's functions on the
  whole arrays, float32: the MLP (column- and row-parallel, on sequence
  blocks and on a sequence the axis does not divide), the
  vocab-parallel embedding and cross-entropy, the sequence all-gather /
  reduce-scatter pair, and mamba2's mixer (``in_proj``'s column block
  re-blocked into the rank's heads).  Outputs and gradients within 1e-5
  of their largest value.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist as td  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_smoke_config  # noqa: E402
from repro_torch.launch import cost, specs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.parallel import api as par  # noqa: E402

KINDS = ("train", "prefill")
SPLIT, FLAT, WIDE = "2x2x2", "2x4x1", "1x1x8"


def _mesh(shape: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(map(int, shape.split("x"))),
                            mesh_dim_names=("pod", "data", "model"))


def _cell(shape: str, kind: str, rank: int):
    name, seq, batch = td.DRYRUN_CELLS[kind]
    cfg = get_smoke_config("llama3-8b").replace(train_microbatches=1)
    with mesh_mod.fake_group(8, rank):
        cell = specs.make_cell(cfg, ShapeSpec(name, kind, seq, batch),
                               _mesh(shape))
        return cost.count(cell["fn"], *cell["args"])


@pytest.fixture(scope="module")
def xla(tmp_path_factory):
    """{mesh: XLA's counts of the train and prefill cells}."""
    out = tmp_path_factory.mktemp("tp_xla")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(Path(td.__file__)),
                               "dryrun", str(out), shape, ",".join(KINDS)],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, env=env, text=True)
             for shape in (SPLIT, FLAT)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    return {shape: json.loads((out / f"xla_mem_{shape}.json").read_text())
            for shape in (SPLIT, FLAT)}


@pytest.mark.parametrize("kind", KINDS)
def test_model_axis_divides_the_work_as_xla_does(xla, kind):
    """Per rank, (2, 2, 2) against (2, 4, 1): the port's FLOPs and
    temporaries within 10%, XLA's FLOPs within 1.5%; before the port kept
    the ``model`` blocks, its FLOPs there were 2.0x."""
    x_split, x_flat = xla[SPLIT][kind], xla[FLAT][kind]
    assert abs(x_split["flops"] / x_flat["flops"] - 1) <= 0.015
    for rank in (0, 7):
        split, flat = _cell(SPLIT, kind, rank), _cell(FLAT, kind, rank)
        assert abs(split.flops / flat.flops - 1) <= 0.10, \
            (kind, rank, split.flops, flat.flops)
        assert abs(split.temp / flat.temp - 1) <= 0.10, \
            (kind, rank, split.temp, flat.temp)
        print(f"{kind} rank {rank}: FLOPs {SPLIT} {split.flops:.0f} "
              f"{FLAT} {flat.flops:.0f} (XLA {x_split['flops']:.0f} / "
              f"{x_flat['flops']:.0f}); temp {split.temp:.0f} / "
              f"{flat.temp:.0f} (XLA {x_split['temp']} / "
              f"{x_flat['temp']})")
    wide = _cell(WIDE, kind, 0)
    print(f"{kind} {WIDE} rank 0 (heads 4 on 8 ranks, not gated): FLOPs "
          f"{wide.flops:.0f}, temp {wide.temp:.0f}")


def _group_ranks(group):
    import torch.distributed as dist
    return [] if group is None else dist.get_process_group_ranks(group)


def test_model_blocks_stay_on_their_rank():
    """``gather_plans`` of llama3-smoke's sharded model on (2, 2, 2): a
    leaf whose spec names ``model`` is gathered to its ``model`` block
    (over ``data`` where its spec names it) and its gradient summed over
    no ``model`` peer; every other leaf is gathered whole and its
    gradient summed over the ``model`` group too."""
    cfg = get_smoke_config("llama3-8b")
    with mesh_mod.fake_group(8, 0):
        mesh = _mesh(SPLIT)
        model = specs.abstract_params(cfg)
        par.shard_module(model, mesh)
        ranks = par.mesh_ranks(mesh)
        peers = set(ranks.members(("model",))) - {ranks.rank}
        n_kept = 0
        for name, p in model.named_parameters():
            spec = model.shardings[name]
            (shape, _, _, rest), _ = model.gather_plans[p]
            summed = set(_group_ranks(rest))
            for d, e in enumerate(spec):
                want = p.shape[d] * (ranks.axes[e] if e not in
                                     (None, "model") else 1)
                assert shape[d] == want, (name, spec, shape)
            if "model" in par.spec_axes(spec):
                n_kept += 1
                assert not summed & peers, name
            else:
                assert peers <= summed, name
        assert n_kept == len([n for n in model.shardings
                              if "model" in model.shardings[n]])
        assert n_kept >= 8


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    torch.multiprocessing.spawn(
        td.torch_tp_worker, args=(td.TP_WORLD, str(out / "store"), str(out)),
        nprocs=td.TP_WORLD, join=True)
    return [np.load(out / f"tp_rank{r}.npz") for r in range(td.TP_WORLD)]


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _seq_blocks(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _held(ranks, name, path, key, whole):
    """Each rank's gradient of the leaf ``path`` against its block of
    ``whole`` (a leaf split over ``model``), or their sum against it."""
    mesh = td.TP_MESH
    spec = par.param_spec(path, whole.shape, mesh)
    if "model" not in par.spec_axes(spec):
        _close(sum(r[f"{name}/grad/{key}"] for r in ranks), whole)
        return
    for m, r in enumerate(ranks):
        where = par.block_slices(whole.shape, spec, mesh,
                                 {"data": 0, "model": m})
        _close(r[f"{name}/grad/{key}"], whole[where])


def _loss_grads(fn, args, c):
    """(y, jax.grad of sum(fn(*args) * c) by argument)."""
    y = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * c),
                     argnums=tuple(range(len(args))))(*args)
    return np.asarray(y), [jax.tree.map(np.asarray, g) for g in grads]


@pytest.mark.parametrize("name", ["mlp", "mlp_whole"])
def test_column_and_row_parallel_mlp(ranks_out, name):
    """``mlp``: the stream's sequence blocks, reduce-scattered back;
    ``mlp_whole``: a sequence of 14 positions, which 4 ranks do not
    split: the stream whole on every rank, the output all-reduced, each
    rank's x gradient a share of jax.grad's."""
    inp = td.tp_inputs()
    cfg = jax_smoke("llama3-8b").replace(dtype="float32")
    n = td.TP_SEQ - (2 if name == "mlp_whole" else 0)
    p = {k: jnp.asarray(inp[f"mlp/{k}"]) for k in ("wi", "wg", "wo")}
    y, (gx, gp) = _loss_grads(lambda x, p: JL.mlp_apply(p, x, cfg),
                              (jnp.asarray(inp["x"][:, :n]), p),
                              inp["c_x"][:, :n])
    if name == "mlp":
        _close(_seq_blocks(ranks_out, "mlp/y"), y)
        _close(_seq_blocks(ranks_out, "mlp/grad/x"), gx)
    else:
        for r in ranks_out:
            _close(r["mlp_whole/y"], y)
        _close(sum(r["mlp_whole/grad/x"] for r in ranks_out), gx)
    for k in ("wi", "wg", "wo"):
        _held(ranks_out, name, f"blocks.0.mlp.{k}", k, gp[k])


def test_vocab_parallel_embedding(ranks_out):
    inp = td.tp_inputs()
    cfg = jax_smoke("llama3-8b").replace(dtype="float32")
    tokens = jnp.asarray(inp["tokens"])
    y, (g,) = _loss_grads(lambda t: JL.embed_apply(t, tokens, cfg),
                          (jnp.asarray(inp["embed/tok"]),), inp["c_x"])
    _close(_seq_blocks(ranks_out, "embed/y"), y)
    _held(ranks_out, "embed", "embed.tok", "tok", g)


def test_vocab_parallel_cross_entropy(ranks_out):
    inp = td.tp_inputs()
    labels = jnp.asarray(inp["labels"])

    def loss(lg):
        s, n = JT._xent_sums(lg, labels)
        return s / n

    lg = jnp.asarray(inp["logits"])
    want, g = float(loss(lg)), np.asarray(jax.grad(loss)(lg))
    v = g.shape[-1] // td.TP_MESH["model"]
    for m, r in enumerate(ranks_out):
        assert abs(float(r["xent/loss"]) - want) <= 1e-6 * abs(want)
        _close(r["xent/grad/logits"], g[..., m * v:(m + 1) * v])


def test_sequence_all_gather_reduce_scatter_pair(ranks_out):
    """Each rank's block all-gathered over the sequence, times its own
    weights c_m, reduce-scattered back: the block of sum_m x c_m."""
    inp = td.tp_inputs()
    c = jnp.asarray(inp["c_seq"])
    y, (g,) = _loss_grads(lambda x: jnp.sum(x[None] * c, axis=0),
                          (jnp.asarray(inp["x"]),), inp["c_x"])
    _close(_seq_blocks(ranks_out, "seq/y"), y)
    _close(_seq_blocks(ranks_out, "seq/grad/x"), g)


def test_ssm_mixer_reblocks_in_proj(ranks_out):
    """mamba2-smoke's mixer: ``in_proj``'s 296 columns split 74 a rank
    (not at a head's edge), ``conv_w``'s 160 channels 40 a rank; each rank
    runs the scan on its 2 of the 8 heads."""
    inp = td.tp_inputs()
    cfg = jax_smoke("mamba2-130m").replace(dtype="float32")
    p = {k[4:]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith("ssm/") and "gate_norm" not in k}
    p["gate_norm"] = {"scale": jnp.asarray(inp["ssm/gate_norm/scale"])}
    y, (gx, gp) = _loss_grads(lambda x, p: JS.ssm_apply_train(p, x, cfg),
                              (jnp.asarray(inp["x"]), p), inp["c_x"])
    _close(_seq_blocks(ranks_out, "ssm/y"), y)
    _close(_seq_blocks(ranks_out, "ssm/grad/x"), gx)
    for k, g in gp.items():
        if k == "gate_norm":
            _held(ranks_out, "ssm", "blocks.0.ssm.gate_norm.scale",
                  "gate_norm/scale", g["scale"])
        else:
            _held(ranks_out, "ssm", f"blocks.0.ssm.{k}", k, g)


@pytest.mark.parametrize("model", (2, 16))
def test_head_blocks_keep_the_tensor_core_routes(model):
    """At every attention family's full width, each rank's q heads and
    the KV heads they read (``attention.kv_of``, first and last rank) form
    a GQA group the flash kernel takes (q heads a multiple of KV heads),
    and bf16 at those widths routes to the tensor-core kernels
    (``flash_attention_sm90.cu``; mamba2-130m's scan to
    ``ssd_scan_tc.cu``): the route depends on the head width alone."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import attention as attn
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
                 "recurrentgemma-9b", "seamless-m4t-large-v2",
                 "llava-next-mistral-7b", "yi-34b", "granite-3-8b",
                 "nemotron-4-15b"):
        cfg = get_config(arch)
        H, KV = cfg.n_heads, cfg.n_kv_heads
        dk = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla
              else cfg.d_head)
        dv = cfg.v_head_dim if cfg.use_mla else cfg.d_head
        assert fops.route(torch.bfloat16, dk, dv) == "sm90", arch
        if cfg.use_mla:      # K and V have a head for every q head
            continue
        h = H // model if H % model == 0 else H
        kv = KV // model if KV % model == 0 else KV
        for q0 in (0, H - h):
            q = torch.empty(1, 1, h, dk, device="meta")
            k = torch.empty(1, 1, kv, dk, device="meta")
            got, _ = attn.kv_of(q, q0, k, k, cfg)
            assert h % got.shape[2] == 0, (arch, model, q0, h,
                                           got.shape)
    mamba = get_config("mamba2-130m")
    assert sops.route(torch.bfloat16, mamba.ssm_state, mamba.ssm_headdim,
                      mamba.ssm_chunk) == "tc"
