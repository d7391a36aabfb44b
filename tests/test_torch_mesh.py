"""Sharded training on a (data 2, model 4) mesh: the port on 8 gloo
ranks (``torch.multiprocessing`` with a ``FileStore`` in a temporary
directory) against the JAX package on 8 host devices
(``tests/_torch_dist.py``, in processes of their own), float32, at the
smoke widths.

* The gradient-carrying collectives (``parallel.collectives``): each
  rank's ``all_gather``, ``reduce_scatter`` and ``all_reduce`` output and
  the gradient of its block against ``shard_map``'s and ``jax.grad``'s
  (within 1e-6).
* Placement: every rank's block of every parameter equals the JAX
  sharded state's ``addressable_shards`` of the same device, bit for bit
  (llama3-smoke; qwen3-moe-smoke, whose experts split over ``model``).
* llama3-smoke's sharded train step (the reference's
  ``scenario_sharded_train_matches``, batch 8 x 32): the loss within 1e-5
  relative of the reference's sharded step and within the scenario's
  1e-3 of its unsharded one; every updated leaf (parameters and AdamW
  moments) within 1e-5 of its largest value.  qwen3-moe-smoke's with 2
  microbatches (each rank's block of each global microbatch: its tokens
  compete for expert capacity as the reference's do) likewise, but for
  the EP scenario's gate of 0.05 against the unsharded (dense) step.
* qwen3-moe-smoke's expert-parallel loss (``scenario_moe_ep_matches_dense``)
  within 1e-5 relative of the reference's and within the scenario's 0.05
  of the dense loss, its aux and xent, and every gradient within 1e-5 of
  its largest value of ``jax.grad``'s; ``moe_ep_plain`` in one process
  (``mesh_context`` of the axis sizes) to the same limits.
* deepseek-v3-smoke's sharded step (Adafactor: statistics over whole
  leaves) against the JAX package's sharded step and the port's own step
  in one process (1e-5).
* ``run_with_restarts`` on the ranks: a failure on one rank restores
  every rank's blocks from the sharded checkpoint, the run ends where the
  clean run does, and the JAX package reads the checkpoint.
* The elastic restore (``scenario_elastic_restore``): llama3-smoke's
  parameters saved on (2, 4) by either package restored onto (4, 2) (each
  rank's block, and the blocks tiling the leaf) and onto (1, 1), by either
  package, bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401

import _torch_dist as td  # noqa: E402
from repro_torch.ckpt import store  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.convert import leaf_key  # noqa: E402
from repro_torch.parallel import api as par  # noqa: E402
from repro_torch.train import loop  # noqa: E402

COORDS = [(d, m) for d in range(td.MESH["data"])
          for m in range(td.MESH["model"])]


def _jax(modes, out):
    """The JAX package's sides ``modes`` of the scenarios, each in a
    process of its own, at once."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    logs = [open(out / f"{mode}.err", "w+") for mode in modes]
    procs = [subprocess.Popen([sys.executable, str(Path(td.__file__)), mode,
                               str(out)], stdout=subprocess.DEVNULL,
                              stderr=log, env=env)
             for mode, log in zip(modes, logs)]
    for proc, log in zip(procs, logs):
        proc.wait(timeout=300)
        log.seek(0)
        assert proc.returncode == 0, log.read()[-3000:]
        log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the reference's arrays, "ranks": each rank's npz,
    "restored": the reference's restores of the port's checkpoints, "dir":
    the run's directory}."""
    out = tmp_path_factory.mktemp("mesh")
    _jax(["mesh", "deep"], out)
    torch.multiprocessing.spawn(
        td.torch_mesh_worker,
        args=(td.MESH_WORLD, str(out / "store"), str(out)),
        nprocs=td.MESH_WORLD, join=True)
    _jax(["mesh-check"], out)
    return {"jax": {**np.load(out / "jax_mesh.npz"),
                    **np.load(out / "jax_deep.npz")},
            "ranks": [np.load(out / f"mesh_rank{r}.npz")
                      for r in range(td.MESH_WORLD)],
            "restored": np.load(out / "jax_restored.npz"), "dir": out}


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind", ["ag", "rs", "ar"])
def test_collectives_match_jax_grad(runs, kind):
    j = runs["jax"]
    for r, (got, coord) in enumerate(zip(runs["ranks"], COORDS)):
        _close(got[f"coll/{kind}/loss"], j[f"coll/{kind}/loss"], 1e-6)
        _close(got[f"coll/{kind}/y"], td.mesh_block(j[f"coll/{kind}/y"],
                                                     coord), 1e-6)
        _close(got[f"coll/{kind}/grad"],
               td.mesh_block(j[f"coll/{kind}/grad"], coord), 1e-6)


@pytest.mark.parametrize("name", ["llama", "qwen_step"])
def test_blocks_are_jax_addressable_shards(runs, name):
    j = runs["jax"]
    n_checked = 0
    for r, got in enumerate(runs["ranks"]):
        for key in got.files:
            if not key.startswith(f"{name}/block/"):
                continue
            path, layer = leaf_key(key[len(f"{name}/block/"):])
            shard = j[f"{name}/shards/{path}"][r]
            np.testing.assert_array_equal(
                got[key], shard if layer < 0 else shard[layer])
            n_checked += 1
    assert n_checked > 8 * 10


def _step_matches(runs, name, gate, leaves="/new/"):
    j = runs["jax"]
    loss = float(j[f"{name}/m/loss"])
    for got in runs["ranks"]:
        assert abs(float(got[f"{name}/m/loss"]) - loss) <= 1e-5 * abs(loss)
        # the reference scenario's own gate against the unsharded step
        assert abs(float(got[f"{name}/m/loss"])
                   - float(j[f"{name}/m_ref/loss"])) < gate
        _close(got[f"{name}/m/grad_norm"], j[f"{name}/m/grad_norm"], 1e-5)
    got = runs["ranks"][0]
    keys = [k for k in j
            if k.startswith(f"{name}/new/") and leaves in k]
    assert any("/opt/m/" in k for k in keys)
    for k in keys:
        _close(got[k], j[k], 1e-5)
    for other in runs["ranks"][1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], got[k])


def test_llama_sharded_step_matches(runs):
    _step_matches(runs, "llama", 1e-3)


def test_qwen3_moe_sharded_step_with_microbatches_matches(runs):
    """Against the unsharded (dense) step, the EP scenario's gate.  The
    leaves held are AdamW's moments, after one step from zero the clipped
    gradient (m = 0.1 g) and its square: the parameters' update
    m^ / (sqrt(v^) + eps) has slope 1 / eps where a gradient element is
    near 0, which turns float32 noise of an expert that saw few tokens
    into 6e-5 of a norm scale's (``tests/_torch_train.py``'s
    ``adamw_trajectory_bound``)."""
    _step_matches(runs, "qwen_step", 0.05, leaves="/opt/")


def test_deepseek_adafactor_sharded_step_matches_one_process(runs):
    """deepseek-v3-smoke's step (MLA, a dense layer, EP with 2
    microbatches, Adafactor, whose row, column and RMS statistics span
    each whole leaf) on the (2, 4) mesh against the port's own step in one
    process (``moe_ep_plain``) from the same state: loss, norm, parameters
    and Adafactor's state within 1e-5 of their largest values."""
    for got in runs["ranks"]:
        one = float(got["deep/one/loss"])
        assert abs(float(got["deep/m/loss"]) - one) <= 1e-5 * abs(one)
        _close(got["deep/m/grad_norm"], got["deep/one/grad_norm"], 1e-5)
        keys = [k[len("deep/one/"):] for k in got.files
                if k.startswith("deep/one/") and "/" in k[9:]]
        assert any("/vr" in k for k in keys)
        for k in keys:
            _close(got[f"deep/new/{k}"], got[f"deep/one/{k}"], 1e-5)


def test_deepseek_adafactor_sharded_step_matches_jax(runs):
    """The same sharded step against the JAX package's sharded step on 8
    host devices: the loss within 1e-5 relative, the norm, every updated
    parameter and Adafactor's vr, vc and v within 1e-5 of their largest
    values (the statistics reduced over the mesh)."""
    j = runs["jax"]
    loss = float(j["deep/m/loss"])
    keys = [k for k in j if k.startswith("deep/new/")]
    assert any(k.endswith("/vr") for k in keys)
    assert any(k.endswith("/vc") for k in keys)
    for got in runs["ranks"]:
        assert abs(float(got["deep/m/loss"]) - loss) <= 1e-5 * abs(loss)
        _close(got["deep/m/grad_norm"], j["deep/m/grad_norm"], 1e-5)
        for k in keys:
            _close(got[k], j[k], 1e-5)


def test_run_with_restarts_restores_every_rank_blockwise(runs):
    """``run_with_restarts`` on the 8 ranks (llama3-smoke, sharded,
    checkpointed every step through the store's sharded path): a failure
    on one rank after step 1 restores every rank, and the run ends bit for
    bit where the clean run does; the JAX package reads its last
    checkpoint whole, bit for bit the gathered state."""
    for got in runs["ranks"]:
        np.testing.assert_array_equal(got["restart_stats/0"], [2, 0, 0])
        np.testing.assert_array_equal(got["restart_stats/1"], [2, 1, 1])
        keys = [k for k in got.files if k.startswith("restart/1/")]
        assert any("/opt/m/" in k for k in keys)
        for k in keys:
            np.testing.assert_array_equal(
                got[k], got[k.replace("restart/1/", "restart/0/")])
    got = runs["ranks"][0]
    restored = [k for k in runs["restored"].files
                if k.startswith("restart/")]
    assert len(restored) == len(keys)
    for k in restored:
        np.testing.assert_array_equal(runs["restored"][k],
                                      got[k.replace("restart/",
                                                    "restart/1/")])


def test_qwen3_moe_ep_loss_and_grads_match(runs):
    j = runs["jax"]
    loss = float(j["qwen/ep_loss"])
    assert abs(loss - float(j["qwen/dense_loss"])) < 0.05
    keys = [k for k in j if k.startswith("qwen/grad/")]
    assert any(k.endswith("moe/wi") for k in keys)
    for got in runs["ranks"]:
        assert abs(float(got["qwen/ep_m/loss"]) - loss) <= 1e-5 * abs(loss)
        for m in ("aux", "xent"):
            _close(got[f"qwen/ep_m/{m}"], j[f"qwen/ep_m/{m}"], 1e-5)
        for k in keys:
            _close(got[k], j[k], 1e-5)


def test_moe_ep_plain_matches_jax_in_one_process(runs):
    """``mesh_context`` of the axis sizes: the model in one process takes
    ``moe_ep_plain`` (the EP group's function, not the dense one)."""
    j = runs["jax"]
    cfg = get_smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    model = convert.params_from_jax(td.nested(j, "qwen/init/"), cfg, "cpu")
    ds = SyntheticLM(cfg, DataConfig(td.SEQ, td.ROWS, cfg.vocab_size))
    batch = loop.to_device(ds.batch_at(0), "cpu")
    with par.mesh_context(td.MESH):
        metrics, grads = loop.grads_and_metrics(model, batch)
    loss = float(j["qwen/ep_loss"])
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * abs(loss)
    with torch.no_grad():
        dense, _ = model.loss_and_metrics(batch)
    assert abs(float(dense) - float(j["qwen/dense_loss"])) <= 1e-5 * abs(
        float(dense))
    got = td.flat_tree(convert.jax_tree(grads), "qwen/grad/")
    for k in got:
        _close(got[k], j[k], 1e-5)


def _specs(whole, mesh):
    """{leaf path: spec} of a JAX parameter tree on ``mesh``."""
    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    return dict(walk(par.param_shardings(whole, mesh), ""))


def test_elastic_restore_across_packages(runs):
    """Saved on (2, 4) by either package: restored onto (4, 2) by the
    port's ranks (each rank's block, and the blocks together the whole
    leaf) and by the reference, and onto (1, 1) by both; bit for bit."""
    j = runs["jax"]
    whole = td.nested(j, "llama/init/params/")
    flat = td.flat_tree(whole)
    coords_b = [(d, m) for d in range(td.MESH_B["data"])
                for m in range(td.MESH_B["model"])]
    for src in ("jax_ckpt", "port_ckpt"):
        seen = {k: np.zeros(v.shape, bool) for k, v in flat.items()}
        for got, (d, m) in zip(runs["ranks"], coords_b):
            coord = {"data": d, "model": m}
            for k, spec in _specs(whole, td.MESH_B).items():
                where = par.block_slices(flat[k].shape, spec, td.MESH_B,
                                         coord)
                np.testing.assert_array_equal(
                    got[f"restored_b/{src}/{k}"], flat[k][where])
                seen[k][where] = True
        assert all(s.all() for s in seen.values())
        restored, step = store.restore(str(runs["dir"] / src),
                                       {"params": whole})
        assert step == td.CKPT_STEP
        for k, v in td.flat_tree(restored["params"]).items():
            np.testing.assert_array_equal(v, flat[k])
    for name in ("b", "one"):
        for k, v in flat.items():
            np.testing.assert_array_equal(runs["restored"][f"{name}/{k}"],
                                          v)
