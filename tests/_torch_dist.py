"""The multi-rank scenarios of tests/test_torch_parallel.py, on both
packages, each writing what it computed to an npz.

* ``python tests/_torch_dist.py DIR``: writes ``DIR/jax.npz``, the JAX
  package on
  ``N_DEV`` host devices (``--xla_force_host_platform_device_count``, set
  before JAX is imported, so this runs in a process of its own):
  ``compressed_psum``, ``make_dp_compressed_step`` on the reference's
  ``scenario_compressed_dp`` problem (its state before every step and its
  losses) and ``pipeline_apply`` with
  ``jax.grad`` of a loss of its outputs, over a mesh of ``WORLD``
  devices; and ``make_elastic_mesh``'s shape for 1-16 devices.
* :func:`torch_worker`: rank ``rank`` of the port's run of the same
  scenarios on a gloo process group of ``WORLD`` ranks (a ``FileStore``),
  writing ``DIR/rank<r>.npz``; ``torch.multiprocessing.spawn`` starts it
  after the JAX run: besides its own 60 steps, it takes each step from
  ``jax.npz``'s state before it.

The inputs are drawn with numpy from fixed seeds (:func:`inputs`), so
both packages see the same numbers.  Importing this module imports
neither JAX nor the JAX package.

The sharded-training scenarios of tests/test_torch_mesh.py, on a
(data 2, model 4) mesh (:data:`MESH`), float32, at the smoke widths:

* ``python tests/_torch_dist.py mesh DIR`` (and ``deep DIR`` beside it,
  deepseek-v3-smoke's sharded step with Adafactor, ``DIR/jax_deep.npz``):
  writes ``DIR/jax_mesh.npz``,
  the JAX package on 8 host devices: the gradient-carrying collectives
  (``all_gather``, ``psum_scatter``, ``psum`` in ``shard_map``, each
  forward and ``jax.grad``); llama3-smoke's train step, unsharded and
  sharded (the reference's ``scenario_sharded_train_matches``: its
  initial state, the placed state's ``addressable_shards``, the loss and
  the updated state); qwen3-moe-smoke's loss dense and expert-parallel
  with ``jax.grad`` of the latter (``scenario_moe_ep_matches_dense``) and
  its sharded train step with 2 microbatches; and llama3-smoke's
  parameters saved from the (2, 4) mesh (``DIR/jax_ckpt``,
  ``scenario_elastic_restore``).
* :func:`torch_mesh_worker`: rank ``rank`` of the port's run of the same
  on 8 gloo ranks (``DIR/mesh_rank<r>.npz``): each rank's outputs,
  gradients and blocks; deepseek-v3-smoke's step (Adafactor) sharded and
  in one process; the JAX checkpoint restored onto (4, 2); the port's own
  (2, 4) save (``DIR/port_ckpt``) and its restore onto (4, 2).
* ``python tests/_torch_dist.py mesh-check DIR``: the JAX package
  restores the port's checkpoint onto (4, 2) and (1, 1)
  (``DIR/jax_restored.npz``).

The other families' sharded training (tests/test_torch_mesh_families.py),
on the same mesh: ``python tests/_torch_dist.py families DIR`` writes
``DIR/jax_families.npz``, the JAX package's loss and ``jax.grad`` of each
of :data:`FAMILY_ARCHS` with its parameters and batch placed on 8 host
devices; :func:`torch_families_worker` the port's on 8 gloo ranks.

Sharded serving (tests/test_torch_serve_mesh.py), on the same (data 2,
model 4) mesh, float32, at the smoke widths of :data:`SERVE_ARCHS`:

* ``python tests/_torch_dist.py serve DIR``: writes ``DIR/jax_serve.npz``,
  the JAX package on 8 host devices under ``mesh_context`` (the MoE layer
  on its expert-parallel branch): each family's initial parameters, its
  prefill of :func:`serve_inputs`' batch placed by ``batch_sharding`` and
  the parameters by ``param_shardings``, then :data:`DECODE_STEPS` steps
  of ``jax.jit(T.decode_step, in_shardings=(params, cache_sharding,
  batch), out_shardings=(None, cache_sharding))``: every step's logits and
  the last cache's ``addressable_shards``; llama3-smoke's decode steps
  from an empty cache of :data:`FRESH_CAPACITY` positions likewise.  The
  dense, moe and vlm prefill caches get :data:`DECODE_STEPS` more
  positions first (``tests/_torch_lm.py``'s ``pad_cache``): at a full
  cache the write index is clamped onto its last position, and there the
  reference's sharded step disagrees with its own unsharded one (ROADMAP
  §3).
* :func:`torch_serve_worker`: rank ``rank`` of the port's run of the same
  on 8 gloo ranks (``DIR/serve_rank<r>.npz``): its rows' logits and its
  cache blocks (the same room given by the sharded prefill's
  ``capacity``).

The PIM engine with its DPU axis split over :data:`WORLD` gloo ranks
(tests/test_torch_pim_shard.py): :func:`torch_pim_worker` runs
:data:`PIM_SCENARIOS` (:func:`pim_launch`) through
``compile_cache.run_sharded`` (VA through ``PIMSystem(group=...)``, the
workload's own run) and writes ``DIR/pim_rank<r>.npz`` (the whole final
state of each) and ``DIR/pim_rank<r>.json`` (VA's ``KernelReport`` and
``Timeline``, each scenario's replays).

The dry-run's cells on a small mesh (tests/test_torch_dryrun_mesh.py):
``python tests/_torch_dist.py dryrun DIR [SHAPE [KINDS]]`` writes
``DIR/xla_mem.json``, the JAX package's ``specs.make_cell`` of
llama3-smoke's (one microbatch) :data:`DRYRUN_CELLS` lowered and compiled
on a (pod 2, data 2, model 2) mesh of 8 host devices (the reference's
``scenario_dryrun_cell_small_mesh``), each one's ``memory_analysis`` and
``cost_analysis`` FLOPs (``SHAPE``, e.g. ``2x4x1``: on that mesh instead,
``DIR/xla_mem_2x4x1.json``; tests/test_torch_tensor_parallel.py).

The training CLI on 4 ranks (tests/test_torch_scripts_launch_train_mesh.py):
``python tests/_torch_dist.py cli DIR ARGS...`` runs the reference's on 4
host devices (:func:`jax_cli_main`), :func:`torch_cli_worker` the port's
on 4 gloo ranks from the reference's initial state.
"""
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: ranks (devices) of the scenarios
WORLD = 4
#: host devices of the JAX run (make_elastic_mesh up to 16)
N_DEV = 16
DP_STEPS = 60
N_MICRO, MB, D = 8, 4, 16
#: the compressed_psum case: leaves of sizes with a ragged last block
GRAD_SHAPES = {"a": (1000,), "b": (3, 100), "c": (256,)}


def inputs() -> dict:
    """Every scenario's inputs, from fixed seeds."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16,)).astype(np.float32)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    y = X @ w_true + 0.01 * rng.normal(size=64).astype(np.float32)
    r = np.random.default_rng(1)
    out = {"X": X, "y": y.astype(np.float32),
           "ws": (r.normal(size=(WORLD, D, D)) / np.sqrt(D)).astype(
               np.float32),
           "xm": r.normal(size=(N_MICRO, MB, D)).astype(np.float32)}
    for k, shape in GRAD_SHAPES.items():
        out[f"g_{k}"] = r.normal(size=(WORLD,) + shape).astype(np.float32)
        out[f"r_{k}"] = (1e-3 * r.normal(size=(WORLD,) + shape)).astype(
            np.float32)
    out["g_c"][1] = 0.0              # a zero block on rank 1
    return out


def stage_np(w, x):
    return np.tanh(x @ w)


def torch_worker(rank: int, world: int, init_file: str, out_dir: str):
    """Rank ``rank`` of the port's scenarios (see the module docstring)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import api as par
    from repro_torch.parallel.compress import (compressed_psum,
                                               init_residuals,
                                               make_dp_compressed_step)
    from repro_torch.parallel.pipeline import pipeline_apply

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        inp = inputs()
        out = {}
        grads = {k: torch.from_numpy(inp[f"g_{k}"][rank])
                 for k in GRAD_SHAPES}
        res = {k: torch.from_numpy(inp[f"r_{k}"][rank]) for k in GRAD_SHAPES}
        mean, newres = compressed_psum(grads, res)
        for k in GRAD_SHAPES:
            out[f"mean_{k}"] = mean[k].numpy()
            out[f"res_{k}"] = newres[k].numpy()

        X, y = torch.from_numpy(inp["X"]), torch.from_numpy(inp["y"])

        def loss_fn(p, batch):
            xb, yb = batch
            return ((xb @ p["w"] - yb) ** 2).mean()

        opt = adamw(lambda s: torch.tensor(0.05), weight_decay=0.0)
        step = make_dp_compressed_step(loss_fn, opt)
        params = {"w": torch.zeros(16)}
        o = opt.init(params)
        r = init_residuals(params)
        losses = []
        for i in range(DP_STEPS):
            params, o, r, loss = step(params, o, r, (X, y), i)
            losses.append(float(loss))
        out["free_losses"] = np.array(losses, np.float32)
        # each step from the JAX run's state before it
        ref = np.load(Path(out_dir) / "jax.npz")
        got = {k: [] for k in ("loss", "w", "m", "v", "res")}
        for i in range(DP_STEPS):
            p, o, r, loss = step(
                {"w": torch.tensor(ref["dp_w"][i])},
                {"m": {"w": torch.tensor(ref["dp_m"][i])},
                 "v": {"w": torch.tensor(ref["dp_v"][i])}},
                {"w": torch.tensor(ref["dp_res"][i][rank])}, (X, y), i)
            for k, t in (("loss", loss), ("w", p["w"]), ("m", o["m"]["w"]),
                         ("v", o["v"]["w"]), ("res", r["w"])):
                got[k].append(t.numpy())
        for k, v in got.items():
            out[f"step_{k}"] = np.stack(v)

        w = torch.tensor(inp["ws"][rank], requires_grad=True)
        xm = torch.tensor(inp["xm"], requires_grad=True)
        got = pipeline_apply(lambda w_, x_: torch.tanh(x_ @ w_), w, xm)
        (got ** 2).sum().backward()
        out["pipe_out"] = got.detach().numpy()
        out["pipe_gw"] = w.grad.numpy()
        out["pipe_gx"] = xm.grad.numpy()

        out["elastic"] = np.array(list(par.mesh_axes(
            mesh.make_elastic_mesh(device_type="cpu")).values()))
        out["pipe_mesh"] = np.array(list(par.mesh_axes(
            mesh.make_pipe_mesh(world, device_type="cpu")).values()))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def jax_main(out_dir: str):
    """The JAX package's run of the scenarios (see the module docstring)."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={N_DEV}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_elastic_mesh
    from repro.optim import adamw
    from repro.parallel.compress import (compressed_psum, init_residuals,
                                         make_dp_compressed_step)
    from repro.parallel.pipeline import pipeline_apply

    def mesh(axis):
        return jax.make_mesh((WORLD,), (axis,), devices=jax.devices()[:WORLD],
                             axis_types=(jax.sharding.AxisType.Auto,))

    inp = inputs()
    out = {}
    dmesh = mesh("data")
    g = {k: jnp.asarray(inp[f"g_{k}"]) for k in GRAD_SHAPES}
    r = {k: jnp.asarray(inp[f"r_{k}"]) for k in GRAD_SHAPES}

    def body(g, r):
        g = {k: v[0] for k, v in g.items()}
        r = {k: v[0] for k, v in r.items()}
        m, nr = compressed_psum(g, r, "data")
        return ({k: v[None] for k, v in m.items()},
                {k: v[None] for k, v in nr.items()})

    mean, newres = jax.jit(jax.shard_map(
        body, mesh=dmesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))(g, r)
    for k in GRAD_SHAPES:
        out[f"mean_{k}"] = np.asarray(mean[k])
        out[f"res_{k}"] = np.asarray(newres[k])

    X, y = jnp.asarray(inp["X"]), jnp.asarray(inp["y"])

    def loss_fn(w, batch):
        xb, yb = batch
        return jnp.mean((xb @ w - yb) ** 2)

    opt = adamw(lambda s: 0.05, weight_decay=0.0)
    w = jnp.zeros(16)
    o = opt.init(w)
    res = init_residuals(w)
    step = make_dp_compressed_step(loss_fn, opt, dmesh)
    states = {k: [] for k in ("w", "m", "v", "res")}
    losses = []
    for i in range(DP_STEPS + 1):
        for k, t in (("w", w), ("m", o["m"]), ("v", o["v"])):
            states[k].append(np.asarray(t))
        # each device keeps its own residuals (the replicated out-spec
        # holds every device's buffer; np.asarray would read device 0's);
        # the first are one array of zeros
        per = np.stack([np.asarray(sh.data) for sh in sorted(
            res.addressable_shards, key=lambda s: s.device.id)])
        states["res"].append(np.broadcast_to(per, (WORLD,) + per.shape[1:]))
        if i < DP_STEPS:
            w, o, res, loss = step(w, o, res, (X, y), jnp.int32(i))
            losses.append(float(loss))
    out["dp_losses"] = np.array(losses, np.float32)
    for k, v in states.items():
        out[f"dp_{k}"] = np.stack(v)

    pmesh = mesh("pipe")
    ws, xm = jnp.asarray(inp["ws"]), jnp.asarray(inp["xm"])

    def stage_fn(w_, x_):
        return jnp.tanh(x_ @ w_)

    def loss(ws_, xm_):
        return jnp.sum(pipeline_apply(stage_fn, ws_, xm_, pmesh) ** 2)

    out["pipe_out"] = np.asarray(pipeline_apply(stage_fn, ws, xm, pmesh))
    gw, gx = jax.grad(loss, argnums=(0, 1))(ws, xm)
    out["pipe_gw"] = np.asarray(gw)
    out["pipe_gx"] = np.asarray(gx)

    out["elastic"] = np.array([list(make_elastic_mesh(n).shape.values())
                               for n in range(1, N_DEV + 1)])
    np.savez(Path(out_dir) / "jax.npz", **out)


# ---------------------------------------------------------------------------
# Sharded training on a (data, model) mesh
# ---------------------------------------------------------------------------

#: the mesh of the sharded scenarios, and the one of the elastic restore
MESH, MESH_B = {"data": 2, "model": 4}, {"data": 4, "model": 2}
MESH_WORLD = 8
#: the reference scenarios' batch: 8 rows of 32 tokens
ROWS, SEQ = 8, 32
#: the collectives' per-rank block
BLOCK = (4, 6)
CKPT_STEP = 3
#: steps of the run_with_restarts scenario
RESTART_STEPS = 2


def collective_inputs() -> dict:
    """x and the loss weights of each collective, as global arrays
    whose (data, model) blocks are the ranks' (a rank's block of the
    all-gather's weights is its block of the gathered shape)."""
    r = np.random.default_rng(7)
    rows, cols = MESH["data"] * BLOCK[0], MESH["model"] * BLOCK[1]
    return {"x": r.normal(size=(rows, cols)).astype(np.float32),
            "c_ag": r.normal(size=(rows, cols * MESH["model"])).astype(
                np.float32),
            "c_rs": r.normal(size=(rows // MESH["data"], cols)).astype(
                np.float32),
            "c_ar": r.normal(size=(rows, cols)).astype(np.float32)}


def mesh_block(a: np.ndarray, coord) -> np.ndarray:
    """The (data, model) block of a 2-D global array at ``coord``."""
    r, c = a.shape[0] // MESH["data"], a.shape[1] // MESH["model"]
    d, m = coord
    return a[d * r:(d + 1) * r, m * c:(m + 1) * c]


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {prefix + "a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def nested(npz, prefix: str) -> dict:
    """:func:`flat_tree`'s inverse for the keys under ``prefix``."""
    tree = {}
    for key in npz:
        if not key.startswith(prefix):
            continue
        node = tree
        *head, last = key[len(prefix):].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = npz[key]
    return tree


def jax_mesh_main(out_dir: str, part: str = "mesh"):
    """The JAX package's side of the sharded scenarios (see the module
    docstring): ``part`` "mesh" all but deepseek-v3-smoke's step, "deep"
    that step alone (``DIR/jax_deep.npz``), so that the two can run at
    once."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={MESH_WORLD}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.ckpt import store
    from repro.configs.base import get_smoke_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import transformer as T
    from repro.optim import get_optimizer, warmup_cosine
    from repro.parallel import api as par
    from repro.train import loop as train_loop

    auto = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh(tuple(MESH.values()), tuple(MESH),
                         axis_types=auto)
    out = {}

    def shards(tree, prefix):
        """Every leaf's addressable shards, stacked by device id."""
        for path, leaf in par._flatten_with_paths(tree)[0]:
            got = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
            out[f"{prefix}{path}"] = np.stack([np.asarray(s.data)
                                               for s in got])

    def batch_of(cfg):
        ds = SyntheticLM(cfg, DataConfig(SEQ, ROWS, cfg.vocab_size))
        return {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}

    def sharded_step(cfg, name, microbatches, unsharded=True):
        opt = get_optimizer(cfg.optimizer, warmup_cosine(1e-3))
        state = train_loop.init_train_state(cfg, opt, jax.random.PRNGKey(0))
        step = train_loop.make_train_step(cfg, opt,
                                          microbatches=microbatches)
        batch = batch_of(cfg)
        out.update(flat_tree(jax.tree.map(np.asarray, state),
                             f"{name}/init/"))
        if unsharded:
            _, m_ref = jax.jit(step)(jax.tree.map(jnp.copy, state), batch)
            out[f"{name}/m_ref/loss"] = np.asarray(m_ref["loss"])
        with par.mesh_context(mesh):
            st = jax.device_put(state, par.param_shardings(
                jax.eval_shape(lambda: state), mesh))
            shards(st["params"], f"{name}/shards/")
            b = jax.device_put(batch, par.batch_sharding(
                jax.eval_shape(lambda: batch), mesh))
            new, m = jax.jit(step)(st, b)
        out.update(flat_tree(jax.tree.map(np.asarray, new), f"{name}/new/"))
        for k, v in m.items():
            out[f"{name}/m/{k}"] = np.asarray(v)
        return state

    if part == "deep":
        deep = get_smoke_config("deepseek-v3-671b").replace(dtype="float32")
        sharded_step(deep, "deep", 1, unsharded=False)
        np.savez(Path(out_dir) / "jax_deep.npz", **out)
        return

    # the collectives: each rank's output and jax.grad's block of x
    ci = collective_inputs()
    xy = P("data", "model")
    bodies = {
        "ag": lambda x: jax.lax.all_gather(x, "model", axis=1, tiled=True),
        "rs": lambda x: jax.lax.psum_scatter(x, "data", scatter_dimension=0,
                                             tiled=True),
        "ar": lambda x: jax.lax.psum(x, "model")}
    for kind, body in bodies.items():
        def f(x, c, body=body):
            def inner(x, c):
                y = body(x)
                return jax.lax.psum(jnp.sum(y * c), ("data", "model")), y
            return jax.shard_map(inner, mesh=mesh, in_specs=(xy, xy),
                                 out_specs=(P(), xy), check_vma=False)(x, c)
        x, c = jnp.asarray(ci["x"]), jnp.asarray(ci[f"c_{kind}"])
        loss, y = jax.jit(f)(x, c)
        out[f"coll/{kind}/loss"] = np.asarray(loss)
        out[f"coll/{kind}/y"] = np.asarray(y)
        out[f"coll/{kind}/grad"] = np.asarray(jax.jit(jax.grad(
            lambda x, c: f(x, c)[0]))(x, c))

    llama = get_smoke_config("llama3-8b").replace(dtype="float32")
    state = sharded_step(llama, "llama", 1)
    qwen = get_smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    sharded_step(qwen, "qwen_step", 2)
    # qwen3-moe's loss: dense, and expert-parallel with its gradient
    params = T.init_params(qwen, jax.random.PRNGKey(0))
    batch = batch_of(qwen)
    out.update(flat_tree(jax.tree.map(np.asarray, params), "qwen/init/"))
    out["qwen/dense_loss"] = np.asarray(T.loss_and_metrics(params, batch,
                                                           qwen)[0])
    with par.mesh_context(mesh):
        p_sh = jax.device_put(params, par.param_shardings(
            jax.eval_shape(lambda: params), mesh))
        b_sh = jax.device_put(batch, par.batch_sharding(
            jax.eval_shape(lambda: batch), mesh))
        (loss, metrics), g = jax.jit(jax.value_and_grad(
            lambda p, b: T.loss_and_metrics(p, b, qwen), has_aux=True))(
                p_sh, b_sh)
    out["qwen/ep_loss"] = np.asarray(loss)
    for k, v in metrics.items():
        out[f"qwen/ep_m/{k}"] = np.asarray(v)
    out.update(flat_tree(jax.tree.map(np.asarray, g), "qwen/grad/"))

    # llama3-smoke's parameters saved from the (2, 4) mesh
    p_a = jax.device_put(state["params"], par.param_shardings(
        jax.eval_shape(lambda: state["params"]), mesh))
    store.save(str(Path(out_dir) / "jax_ckpt"), CKPT_STEP, {"params": p_a})
    np.savez(Path(out_dir) / "jax_mesh.npz", **out)


def jax_mesh_check(out_dir: str):
    """The JAX package restores the port's (2, 4) checkpoint onto (4, 2)
    and (1, 1): ``DIR/jax_restored.npz`` holds both, flattened."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={MESH_WORLD}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    from repro.ckpt import store
    from repro.parallel import api as par

    ref = np.load(Path(out_dir) / "jax_mesh.npz")
    like = {"params": nested(ref, "llama/init/params/")}
    mesh_b = jax.make_mesh(tuple(MESH_B.values()), tuple(MESH_B),
                           axis_types=(jax.sharding.AxisType.Auto,) * 2)
    d = str(Path(out_dir) / "port_ckpt")
    out = {}
    for name, kw in (("b", {"shardings": {"params": par.param_shardings(
            jax.eval_shape(lambda: like["params"]), mesh_b)}}),
                     ("one", {})):
        restored, step = store.restore(d, like, **kw)
        assert step == CKPT_STEP
        out.update(flat_tree(jax.tree.map(np.asarray, restored["params"]),
                             f"{name}/"))
    # the sharded run_with_restarts' last checkpoint, whole
    r0 = np.load(Path(out_dir) / "mesh_rank0.npz")
    like = {"state": nested(r0, "restart/1/"), "data": {"step": 0}}
    restored, step = store.restore(str(Path(out_dir) / "restart_1"), like)
    assert step == RESTART_STEPS and restored["data"]["step"] == step
    out.update(flat_tree(jax.tree.map(np.asarray, restored["state"]),
                         "restart/"))
    np.savez(Path(out_dir) / "jax_restored.npz", **out)


def torch_mesh_worker(rank: int, world: int, init_file: str, out_dir: str):
    """Rank ``rank`` of the port's sharded scenarios (see the module
    docstring)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import store
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import convert
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import loop

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", tuple(MESH.values()),
                                mesh_dim_names=tuple(MESH))
        ranks = par.mesh_ranks(mesh)
        coord = (ranks.coord["data"], ranks.coord["model"])
        ref = {**np.load(Path(out_dir) / "jax_mesh.npz"),
               **np.load(Path(out_dir) / "jax_deep.npz")}
        out = {}

        ci = collective_inputs()
        world_group = ranks.group(ranks.names)
        for kind, body in (
                ("ag", lambda x: coll.all_gather(x, 1,
                                                 ranks.group(["model"]))),
                ("rs", lambda x: coll.reduce_scatter(x, 0,
                                                     ranks.group(["data"]))),
                ("ar", lambda x: coll.all_reduce(x, ranks.group(["model"])))):
            x = torch.tensor(mesh_block(ci["x"], coord), requires_grad=True)
            c = torch.tensor(mesh_block(ci[f"c_{kind}"], coord))
            y = body(x)
            loss = coll.all_reduce((y * c).sum(), world_group)
            loss.backward(torch.tensor(1.0 / world))
            out[f"coll/{kind}/loss"] = loss.detach().numpy()
            out[f"coll/{kind}/y"] = y.detach().numpy()
            out[f"coll/{kind}/grad"] = x.grad.numpy()

        def batch_of(cfg):
            ds = SyntheticLM(cfg, DataConfig(SEQ, ROWS, cfg.vocab_size))
            return loop.to_device(ds.batch_at(0), "cpu")

        def restarted_run(cfg, fail):
            from repro_torch.runtime.coordinator import (WorkerFailure,
                                                         run_with_restarts)
            opt = get_optimizer(cfg.optimizer, warmup_cosine(1e-3))
            sref = {"state": loop.shard_train_state(
                from_jax(cfg, "llama", opt), mesh)}
            step = loop.make_train_step(cfg, opt)
            data = SyntheticLM(cfg, DataConfig(SEQ, ROWS, cfg.vocab_size))
            failed = []

            def one_step(i):
                sref["state"], _ = step(sref["state"], par.batch_rows(
                    loop.to_device(data.batch_at(i), "cpu"), mesh))
                data.step = i + 1
                if fail and i == 1 and rank == 3 and not failed:
                    failed.append(i)
                    raise WorkerFailure("rank 3 lost")

            stats = run_with_restarts(
                one_step, state_ref=sref, data=data, n_steps=RESTART_STEPS,
                ckpt_dir=str(Path(out_dir) / f"restart_{int(fail)}"),
                ckpt_every=1)
            return stats, sref["state"]

        def whole(model, tensors):
            """Blocks keyed by parameter name, gathered, as the JAX
            tree."""
            return convert.jax_tree({n: par.unshard(
                t.detach(), model.shardings[n], mesh)
                for n, t in tensors.items()})

        def gathered(state):
            """A sharded train state whole, in the JAX layout (numpy)."""
            model, opt = state["params"], state["opt"]
            return {"params": whole(model, dict(model.named_parameters())),
                    "opt": ({k: whole(model, opt[k]) for k in ("m", "v")}
                            if set(opt) == {"m", "v"}
                            else convert.opt_state_to_jax(opt)),
                    "step": np.asarray(state["step"], np.int32)}

        def from_jax(cfg, name, opt):
            return convert.train_state_from_jax(
                nested(ref, f"{name}/init/"),
                loop.init_train_state(cfg, opt, device="cpu"))

        def sharded_step(cfg, name, microbatches):
            opt = get_optimizer(cfg.optimizer, warmup_cosine(1e-3))
            state = loop.shard_train_state(from_jax(cfg, name, opt), mesh)
            model = state["params"]
            for n, p in model.named_parameters():
                out[f"{name}/block/{n}"] = p.detach().numpy().copy()
            step = loop.make_train_step(cfg, opt, microbatches=microbatches)
            state, m = step(state, par.batch_rows(batch_of(cfg), mesh))
            for k, v in m.items():
                out[f"{name}/m/{k}"] = v.numpy()
            out.update(flat_tree(gathered(state), f"{name}/new/"))

        llama = get_smoke_config("llama3-8b").replace(dtype="float32")
        sharded_step(llama, "llama", 1)
        qwen = get_smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
        sharded_step(qwen, "qwen_step", 2)

        # deepseek-v3-smoke (MLA, a dense layer, EP, Adafactor: its
        # statistics over whole leaves) from the reference's state, sharded
        # and in one process under mesh_context (moe_ep_plain)
        deep = get_smoke_config("deepseek-v3-671b").replace(dtype="float32")
        sharded_step(deep, "deep", 1)
        opt = get_optimizer(deep.optimizer, warmup_cosine(1e-3))
        step = loop.make_train_step(deep, opt)
        with par.mesh_context(MESH):
            one, m_one = step(from_jax(deep, "deep", opt), batch_of(deep))
        out["deep/one/loss"] = m_one["loss"].numpy()
        out["deep/one/grad_norm"] = m_one["grad_norm"].numpy()
        out.update(flat_tree(convert.train_state_to_jax(one), "deep/one/"))

        # run_with_restarts on the ranks: llama3-smoke's sharded state
        # checkpointed every step, run clean and with rank 3 failing once
        # after step 1 (its collectives done), so that every rank restores
        # step 1's checkpoint (each its blocks) and takes step 1 again
        for fail in (False, True):
            stats, st = restarted_run(llama, fail)
            out[f"restart_stats/{int(fail)}"] = np.asarray(
                [stats[k] for k in ("completed", "failures", "restores")])
            out.update(flat_tree(gathered(st), f"restart/{int(fail)}/"))

        q = convert.params_from_jax(nested(ref, "qwen/init/"), qwen, "cpu")
        par.shard_module(q, mesh, torch.float32)
        metrics, grads = loop.grads_and_metrics(
            q, par.batch_rows(batch_of(qwen), mesh))
        for k, v in metrics.items():
            out[f"qwen/ep_m/{k}"] = v.numpy()
        out.update(flat_tree(whole(q, grads), "qwen/grad/"))

        # the elastic restore: the reference's (2, 4) save onto (4, 2)
        # here; the port's own (2, 4) save, and it onto (4, 2)
        mesh_b = init_device_mesh("cpu", tuple(MESH_B.values()),
                                  mesh_dim_names=tuple(MESH_B))
        params = nested(ref, "llama/init/params/")
        specs_b = par.param_shardings(params, mesh_b)
        model = convert.params_from_jax(params, llama, "cpu")
        par.shard_module(model, mesh, torch.float32)
        store.save(str(Path(out_dir) / "port_ckpt"), CKPT_STEP,
                   {"params": convert.jax_tree(
                       dict(model.named_parameters()), host=False)},
                   shardings={"params": convert.jax_specs(model)}, mesh=mesh)
        for src in ("jax_ckpt", "port_ckpt"):
            restored, step = store.restore(
                str(Path(out_dir) / src), {"params": params},
                shardings={"params": specs_b}, mesh=mesh_b)
            assert step == CKPT_STEP
            out.update(flat_tree(restored["params"], f"restored_b/{src}/"))
        np.savez(Path(out_dir) / f"mesh_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Sharded training of the other families
# ---------------------------------------------------------------------------

#: the families tests/test_torch_mesh.py does not train (ssm, hybrid,
#: encdec, vlm)
FAMILY_ARCHS = ("mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2",
                "llava-next-mistral-7b")


def jax_families_main(out_dir: str):
    """The JAX package on 8 host devices: each of :data:`FAMILY_ARCHS`'
    initial parameters (``PRNGKey(0)``), and its loss and ``jax.grad`` on
    :data:`MESH` (parameters by ``param_shardings``, the batch by
    ``batch_sharding``): ``DIR/jax_families.npz``."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={MESH_WORLD}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_smoke_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import transformer as T
    from repro.parallel import api as par

    mesh = jax.make_mesh(tuple(MESH.values()), tuple(MESH),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        params = T.init_params(cfg, jax.random.PRNGKey(0))
        ds = SyntheticLM(cfg, DataConfig(SEQ, ROWS, cfg.vocab_size))
        batch = {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}
        out.update(flat_tree(jax.tree.map(np.asarray, params),
                             f"{arch}/init/"))
        with par.mesh_context(mesh):
            p_sh = jax.device_put(params, par.param_shardings(
                jax.eval_shape(lambda: params), mesh))
            b_sh = jax.device_put(batch, par.batch_sharding(
                jax.eval_shape(lambda: batch), mesh))
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, b: T.loss_and_metrics(p, b, cfg), has_aux=True))(
                    p_sh, b_sh)
        out[f"{arch}/loss"] = np.asarray(loss)
        out.update(flat_tree(jax.tree.map(np.asarray, g), f"{arch}/grad/"))
    np.savez(Path(out_dir) / "jax_families.npz", **out)


def torch_families_worker(rank: int, world: int, init_file: str,
                          out_dir: str):
    """Rank ``rank`` of the same on 8 gloo ranks from the reference's
    parameters (``DIR/families_rank<r>.npz``: the loss, and on rank 0 the
    gradients gathered whole in the JAX layout)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import convert
    from repro_torch.parallel import api as par
    from repro_torch.train import loop

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", tuple(MESH.values()),
                                mesh_dim_names=tuple(MESH))
        ref = np.load(Path(out_dir) / "jax_families.npz")
        out = {}
        for arch in FAMILY_ARCHS:
            cfg = get_smoke_config(arch).replace(dtype="float32")
            model = convert.params_from_jax(nested(ref, f"{arch}/init/"),
                                            cfg, "cpu")
            par.shard_module(model, mesh, torch.float32)
            ds = SyntheticLM(cfg, DataConfig(SEQ, ROWS, cfg.vocab_size))
            batch = loop.to_device(ds.batch_at(0), "cpu")
            metrics, grads = loop.grads_and_metrics(
                model, par.batch_rows(batch, mesh))
            out[f"{arch}/loss"] = metrics["loss"].numpy()
            whole = convert.jax_tree({n: par.unshard(
                g, model.shardings[n], mesh) for n, g in grads.items()})
            if rank == 0:
                out.update(flat_tree(whole, f"{arch}/grad/"))
        np.savez(Path(out_dir) / f"families_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

#: one architecture of each family the serving test holds
SERVE_ARCHS = ("llama3-8b", "mamba2-130m", "qwen3-moe-30b-a3b",
               "recurrentgemma-9b", "seamless-m4t-large-v2",
               "llava-next-mistral-7b")
SERVE_ROWS, SERVE_SEQ, DECODE_STEPS = 8, 32, 4
#: llama3-smoke's empty cache: 40 positions, 10 a model rank
FRESH_CAPACITY = 40


def serve_inputs(cfg) -> dict:
    """The prompt batch of ``cfg``'s family (numpy, fixed seed) and the
    decode steps' tokens (``"steps"``, (DECODE_STEPS, rows))."""
    r = np.random.default_rng(11)
    B, S = SERVE_ROWS, SERVE_SEQ
    out = {}
    if cfg.family == "encdec":
        out["frames"] = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        Pn = cfg.n_frontend_tokens
        out["tokens"] = r.integers(0, cfg.vocab_size, (B, S - Pn),
                                   dtype=np.int32)
        out["patches"] = r.normal(size=(B, Pn, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = r.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    out["steps"] = r.integers(0, cfg.vocab_size, (DECODE_STEPS, B),
                              dtype=np.int32)
    return out


def jax_serve_main(out_dir: str):
    """The JAX package's side of the sharded serving scenarios (see the
    module docstring)."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={MESH_WORLD}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp

    from _torch_lm import pad_cache
    from repro.configs.base import get_smoke_config
    from repro.models import transformer as T
    from repro.parallel import api as par

    mesh = jax.make_mesh(tuple(MESH.values()), tuple(MESH),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}

    def shape_of(tree):
        return jax.eval_shape(lambda: tree)

    def decode(name, cfg, p_sh, psh, cache, steps):
        cache_sh = par.cache_sharding(shape_of(cache), mesh)
        tok_sh = par.batch_sharding(shape_of(jnp.asarray(steps[0])), mesh)
        step = jax.jit(lambda p, c, t: T.decode_step(p, c, t, cfg),
                       in_shardings=(psh, cache_sh, tok_sh),
                       out_shardings=(None, cache_sh))
        cache = jax.device_put(cache, cache_sh)
        for i, tok in enumerate(steps):
            logits, cache = step(p_sh, cache, jnp.asarray(tok))
            out[f"{name}/logits/{i + 1}"] = np.asarray(logits)
        for k, leaf in cache.items():
            if k == "pos":
                continue
            got = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
            out[f"{name}/cache/{k}"] = np.stack([np.asarray(s.data)
                                                 for s in got])

    with par.mesh_context(mesh):
        for arch in SERVE_ARCHS:
            cfg = get_smoke_config(arch).replace(dtype="float32")
            params = T.init_params(cfg, jax.random.PRNGKey(0))
            out.update(flat_tree(jax.tree.map(np.asarray, params),
                                 f"{arch}/init/"))
            inp = serve_inputs(cfg)
            batch = {k: jnp.asarray(v) for k, v in inp.items()
                     if k != "steps"}
            psh = par.param_shardings(shape_of(params), mesh)
            p_sh = jax.device_put(params, psh)
            b_sh = jax.device_put(batch, par.batch_sharding(
                shape_of(batch), mesh))
            logits, cache = jax.jit(lambda p, b: T.prefill(p, b, cfg))(
                p_sh, b_sh)
            out[f"{arch}/logits/0"] = np.asarray(logits)
            cache = pad_cache(cache, DECODE_STEPS, cfg.family)
            decode(arch, cfg, p_sh, psh, cache, inp["steps"])
            if arch == "llama3-8b":
                decode("fresh", cfg, p_sh, psh, T.init_cache(
                    cfg, SERVE_ROWS, FRESH_CAPACITY), inp["steps"])
    np.savez(Path(out_dir) / "jax_serve.npz", **out)


def torch_serve_worker(rank: int, world: int, init_file: str, out_dir: str):
    """Rank ``rank`` of the port's sharded serving scenarios (see the
    module docstring)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", tuple(MESH.values()),
                                mesh_dim_names=tuple(MESH))
        ref = np.load(Path(out_dir) / "jax_serve.npz")
        out = {}

        def rows(a):
            t = torch.from_numpy(np.asarray(a))
            return par.batch_rows(t.long() if not t.is_floating_point()
                                  else t, mesh)

        def decode(name, model, cache, steps):
            for i, tok in enumerate(steps):
                logits, cache = model.decode_step(cache, rows(tok))
                out[f"{name}/logits/{i + 1}"] = logits.numpy()
            for k in cache["specs"]:
                out[f"{name}/cache/{k}"] = cache[k].numpy()

        for arch in SERVE_ARCHS:
            cfg = get_smoke_config(arch).replace(dtype="float32")
            model = convert.params_from_jax(nested(ref, f"{arch}/init/"),
                                            cfg, "cpu")
            par.shard_module(model, mesh, T.cdtype(cfg))
            inp = serve_inputs(cfg)
            batch = {k: rows(v) for k, v in inp.items() if k != "steps"}
            # pad_cache's room (none for encdec's self cache) by prefill
            logits, cache = model.prefill(
                batch, global_batch=SERVE_ROWS,
                capacity=None if cfg.family == "encdec"
                else SERVE_SEQ + DECODE_STEPS)
            out[f"{arch}/logits/0"] = logits.numpy()
            decode(arch, model, cache, inp["steps"])
            if arch == "llama3-8b":
                decode("fresh", model, model.init_cache(
                    SERVE_ROWS, FRESH_CAPACITY), inp["steps"])
        np.savez(Path(out_dir) / f"serve_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The dry-run on a small mesh
# ---------------------------------------------------------------------------

#: the small mesh of the dry-run scenario
SMALL_MESH = {"pod": 2, "data": 2, "model": 2}
#: kind -> (shape name, sequence, batch) of the cells counted on it
DRYRUN_CELLS = {"train": ("mini_train", 64, 8),
                "prefill": ("mini_prefill", 64, 8),
                "decode": ("mini_decode", 64, 8)}


def jax_dryrun_main(out_dir: str, shape: str = None, kinds: str = None):
    """The JAX package's side of the small-mesh cells (see the module
    docstring): ``DIR/xla_mem.json``, or ``DIR/xla_mem_<shape>.json`` on
    another mesh of 8 devices (``shape`` "pxdxm": pod, data, model) for
    the cells ``kinds`` (comma-separated; default all)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(ROOT / "src"))
    import json

    import jax

    import repro.configs.base as cb
    from repro.launch import specs
    from repro.parallel import api as par

    cfg = cb.get_smoke_config("llama3-8b").replace(train_microbatches=1)
    sizes = (tuple(map(int, shape.split("x"))) if shape
             else tuple(SMALL_MESH.values()))
    mesh = jax.make_mesh(sizes, tuple(SMALL_MESH),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    out = {}
    for kind, (name, seq, batch) in DRYRUN_CELLS.items():
        if kinds and kind not in kinds.split(","):
            continue
        cb.SHAPES[name] = cb.ShapeSpec(name, kind, seq, batch)
        with par.mesh_context(mesh):
            cell = specs.make_cell(cfg, name, mesh)
            compiled = jax.jit(cell["fn"],
                               in_shardings=cell["in_shardings"],
                               out_shardings=cell.get("out_shardings"),
                               donate_argnums=cell["donate_argnums"]).lower(
                *cell["args"]).compile()
        mem = compiled.memory_analysis()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out[kind] = {"args": int(mem.argument_size_in_bytes),
                     "out": int(mem.output_size_in_bytes),
                     "temp": int(mem.temp_size_in_bytes),
                     "flops": float(cost.get("flops", 0.0))}
    name = f"xla_mem_{shape}.json" if shape else "xla_mem.json"
    (Path(out_dir) / name).write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# Tensor and sequence parallelism, layer by layer
# ---------------------------------------------------------------------------

#: the mesh of the per-layer scenarios, and their batch
TP_MESH = {"data": 1, "model": 4}
TP_WORLD = 4
TP_ROWS, TP_SEQ = 2, 16


def tp_inputs() -> dict:
    """The per-layer scenarios' inputs (numpy, fixed seed): llama3-smoke's
    MLP weights, embedding table, a residual stream, logits and labels,
    mamba2-smoke's mixer's weights, and each scenario's loss weights
    (``c_*``; ``c_seq`` one per ``model`` rank)."""
    r = np.random.default_rng(29)
    D, F, V = 64, 128, 256
    B, S = TP_ROWS, TP_SEQ

    def w(*shape):
        return (r.normal(size=shape) / np.sqrt(shape[-2] if len(shape) > 1
                                               else 1)).astype(np.float32)

    f32 = np.float32
    out = {"x": r.normal(size=(B, S, D)).astype(f32),
           "mlp/wi": w(D, F), "mlp/wg": w(D, F), "mlp/wo": w(F, D),
           "embed/tok": r.normal(size=(V, D)).astype(f32),
           "tokens": r.integers(0, V, (B, S)),
           "logits": (3 * r.normal(size=(B, S, V))).astype(f32),
           "labels": r.integers(-1, V, (B, S)),
           "c_x": r.normal(size=(B, S, D)).astype(f32),
           "c_seq": r.normal(size=(TP_MESH["model"], B, S, D)).astype(f32)}
    d_in, G, N, H, K = 128, 1, 16, 8, 4
    conv_dim = d_in + 2 * G * N
    out.update({"ssm/in_proj": w(D, 2 * d_in + 2 * G * N + H),
                "ssm/conv_w": (0.3 * r.normal(size=(K, conv_dim))).astype(f32),
                "ssm/conv_b": (0.1 * r.normal(size=(conv_dim,))).astype(f32),
                "ssm/A_log": np.log(np.linspace(1, 16, H)).astype(f32),
                "ssm/D_skip": (1 + 0.1 * r.normal(size=(H,))).astype(f32),
                "ssm/dt_bias": (0.1 * r.normal(size=(H,)) - 3).astype(f32),
                "ssm/gate_norm/scale": (0.1 * r.normal(size=(d_in,))
                                        ).astype(f32),
                "ssm/out_proj": w(d_in, D)})
    return out


def torch_tp_worker(rank: int, world: int, init_file: str, out_dir: str):
    """Rank ``rank`` of the per-layer scenarios on a :data:`TP_MESH` of
    gloo ranks (tests/test_torch_tensor_parallel.py): each layer on the
    rank's blocks (its sequence block of the stream, its ``model`` block
    of each weight), a loss ``sum(y * c)`` summed over the ranks and its
    backward seeded with ``1 / world`` (the sharded train step's); writes
    ``DIR/tp_rank<r>.npz``: each output block and each input block's
    gradient."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import layers, ssm
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", tuple(TP_MESH.values()),
                                mesh_dim_names=tuple(TP_MESH))
        ranks = par.mesh_ranks(mesh)
        m = ranks.coord["model"]
        everyone = ranks.group(ranks.names)
        inp = {k: torch.from_numpy(v) for k, v in tp_inputs().items()}
        llama = get_smoke_config("llama3-8b").replace(dtype="float32")
        mamba = get_smoke_config("mamba2-130m").replace(dtype="float32")
        out = {}

        def block(name, path, layer=True):
            """This rank's block of the leaf ``name`` (``path`` in the
            port's parameter names), a leaf tensor taking a gradient."""
            t = inp[name]
            spec = par.param_spec(path, t.shape, mesh) if layer else \
                (None,) * t.ndim
            return par.shard(t, spec, mesh).requires_grad_(True)

        def seq_block(t):
            return t.narrow(1, m * TP_SEQ // 4, TP_SEQ // 4).clone()

        def run(name, fn, leaves):
            """``fn()`` -> y (this rank's block); the loss's backward; y
            and the leaves' gradients written under ``name``."""
            y, c = fn()
            loss = coll.all_reduce((y * c).sum(), everyone)
            loss.backward(torch.tensor(1.0 / world))
            out[f"{name}/y"] = y.detach().numpy()
            for k, t in leaves.items():
                out[f"{name}/grad/{k}"] = t.grad.numpy()

        with par.mesh_context(mesh), par.sequence(TP_SEQ):
            x = seq_block(inp["x"]).requires_grad_(True)
            p = {k: block(f"mlp/{k}", f"blocks.0.mlp.{k}")
                 for k in ("wi", "wg", "wo")}
            run("mlp", lambda: (layers.mlp_apply(p, x, llama),
                                seq_block(inp["c_x"])), {"x": x, **p})

            # a sequence the axis does not divide: the stream whole on
            # every rank, the row-parallel product all-reduced; the loss
            # is then whole on every rank too, each holding a share of
            # its cotangent (the 1 / world seed)
            n = TP_SEQ - 2
            with par.sequence(n):
                xw = inp["x"][:, :n].clone().requires_grad_(True)
                pw = {k: block(f"mlp/{k}", f"blocks.0.mlp.{k}")
                      for k in ("wi", "wg", "wo")}
                y = layers.mlp_apply(pw, xw, llama)
                (y * inp["c_x"][:, :n]).sum().backward(
                    torch.tensor(1.0 / world))
                out["mlp_whole/y"] = y.detach().numpy()
                for k, t in {"x": xw, **pw}.items():
                    out[f"mlp_whole/grad/{k}"] = t.grad.numpy()

            tok = block("embed/tok", "embed.tok")
            run("embed", lambda: (layers.embed_apply(tok, inp["tokens"],
                                                     llama),
                                  seq_block(inp["c_x"])), {"tok": tok})

            v_loc = 256 // 4
            lg = inp["logits"][..., m * v_loc:(m + 1) * v_loc].clone()
            lg.requires_grad_(True)
            s, n = T._xent_sums(lg, inp["labels"], m * v_loc)
            (s / n).backward(torch.tensor(1.0 / world))
            out["xent/loss"] = (s / n).detach().numpy()
            out["xent/grad/logits"] = lg.grad.numpy()

            x = seq_block(inp["x"]).requires_grad_(True)
            c = torch.from_numpy(np.ascontiguousarray(
                inp["c_seq"][m].numpy()))
            run("seq", lambda: (coll.reduce_scatter(
                coll.all_gather(x, 1, ranks.group(("model",))) * c, 1,
                ranks.group(("model",))), seq_block(inp["c_x"])),
                {"x": x})

            x = seq_block(inp["x"]).requires_grad_(True)
            sp = {k: block(f"ssm/{k}", f"blocks.0.ssm.{k}")
                  for k in ("in_proj", "conv_w", "conv_b", "A_log",
                            "D_skip", "dt_bias", "out_proj")}
            sp["gate_norm"] = {"scale": block("ssm/gate_norm/scale",
                                              "blocks.0.ssm.gate_norm.scale")}
            leaves = {k: v for k, v in sp.items() if k != "gate_norm"}
            leaves["gate_norm/scale"] = sp["gate_norm"]["scale"]
            run("ssm", lambda: (ssm.ssm_apply_train(sp, x, mamba),
                                seq_block(inp["c_x"])), {"x": x, **leaves})
        np.savez(Path(out_dir) / f"tp_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The PIM engine's DPUs split over ranks
# ---------------------------------------------------------------------------

#: 8 DPUs, 2 a rank: VA at scale 0.02 (16 tasklets), the tail-clip DMA
#: case, cross_dpu's program with its DMA sizes by DPU pair, and the same
#: stopped at max_cycles (``cases``' cross_pair launches)
PIM_SCENARIOS = ("va", "tail", "xdpu", "xdpu_max")
PIM_DPUS = 8
VA_SCALE = 0.02


def pim_launch(name: str):
    """``(cfg, binary, wram, mram, T)`` of a scenario (the port's; ``xdpu``
    and ``xdpu_max`` are ``cases``' ``cross_pair`` launches)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.cycle_step import cases

    if name == "tail":
        return cases.launch("dma_tail_clip", n_dpus=PIM_DPUS)
    if name in ("xdpu", "xdpu_max"):
        return cases.launch({"xdpu": "cross_pair",
                             "xdpu_max": "cross_pair_max_cycles"}[name])
    return cases.va(PIM_DPUS, scale=VA_SCALE)


def torch_pim_worker(rank: int, world: int, init_file: str, out_dir: str):
    """Rank ``rank`` of the sharded PIM scenarios (see the module
    docstring)."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import json

    import torch
    import torch.distributed as dist

    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        out, meta = {}, {"replays": {}, "catch_ups": {}}
        group = dist.group.WORLD
        for name in PIM_SCENARIOS[1:]:
            cfg, binary, wram, mram, T = pim_launch(name)
            shard = compile_cache.Shard(cfg, binary, wram, mram, T, group,
                                        "cpu")
            block = {k: v.numpy()[:shard.hi - shard.lo]
                     for k, v in shard.run().items()}
            meta["replays"][name] = shard.replays
            meta["catch_ups"][name] = shard.catch_ups
            for k, v in compile_cache.gather_blocks(
                    block, cfg.n_dpus, group).items():
                out[f"{name}/{k}"] = v
        cfg = DPUConfig(n_dpus=PIM_DPUS, n_tasklets=16, mram_bytes=1 << 14)
        system = PIMSystem(cfg, device="cpu", group=group)
        s0 = compile_cache.stats()
        st, rep = wl.get("VA").run(system, n_threads=16, scale=VA_SCALE)
        meta["va_votes"] = compile_cache.stats()["votes"] - s0["votes"]
        for k, v in st.items():
            out[f"va/{k}"] = v
        meta["report"] = dataclasses.asdict(rep)
        meta["timeline"] = [list(e) for e in system.timeline.events]
        np.savez(Path(out_dir) / f"pim_rank{rank}.npz", **out)
        (Path(out_dir) / f"pim_rank{rank}.json").write_text(
            json.dumps(meta, default=lambda a: np.asarray(a).tolist()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The training CLI on several ranks
# ---------------------------------------------------------------------------

#: ranks (host devices) of the CLI runs: make_elastic_mesh gives (1, 4)
CLI_WORLD = 4


def _cli_arch(argv) -> str:
    return argv[argv.index("--arch") + 1] if "--arch" in argv \
        else "llama3-8b"


def jax_cli_main(out_dir: str, argv):
    """``python -m repro.launch.train`` on ``CLI_WORLD`` host devices:
    ``DIR/cli_jax.txt`` its output, ``DIR/cli_init.npz`` its initial
    train state (``init_train_state`` at ``PRNGKey(0)``)."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={CLI_WORLD}"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import jax

    import script_runs
    from repro.configs.base import get_smoke_config
    from repro.launch import train
    from repro.optim import get_optimizer, warmup_cosine
    from repro.train import loop

    cfg = get_smoke_config(_cli_arch(argv)).replace(dtype="float32")
    steps = int(argv[argv.index("--steps") + 1])
    opt = get_optimizer(cfg.optimizer, warmup_cosine(1e-3, warmup=10,
                                                     total=steps))
    state = loop.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    np.savez(Path(out_dir) / "cli_init.npz",
             **flat_tree(jax.tree.map(np.asarray, state)))
    rc, text = script_runs.run_main(train, list(argv) + [
        "--ckpt-dir", str(Path(out_dir) / "ckpt_jax")])
    assert rc == 0, text
    (Path(out_dir) / "cli_jax.txt").write_text(text)


def torch_cli_worker(rank: int, world: int, init_file: str, out_dir: str,
                     argv):
    """Rank ``rank`` of ``python -m repro_torch.launch.train --device
    cpu`` on a gloo group of ``world`` ranks, its fresh train state given
    the reference's (``DIR/cli_init.npz``); rank 0's output to
    ``DIR/cli_torch.txt``."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch
    import torch.distributed as dist

    import script_runs
    from repro_torch.launch import train
    from repro_torch.models.convert import train_state_from_jax
    from repro_torch.train import loop

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        init = nested(np.load(Path(out_dir) / "cli_init.npz"), "")
        fresh = loop.init_train_state
        loop.init_train_state = lambda cfg, opt, device=None: \
            train_state_from_jax(init, fresh(cfg, opt, device=device))
        rc, text = script_runs.run_main(train, list(argv) + [
            "--device", "cpu", "--ckpt-dir", str(Path(out_dir) / "ckpt_pt")])
        assert rc == 0, text
        if rank == 0:
            (Path(out_dir) / "cli_torch.txt").write_text(text)
        else:
            assert text == "", text
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        jax_cli_main(sys.argv[2], sys.argv[3:])
    elif sys.argv[1] in ("mesh", "deep"):
        jax_mesh_main(sys.argv[2], sys.argv[1])
    elif sys.argv[1] == "mesh-check":
        jax_mesh_check(sys.argv[2])
    elif sys.argv[1] == "serve":
        jax_serve_main(sys.argv[2])
    elif sys.argv[1] == "families":
        jax_families_main(sys.argv[2])
    elif sys.argv[1] == "dryrun":
        jax_dryrun_main(*sys.argv[2:5])
    else:
        jax_main(sys.argv[1])
