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


if __name__ == "__main__":
    jax_main(sys.argv[1])
