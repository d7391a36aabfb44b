"""Training step builder: grads (+ optional microbatch accumulation),
global-norm clipping, optimizer update.

The counterpart of ``repro.train.loop``.  A train state is ``{"params": a
Transformer, "opt": the optimizer's state, "step": int}``; ``train_step``
computes what the JAX package's does (the same loss, the microbatches'
float32 gradients summed and divided by their count, the metrics
averaged the same way, clipping, the update added as ``(p.float() +
u).to(p.dtype)``) and writes the new parameters into the model in place
(the JAX package returns a new tree).  On the card the attention and SSD
layers run their hand-written forward and backward kernels
(``kernels/flash_attention``, ``kernels/ssd_scan``); on the CPU their
plain versions.  ``models.convert.train_state_to_jax`` /
``train_state_from_jax`` carry a state to and from the JAX package's
layout (checkpoints).

Sharded (:func:`shard_train_state` on a ``DeviceMesh`` of the process
group's ranks): each rank keeps its
block of every parameter and optimizer moment (``parallel.api
.param_shardings``) and is given its rows of the batch
(``parallel.api.batch_rows``).  Microbatches are cut as the reference
cuts them: the global batch is split into k and each rank takes its
block of each, so each microbatch's tokens compete for expert capacity
as in the reference.  Each rank seeds its backward with ``1 / world``
(``shard_map``'s division of a replicated output's cotangent); the
weights' gathers (over the axes each spec names but ``model``, whose
block each rank keeps and computes with: ``parallel.api.shard_module``)
sum each gradient back into its blocks over those axes, and over the
axes the spec leaves replicated, ``model`` among them for a leaf that
every ``model`` rank holds whole (``parallel.collectives.unshard``); a
kept ``model`` block's gradient is its own, not summed over ``model``.
The blocks and specs are the reference's, so checkpoints keep their
layout.  Clipping and Adafactor's statistics count every element of a
leaf once.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.parallel import api as par

METRICS = ("loss", "xent", "aux")
#: top-level trees a sharded step gathers once for all its microbatches
#: (by their gather plans: over ``data``, each rank's ``model`` block
#: kept; their gradients summed over the microbatches, then reduced into
#: the blocks), as a gather of a loop invariant is taken out of the
#: reference's microbatch scan; each layer's weights are gathered where
#: each microbatch uses them
HOISTED = ("embed", "lm_head", "final_norm", "enc_norm")


def init_train_state(cfg, optimizer: Optimizer, device=None,
                     generator=None) -> Dict:
    """A fresh state: random weights from ``generator`` (default: seeded
    with 0) on ``device`` (None: the card)."""
    model = T.Transformer(cfg, device=device, generator=generator)
    params = dict(model.named_parameters())
    return {"params": model, "opt": optimizer.init(params), "step": 0}


def _sharding(model) -> Dict:
    """The optimizer's update's and clipping's keywords for ``model``'s
    layout."""
    if model.mesh is None:
        return {}
    return {"shardings": model.shardings, "mesh": model.mesh}


def shard_train_state(state: Dict, mesh) -> Dict:
    """``state`` (whole on every rank) with its model and its optimizer
    moments kept as this rank's blocks on ``mesh`` (the moments take their
    parameter's spec, as the reference's ``param_shardings`` gives them;
    Adafactor's factored statistics stay whole, replicated)."""
    model = state["params"]
    par.shard_module(model, mesh, T.cdtype(model.cfg))
    opt = state["opt"]
    if set(opt) == {"m", "v"}:
        opt = {k: {n: par.shard(t, model.shardings[n], mesh)
                   for n, t in opt[k].items()} for k in ("m", "v")}
    return {"params": model, "opt": opt, "step": state["step"]}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.pipeline``) as tensors on
    ``device``: integer arrays as int64, float arrays as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def _split_microbatches(batch, k):
    def sp(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"a batch of {b} does not split into {k} "
                             "microbatches")
        return x.reshape(k, b // k, *x.shape[1:])

    split = {name: sp(x) for name, x in batch.items()}
    return [{name: x[i] for name, x in split.items()} for i in range(k)]


def _microbatches(model, batch, k):
    """The k microbatches of this rank: of the global batch's k, its
    rows of each (sharded: the data-parallel ranks' rows gathered, cut,
    and each cut's rows taken, as the reference reshapes the global batch
    to (k, b / k) and splits dimension 1)."""
    mesh = model.mesh
    if mesh is None or k == 1:
        return [batch] if k == 1 else _split_microbatches(batch, k)
    dp = par.dp_size(mesh)
    rows = (par.dp_axes(mesh) or None,)
    whole = {n: par.unshard(x, rows + (None,) * (x.ndim - 1), mesh)
             for n, x in batch.items()}
    mbs = _split_microbatches(whole, k)
    if next(iter(mbs[0].values())).shape[0] % dp:
        raise ValueError(f"a microbatch of the global batch does not split "
                         f"over {dp} data-parallel ranks")
    return [par.batch_rows(mb, mesh) for mb in mbs]


def _grad_fn(model, params, mb):
    loss, metrics = model.loss_and_metrics(mb)
    seed = None
    if model.mesh is not None:
        seed = torch.full_like(loss, 1.0 / par.mesh_ranks(model.mesh).world)
    grads = torch.autograd.grad(loss, list(params.values()), seed,
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return {k: metrics[k].detach() for k in METRICS}, grads


def grads_and_metrics(model, batch, microbatches: int = 1):
    """(metrics, gradients by parameter name) of one step's batch: with
    microbatches, their float32 gradients summed and then divided by
    their count, the metrics averaged the same way.  Sharded, ``batch``
    is this rank's rows and the gradients its blocks."""
    params = dict(model.named_parameters())
    if microbatches == 1:
        return _grad_fn(model, params, batch)
    hoisted = {} if model.mesh is None else par.hoist(
        model, [n for n in params if n.split(".")[0] in HOISTED])
    inputs = {n: hoisted.get(p, p) for n, p in params.items()}
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in inputs.items()}
    metrics = {k: torch.zeros((), dtype=torch.float32, device=model.device)
               for k in METRICS}
    model.hoisted = hoisted
    try:
        for mb in _microbatches(model, batch, microbatches):
            m, g = _grad_fn(model, inputs, mb)
            for k, a in grads.items():
                a += g[k].float()
            del g
            metrics = {k: metrics[k] + m[k] for k in METRICS}
    finally:
        model.hoisted = None
    for n, p in params.items():
        if p in hoisted:
            grads[n] = par.reduce_hoisted(model, p, grads[n])
    for a in grads.values():
        a /= microbatches
    return {k: v / microbatches for k, v in metrics.items()}, grads


def make_train_step(cfg, optimizer: Optimizer, *, max_grad_norm: float = 1.0,
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``xent``, ``aux`` and ``grad_norm`` as float32 0-d tensors;
    ``batch`` a dict of tensors on the model's device (:func:`to_device`;
    sharded: this rank's rows, ``parallel.api.batch_rows``)."""

    def train_step(state, batch):
        metrics, grads = grads_and_metrics(state["params"], batch,
                                           microbatches)
        state, metrics["grad_norm"] = apply_gradients(
            state, grads, optimizer, max_grad_norm)
        return state, metrics

    return train_step


def apply_gradients(state, grads, optimizer: Optimizer,
                    max_grad_norm: float = 1.0):
    """(the next state, the gradients' global norm before clipping): the
    gradients clipped, the optimizer's update added to the parameters in
    place as ``(p.float() + u).to(p.dtype)``."""
    model = state["params"]
    params = dict(model.named_parameters())
    kw = _sharding(model)
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, **kw)
    updates, opt = optimizer.update(grads, state["opt"], params,
                                    state["step"], **kw)
    del grads
    with torch.no_grad():
        for k, p in params.items():
            p.copy_((p.float() + updates[k]).to(p.dtype))
    return {"params": model, "opt": opt, "step": state["step"] + 1}, gnorm
