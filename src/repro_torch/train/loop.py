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
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, clip_by_global_norm

METRICS = ("loss", "xent", "aux")


def init_train_state(cfg, optimizer: Optimizer, device=None,
                     generator=None) -> Dict:
    """A fresh state: random weights from ``generator`` (default: seeded
    with 0) on ``device`` (None: the card)."""
    model = T.Transformer(cfg, device=device, generator=generator)
    params = dict(model.named_parameters())
    return {"params": model, "opt": optimizer.init(params), "step": 0}


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


def _grad_fn(model, params, mb):
    loss, metrics = model.loss_and_metrics(mb)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return {k: metrics[k].detach() for k in METRICS}, grads


def grads_and_metrics(model, batch, microbatches: int = 1):
    """(metrics, gradients by parameter name) of one step's batch: with
    microbatches, their float32 gradients summed and then divided by
    their count, the metrics averaged the same way."""
    params = dict(model.named_parameters())
    if microbatches == 1:
        return _grad_fn(model, params, batch)
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    metrics = {k: torch.zeros((), dtype=torch.float32, device=model.device)
               for k in METRICS}
    for mb in _split_microbatches(batch, microbatches):
        m, g = _grad_fn(model, params, mb)
        for k, a in grads.items():
            a += g[k].float()
        del g
        metrics = {k: metrics[k] + m[k] for k in METRICS}
    for a in grads.values():
        a /= microbatches
    return {k: v / microbatches for k, v in metrics.items()}, grads


def make_train_step(cfg, optimizer: Optimizer, *, max_grad_norm: float = 1.0,
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``xent``, ``aux`` and ``grad_norm`` as float32 0-d tensors;
    ``batch`` a dict of tensors on the model's device (:func:`to_device`)."""

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        metrics, grads = grads_and_metrics(model, batch, microbatches)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        updates, opt = optimizer.update(grads, state["opt"], params,
                                        state["step"])
        del grads
        with torch.no_grad():
            for k, p in params.items():
                p.copy_((p.float() + updates[k]).to(p.dtype))
        metrics["grad_norm"] = gnorm
        return {"params": model, "opt": opt, "step": state["step"] + 1}, \
            metrics

    return train_step
