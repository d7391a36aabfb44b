"""Optimizers (optax-like minimal interface, no external deps).

The counterpart of ``repro.optim.optimizers``, in plain torch on the
parameters' own device (the JAX package computes them with jnp, outside
any Pallas kernel):

* ``adamw``      — AdamW with f32 state, elementwise, one ``m`` and one
  ``v`` per parameter tensor of the port, updated in place (the JAX
  package returns new arrays; in place, a step holds one copy of the
  moments, not two);
* ``adafactor``  — factored second moment for >=2-d *leaves* of the JAX
  parameter tree (rank-1 row/col statistics);
* ``warmup_cosine`` schedule + global-norm clipping.

Parameters, gradients and updates are dicts keyed by the port's
parameter names (``Transformer.named_parameters()``: one tensor per
layer, ``blocks.3.attn.wq``).  The JAX package stacks a layer's tensors
into one leaf (``blocks/attn/wq`` is ``(L, D, H Dh)``), and Adafactor
works per leaf: a stacked ``(L, D)`` norm scale is factored (its column
statistic runs over the layers) and the update's RMS clip is taken over
all layers of a leaf together.  So ``adafactor`` stacks each leaf's
per-layer tensors (:func:`leaf_groups`), updates the stacked leaf as JAX
does, keeps its state in JAX's stacked layout keyed by the leaf's path,
and splits the update back.  The schedule's arithmetic is float32 as
jnp's (``b1 ** step`` of a float32 step, the learning rate of
``step + 1``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

from repro_torch.models.convert import leaf_groups, leaf_key

f32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, new_state)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=f32, device=device)


def warmup_cosine(peak_lr: float, warmup: int = 200, total: int = 10_000,
                  floor: float = 0.1):
    """``lr(step)``: a float32 0-d tensor on ``step``'s device (a Python
    int step gives one on the CPU)."""
    def lr(step):
        step = _f32(step, getattr(step, "device", None))
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(
            _f32(math.pi, step.device) * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _stacked(tensors: Dict[str, torch.Tensor], names: List[str]):
    """A leaf's tensors as the JAX leaf: stacked when the leaf is."""
    if leaf_key(names[0])[1] < 0:
        return tensors[names[0]]
    return torch.stack([tensors[n] for n in names])


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping): the squares summed per JAX leaf, then over the
    leaves in the tree's order, in float32."""
    total = 0
    for names in leaf_groups(grads).values():
        s = sum(grads[n].float().square().sum() for n in names)
        total = total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gn


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    def init(params):
        return {"m": {k: torch.zeros_like(p, dtype=f32)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=f32)
                      for k, p in params.items()}}

    def update(grads, state, params, step):
        dev = next(iter(params.values())).device
        step = _f32(step + 1, dev)
        lr = lr_fn(step)
        b1c = 1 - torch.pow(_f32(b1, dev), step)
        b2c = 1 - torch.pow(_f32(b2, dev), step)
        upds = {}
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps) \
                + weight_decay * p.detach().float()
            upds[k] = (-lr * u).to(p.dtype)
        return upds, state

    return Optimizer(init, update)


def adafactor(lr_fn, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0):
    """Factored Adafactor (no first moment) — O(rows+cols) state for
    matrices instead of O(rows*cols).  State: JAX leaf path -> ``{"vr",
    "vc"}`` (factored) or ``{"v"}``, in the JAX leaf's stacked shape."""

    def init(params):
        state = {}
        for path, names in leaf_groups(params).items():
            p = _stacked(params, names)
            if p.ndim >= 2:
                state[path] = {
                    "vr": torch.zeros(p.shape[:-1], dtype=f32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=f32, device=p.device)}
            else:
                state[path] = {"v": torch.zeros_like(p, dtype=f32)}
        return state

    def update(grads, state, params, step):
        dev = next(iter(params.values())).device
        step = _f32(step + 1, dev)
        lr = lr_fn(step)
        beta = 1.0 - torch.pow(step + 1.0, -decay)
        upds, new_state = {}, {}
        for path, names in leaf_groups(params).items():
            s = state[path]
            g = _stacked(grads, names).float()
            g2 = g.square() + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                u = g * torch.rsqrt(r)[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
                new_state[path] = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                new_state[path] = {"v": v}
            rms = torch.sqrt(u.square().mean() + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * _stacked(params, names).detach().float()
            u = -lr * u
            if leaf_key(names[0])[1] < 0:
                upds[names[0]] = u.to(params[names[0]].dtype)
            else:
                for i, n in enumerate(names):
                    upds[n] = u[i].to(params[n].dtype)
        return upds, new_state

    return Optimizer(init, update)


def get_optimizer(name: str, lr_fn):
    if name == "adamw":
        return adamw(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    raise KeyError(name)
