"""Gradient compression for the data-parallel all-reduce.

int8 block-quantisation with error feedback: each worker quantises
(grad + residual) to int8 with a per-block f32 scale, exchanges the
int8 payload (8 GB -> 1 GB per 8B/param step at int8), dequantises, and
keeps the quantisation error as next step's residual.  Error feedback
makes the compressed SGD trajectory track the exact one.

The counterpart of ``repro.parallel.compress`` on a ``torch.distributed``
process group (gloo on the CPU, NCCL on the cards).  The reference's
``psum`` of the int8 payload is dead code there (its result is unused);
its reconstruction is an ``all_gather`` of every rank's q and scales,
summed per rank, which :func:`compressed_psum` does with two
``all_gather`` calls.  ``torch.round`` rounds half to even, as
``jnp.round`` does, and the scale is XLA's (:func:`quantize_int8`), so
q is the reference's bit for bit.  Trees of
parameters, gradients and residuals are dicts of tensors keyed by name.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 256


def quantize_int8(x, block: int = BLOCK):
    """x: f32 (N,) -> (q int8 (N/block, block), scale f32 (N/block,)):
    the ragged last block padded with zeros."""
    n = x.shape[0]
    pad = (-n) % block
    xp = F.pad(x, (0, pad)).reshape(-1, block)
    # the reference's ``/ 127.0`` as XLA compiles it (its step is
    # jitted): a multiply by the float32 reciprocal, 18 of 401 scales an
    # ulp off a true division on seeded normals
    scale = xp.abs().amax(dim=1) * (1.0 / 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xp / scale[:, None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_int8(q, scale, n):
    x = q.float() * scale[:, None]
    return x.reshape(-1)[:n]


def _all_gather(t, group):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def compressed_psum(grads: Dict[str, torch.Tensor],
                    residuals: Dict[str, torch.Tensor], group=None):
    """The mean over ``group``'s ranks of int8-compressed (grads +
    residuals).

    Returns (mean_grads, new_residuals).  Payload over the wire is
    int8 + one f32 per 256 — a 3.9x reduction vs f32 all-reduce."""
    n_dev = dist.get_world_size(group)
    outs, newres = {}, {}
    for k, g in grads.items():
        shp = g.shape
        v = g.float().reshape(-1) + residuals[k].reshape(-1)
        q, s = quantize_int8(v)
        deq_local = dequantize_int8(q, s, v.shape[0])
        # exact per-rank reconstruction: sum_i q_i * s_i
        s_all = _all_gather(s, group)                  # (n_dev, blocks)
        q_all = _all_gather(q, group).float()          # (n_dev, blocks, B)
        deq_sum = torch.einsum("db,dbk->bk", s_all, q_all)
        outs[k] = (deq_sum.reshape(-1)[:v.shape[0]] / n_dev).reshape(shp)
        newres[k] = (v - deq_local).reshape(shp)
    return outs, newres


def init_residuals(params: Dict[str, torch.Tensor]):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _local(batch, rank: int, n: int):
    """This rank's block of the leading dimension of every tensor of
    ``batch`` (a tensor, or a tuple, list or dict of them)."""
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % n:
            raise ValueError(f"a batch of {batch.shape[0]} does not split "
                             f"over {n} ranks")
        return batch.chunk(n)[rank]
    if isinstance(batch, dict):
        return {k: _local(v, rank, n) for k, v in batch.items()}
    return type(batch)(_local(v, rank, n) for v in batch)


def make_dp_compressed_step(loss_fn, optimizer, group=None):
    """A data-parallel train step with compressed gradients.

    ``loss_fn(params, batch) -> loss``; ``params`` a dict of tensors.
    Every rank passes the whole batch and takes its block of the leading
    dimension (the reference's ``P(axis)`` in-spec); params, optimizer
    state and residuals are replicated.  Returns ``step(params, opt, res,
    batch, stepno) -> (params, opt, res, loss)``: the new parameters
    ``(p.float() + u).to(p.dtype)``, the loss averaged over the ranks."""

    def step(params, opt, res, batch, stepno):
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(leaves, _local(batch, rank, n))
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        grads, res = compressed_psum(grads, res, group)
        upd, opt = optimizer.update(grads, opt, params, stepno)
        params = {k: (p.float() + upd[k]).to(p.dtype)
                  for k, p in params.items()}
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return params, opt, res, loss / n

    return step
