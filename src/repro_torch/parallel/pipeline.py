"""GPipe-style pipeline parallelism over the ranks of a process group.

Stages are laid out one per rank; microbatches stream through with a
point-to-point hop from each stage to the next.  The schedule runs
``n_micro + n_stages - 1`` ticks; each tick every stage processes one
microbatch (bubbles at the ends, the classic GPipe fill/drain).

The counterpart of ``repro.parallel.pipeline``, whose ``shard_map`` is one
program over the ``pipe`` axis: here every rank runs its stage and the
ranks meet in the hops.  ``torch.distributed``'s sends carry no autograd,
so each hop is :class:`_Hop`, an autograd Function whose backward sends
the gradient the other way; the reference's ``jnp.where`` selections stay
selections (``torch.where``), so that every rank's graph reaches every one
of its hops and the backward passes meet as the forward ones did.  The
last stage's outputs reach every rank by a sum over the ranks
(:class:`_Broadcast`), as the reference's ``psum`` does; its backward
passes each rank's cotangent through as it is, as ``jax.grad`` transposes
that ``psum`` of a replicated result, so a loss every rank computes alike
of the outputs has the gradient of the stages applied in sequence
(``torch.distributed.nn``'s all-reduce would sum the ranks' equal
cotangents: n_stages times it).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, group, d: int) -> torch.Tensor:
    """Send ``x`` to rank + ``d`` and return what rank - ``d`` sent
    (zeros where there is no such rank): the reference's
    ``ppermute`` over the pairs (i, i + d)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    recv = torch.zeros_like(x)
    ops = [dist.P2POp(op, t, peer if group is None
                      else dist.get_global_rank(group, peer), group)
           for op, t, peer in ((dist.isend, x.contiguous(), rank + d),
                               (dist.irecv, recv, rank - d))
           if 0 <= peer < n]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv


class _Hop(torch.autograd.Function):
    """Stage i's ``out`` to stage i + 1; the gradient back to stage i."""

    @staticmethod
    def forward(ctx, out, group):
        ctx.group = group
        return _shift(out, group, +1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


class _Broadcast(torch.autograd.Function):
    """The sum over the ranks of ``x`` (zeros but on one rank: that rank's
    ``x`` on every rank); the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_apply(stage_fn, stage_params, x_micro, group=None):
    """``stage_params``: this rank's stage (rank i runs stage i).
    ``x_micro``: (n_micro, mb, ...) input microbatches, the same on every
    rank.  Returns (n_micro, mb, ...) outputs (from the last stage), on
    every rank."""
    sid, n_stages = dist.get_rank(group), dist.get_world_size(group)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    first = torch.tensor(sid == 0, device=x_micro.device)
    last = torch.tensor(sid == n_stages - 1, device=x_micro.device)
    cur = torch.zeros_like(x_micro[0])
    banked = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (when in range)
        cur = torch.where(first, x_micro[min(t, n_micro - 1)], cur)
        out = stage_fn(stage_params, cur)
        # the last stage banks its result for microbatch t - n_stages + 1
        if t >= n_stages - 1:
            banked.append(out)
        if t < ticks - 1:
            cur = _Hop.apply(out, group)
    buf = torch.stack(banked)
    # broadcast results from the last stage to all (for loss/consumers)
    return _Broadcast.apply(torch.where(last, buf, torch.zeros_like(buf)),
                            group)
