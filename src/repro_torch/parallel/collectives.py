"""Collectives that carry gradients, over ``torch.distributed`` groups.

The counterparts of the collectives the reference runs inside
``shard_map`` and of the ones XLA inserts around a sharded array, each a
``torch.autograd.Function`` whose backward is the transpose
``jax.grad`` takes:

* :func:`all_gather` (``jax.lax.all_gather(..., tiled=True)``): the
  group's blocks concatenated along ``dim`` in group-rank order; its
  gradient is the reduce-scatter of the cotangent;
* :func:`reduce_scatter` (``jax.lax.psum_scatter(..., tiled=True)``): the
  sum over the group, each rank keeping its block along ``dim``; its
  gradient is the all-gather of the cotangent;
* :func:`all_reduce` (``jax.lax.psum``): the sum over the group; its
  gradient is the sum of the cotangents over the group, as JAX transposes
  ``psum`` (``shard_map`` divides the cotangent of an output replicated
  over a group by the group's size; the sharded train step's seed does
  that, ``train.loop``);
* :func:`unshard`: a leaf gathered from its blocks (each member's at its
  place in the leaf), whose gradient is summed over the gathering group
  into each member's block and then over ``sum_group``.

These are also the conjugate pairs of the tensor- and sequence-parallel
layers on the ``model`` axis (``models.layers``): :func:`all_gather` of the
residual stream's sequence blocks before a column-parallel product,
:func:`reduce_scatter` of a row-parallel product's partial sums into the
sequence blocks after it, :func:`all_reduce` of them where the sequence
does not split, and :func:`max_over` (no gradient) for the vocab-parallel
log-sum-exp.

``torch.distributed.nn``'s all-reduce is not used: its backward sums the
ranks' cotangents where the values it returns are replicated, which
``jax.grad`` does not do for ``psum`` under ``shard_map``'s division.
A reduce-scatter is an all-to-all of the blocks and a float32 sum of what
arrives, in group-rank order, on the tensors' own device.  Every call
counts, under the reference's collective kinds (``all-gather``,
``reduce-scatter``, ``all-reduce``, ``all-to-all``;
``repro.launch.roofline``'s names), the bytes of its result on this rank
(what the reference reads off each collective's HLO result shape) and the
host seconds it waits in it, in :data:`COUNTS`, and its bytes by its
group's members in :data:`BY_GROUP` (the dry-run prices each group by the
slowest link it crosses).  An all-gather is issued as an all-to-all of the
block's copies (:func:`gather_blocks`) and a reduce-scatter as an
all-to-all of the blocks (:func:`scatter_sum`): each is counted under its
own kind with the bytes that all-to-all returns, what it is on the wire.
gloo takes CUDA tensors for each of these collectives and stages them
through host memory itself; NCCL keeps them on the card.  A group of
``None`` is a group of this rank alone: nothing moves, nothing is
counted.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: kind -> [calls, result bytes on this rank, host seconds in the calls]
#: since :func:`reset_counts`
COUNTS: Dict[str, list] = {}
#: (kind, the group's global ranks) -> result bytes on this rank, since
#: :func:`reset_counts`
BY_GROUP: Dict[Tuple[str, Tuple[int, ...]], int] = {}


def reset_counts() -> None:
    COUNTS.clear()
    BY_GROUP.clear()


@contextlib.contextmanager
def _count(kind: str, nbytes: int, group=None):
    c = COUNTS.setdefault(kind, [0, 0, 0.0])
    c[0] += 1
    c[1] += nbytes
    if group is not None:
        key = (kind, tuple(dist.get_process_group_ranks(group)))
        BY_GROUP[key] = BY_GROUP.get(key, 0) + nbytes
    t0 = time.perf_counter()
    try:
        yield
    finally:
        c[2] += time.perf_counter() - t0


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def gather_blocks(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``x`` (all of one shape), by group rank: an
    all-to-all of ``x``'s copies, one to each member (on ranks that share
    a card, gloo moved a byte of its all_to_all in about a third of the
    time of its all_gather: 860 and 270 MB/s a rank)."""
    if group is None:
        return [x]
    flat = x.unsqueeze(0).expand(_size(group), *x.shape).contiguous()
    out = torch.empty_like(flat)
    with _count("all-gather", _nbytes(out), group):
        dist.all_to_all_single(out, flat, group=group)
    return list(out.unbind(0))


def gather_to_host(x: torch.Tensor, group, dst: int = 0
                   ) -> Optional[List[torch.Tensor]]:
    """Every member's ``x`` (all of one shape) on the host of global rank
    ``dst`` (a member), by group rank; None on the other members.  Staged
    through host memory by an explicit copy (gloo's gather takes host
    tensors; the caller wants them there)."""
    x = x.detach().cpu().contiguous()
    if group is None:
        return [x]
    out = ([torch.empty_like(x) for _ in range(_size(group))]
           if dist.get_rank() == dst else None)
    with _count("gather (host)", _nbytes(x)):
        dist.gather(x, out, dst=dst, group=group)
    return out


def exchange_blocks(blocks: Sequence[torch.Tensor], group,
                    kind: str = "all-to-all") -> List[torch.Tensor]:
    """``blocks[i]`` to group rank i (all of one shape); what each member
    sent this rank, by group rank (counted under ``kind``)."""
    if group is None:
        return [blocks[0]]
    flat = torch.stack([b.contiguous() for b in blocks])
    out = torch.empty_like(flat)
    with _count(kind, _nbytes(out), group):
        dist.all_to_all_single(out, flat, group=group)
    return list(out.unbind(0))


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the members' ``x`` (a new tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        with _count("all-reduce", _nbytes(x), group):
            dist.all_reduce(x, group=group)
    return x


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of the members' ``x`` (a new tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        with _count("all-reduce", _nbytes(x), group):
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def scatter_sum(blocks: Sequence[torch.Tensor], group) -> torch.Tensor:
    """The sum over the members of the block each sent this rank
    (``blocks[i]`` goes to group rank i), in float32 in group-rank order,
    returned in the blocks' dtype."""
    got = exchange_blocks(blocks, group, "reduce-scatter")
    acc = got[0].float()
    for t in got[1:]:
        acc.add_(t)             # in float32, what arrived is ours to reuse
    return acc.to(blocks[0].dtype)


def _reduce_scatter(x, dim, group):
    return scatter_sum(x.chunk(_size(group), dim), group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(gather_blocks(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(gather_blocks(grad, ctx.group), ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_over(x, group)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.group), None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``; the gradient the
    reduce-scatter of the cotangent (nothing moves for a group of
    None)."""
    if group is None:
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def reduce_scatter(x: torch.Tensor, dim: int = 0, group=None
                   ) -> torch.Tensor:
    """The sum over the group, each rank keeping its block along ``dim``;
    the gradient the all-gather of the cotangent."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, dim % x.dim(), group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``; an integer tensor (a count) carries no
    gradient."""
    if group is None:
        return x
    if not x.is_floating_point():
        return sum_over(x, group)
    return _AllReduce.apply(x, group)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, shape, places, group, sum_group, dtype):
        ctx.places, ctx.group, ctx.sum_group = places, group, sum_group
        ctx.dtype = block.dtype
        x = block.to(dtype)
        if group is None:
            return x
        out = torch.empty(shape, dtype=dtype, device=block.device)
        for place, b in zip(places, gather_blocks(x, group)):
            out[place] = b
        return out

    @staticmethod
    def backward(ctx, grad):
        return (reduce_block(grad, ctx.places, ctx.group, ctx.sum_group,
                             ctx.dtype), None, None, None, None, None)


def reduce_block(grad: torch.Tensor, places, group, sum_group=None,
                 dtype=None) -> torch.Tensor:
    """:func:`unshard`'s gradient: each member's place of ``grad`` (the
    gathered tensor's) summed over ``group`` into that member's block,
    then over ``sum_group``, as ``dtype``."""
    g = grad if group is None else scatter_sum([grad[p] for p in places],
                                               group)
    if sum_group is not None:
        g = sum_over(g.float(), sum_group)
    return g.to(dtype or grad.dtype)


def unshard(block: torch.Tensor, shape, places, group,
            sum_group: Optional[object] = None, dtype=None) -> torch.Tensor:
    """The tensor of ``shape`` whose block at ``places[i]`` (a tuple of
    slices) group rank i holds, ``block`` cast to ``dtype`` first; its
    gradient comes back summed over ``group`` into each member's block
    and then over ``sum_group`` (the axes over which the block is
    replicated), in float32, as ``block``'s dtype."""
    return _Unshard.apply(block, tuple(shape), places, group, sum_group,
                          dtype or block.dtype)
