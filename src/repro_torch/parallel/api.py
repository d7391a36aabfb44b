"""Distribution context: logical-axis sharding rules over a device mesh.

The counterpart of ``repro.parallel.api``.  Models are written against
*logical* axes (``dp``, ``tp``, ``tp_kv``, ``ep``, ``sp``); the rules map
them onto a mesh's physical axes.  A mesh is its axis names and sizes
(:func:`mesh_axes`: ``{"data": 16, "model": 16}``, or a
``torch.distributed.device_mesh.DeviceMesh`` with dimension names), and a
sharding spec is a tuple with one entry per array dimension: ``None``
(replicated), one physical axis name, or a tuple of them — the entries of
the reference's ``PartitionSpec``.

Divisibility gating: any logical axis whose physical axis size does not
divide the corresponding array dimension is dropped (e.g. 8 KV heads on a
16-way model axis -> replicated KV, the standard GQA fallback).

The port's parameters are one tensor per layer, where the reference
stacks a layer stack's tensors along a leading axis; a per-layer tensor's
spec is the reference's spec of its stacked leaf without that leading
entry (:func:`param_spec`).

Placement on the ranks of a process group (a ``DeviceMesh`` over the
default group, ``launch.mesh``): :func:`shard` gives a rank its block of
a leaf for a spec, each entry's axes splitting the dimension in
mesh-coordinate order, first axis major, as ``jax.device_put`` does with a
``NamedSharding``; :func:`unshard` is its inverse, a gather over the axes
the spec names; :func:`batch_rows` gives a rank its rows of a batch by
:func:`batch_sharding`; :func:`shard_module` keeps a module's parameters
as this rank's blocks.  :class:`MeshRanks` holds a rank's coordinate and
a process group for every set of the mesh's axes.  A :func:`mesh_context`
of a ``DeviceMesh`` runs a sharded model on its ranks
(:func:`current_ranks`); one of a mapping of axis sizes makes a model in
one process compute what such a mesh computes (the MoE layer's
expert-parallel capacity, ``models.moe.moe_ep_plain``).

Tensor and sequence parallelism on the ``model`` axis, the partitioning
XLA derives from the reference's specs: a leaf whose spec names
``model`` keeps its ``model`` block on its rank (gathered over the other
axes its spec names alone), so each rank computes its block of every
product whose weight the spec splits (:func:`model_axis`; the layers'
column- and row-parallel products, ``models.layers``).  Between blocks the
residual stream is the rank's block of the sequence, the reference's
``("dp", "sp", None)`` constraint: :func:`sequence` names the length of
the sequence the model runs on, :func:`seq_axis` says whether it splits
over ``model`` (the reference's divisibility gating), and
:func:`shard_activation` takes a rank's block of an activation whose spec
names ``model``.  Outside a ``DeviceMesh`` context both are no-ops, as in
the reference.

Gradients follow ``shard_map``'s convention, which the sharded train
step's seed of ``1 / world`` sets (``train.loop``): a value that every
``model`` rank holds whole carries on each rank a share of its cotangent
(the shares sum to it), a value split over ``model`` its own cotangent.
So a leaf replicated over ``model`` has its gradient summed over it (the
plan's summing group), and a kept ``model`` block does not.
"""
from __future__ import annotations

import itertools
import math
import re
import threading
from contextlib import contextmanager
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as coll

_state = threading.local()

Spec = Tuple

# logical -> tuple of physical mesh axis names (in priority order)
LOGICAL_AXES = {
    "dp": ("pod", "data"),   # data parallel (batch)
    "fsdp": ("data",),       # parameter sharding axis
    "tp": ("model",),        # tensor parallel (heads / ffn / vocab)
    "tp_kv": ("model",),     # KV heads (gated: replicate when indivisible)
    "ep": ("model",),        # expert parallel
    "sp": ("model",),        # sequence parallel (activation seq axis)
    None: (),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of ``mesh``: a mapping as it is, a
    :class:`MeshRanks`' axes, or a ``DeviceMesh`` by its dimension
    names."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, MeshRanks):
        return dict(mesh.axes)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def current_mesh() -> Optional[Dict[str, int]]:
    return getattr(_state, "mesh", None)


def current_ranks() -> Optional["MeshRanks"]:
    """The ranks of the active :func:`mesh_context`'s ``DeviceMesh``
    (None in one process)."""
    return getattr(_state, "ranks", None)


@contextmanager
def mesh_context(mesh):
    """The active mesh: a mapping of axis sizes, or a ``DeviceMesh`` (or
    its :class:`MeshRanks`), whose ranks then run the sharded model
    together (every rank enters the context)."""
    prev = (getattr(_state, "mesh", None), getattr(_state, "ranks", None))
    _state.mesh = mesh_axes(mesh)
    _state.ranks = None if isinstance(mesh, Mapping) else mesh_ranks(mesh)
    try:
        yield mesh
    finally:
        _state.mesh, _state.ranks = prev


def active():
    """The active mesh context and sequence (:func:`sequence`), to enter
    again (:func:`reentered`) where code runs later, as a recomputed block
    in the backward pass does."""
    return (current_mesh(), current_ranks(), getattr(_state, "seq", None))


@contextmanager
def reentered(saved):
    prev = active()
    _state.mesh, _state.ranks, _state.seq = saved
    try:
        yield
    finally:
        _state.mesh, _state.ranks, _state.seq = prev


@contextmanager
def sequence(length: Optional[int]):
    """The residual stream of the body has ``length`` positions (None: it
    has no sequence axis, or is not to be split)."""
    prev = getattr(_state, "seq", None)
    _state.seq = length
    try:
        yield
    finally:
        _state.seq = prev


class ModelAxis(NamedTuple):
    """This rank's place on the ``model`` axis: its coordinate, the
    axis's size and the group of its ranks."""

    index: int
    size: int
    group: object


def model_axis() -> Optional[ModelAxis]:
    """The active ``DeviceMesh``'s ``model`` axis (None in one process,
    under a mapping of axis sizes, or where the axis is absent or 1)."""
    ranks = current_ranks()
    if ranks is None or ranks.axes.get("model", 1) == 1:
        return None
    return ModelAxis(ranks.coord["model"], ranks.axes["model"],
                     ranks.group(("model",)))


def seq_axis() -> Optional[ModelAxis]:
    """:func:`model_axis` where the residual stream's sequence
    (:func:`sequence`) splits over it, the reference's ``sp`` gating
    (None: the stream is whole on every ``model`` rank)."""
    ax = model_axis()
    n = getattr(_state, "seq", None)
    if ax is None or not n or n % ax.size:
        return None
    return ax


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch is split over (``dp``'s)."""
    return tuple(a for a in LOGICAL_AXES["dp"] if a in mesh_axes(mesh))


def dp_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in dp_axes(axes))


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data-parallel ranks of the active mesh
    (:func:`collectives.all_reduce`); ``x`` itself in one process."""
    ranks = current_ranks()
    if ranks is None:
        return x
    return coll.all_reduce(x, ranks.group(dp_axes(ranks)))


def _physical(logical, axes: Mapping[str, int]):
    if logical is None:
        return None
    names = [a for a in LOGICAL_AXES.get(logical, ()) if a in axes]
    if not names:
        return None
    return tuple(names) if len(names) > 1 else names[0]


def _axis_size(phys, axes: Mapping[str, int]) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        return math.prod(axes[a] for a in phys)
    return axes[phys]


def resolve_spec(logical_axes: Sequence, shape: Tuple[int, ...], mesh) -> Spec:
    """Logical axes -> a spec (one physical entry per dimension) with
    divisibility gating."""
    axes = mesh_axes(mesh)
    spec = []
    for dim, logical in zip(shape, logical_axes):
        phys = _physical(logical, axes)
        if phys is not None and dim % _axis_size(phys, axes) == 0 and dim > 0:
            spec.append(phys)
        else:
            spec.append(None)
    return tuple(spec)


def shard_activation(x, logical_axes: Sequence):
    """This rank's block of ``x`` (whole on every rank) along each
    dimension whose logical axis maps to ``model`` under the active
    ``DeviceMesh`` (a view; gated as the reference gates it).  The batch
    axes are the rank's rows already, and are left as they are.  Without
    a ``DeviceMesh`` the spec is resolved (an unknown logical axis raises
    as the reference's does) and ``x`` returned as it is."""
    mesh = current_mesh()
    if mesh is None:
        return x
    ax = model_axis()
    for d, logical in enumerate(logical_axes):
        names = LOGICAL_AXES[logical]
        if ax is None or "model" not in names:
            continue
        if x.shape[d] % ax.size == 0 and x.shape[d] > 0:
            n = x.shape[d] // ax.size
            x = x.narrow(d, ax.index * n, n)
    if ax is None:
        resolve_spec(logical_axes, x.shape, mesh)
    return x


def named_sharding(logical_axes: Sequence, shape, mesh=None) -> Spec:
    return resolve_spec(logical_axes, shape, mesh or current_mesh())


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-regex -> logical axes)
# ---------------------------------------------------------------------------
# Paths look like "blocks/attn/wq", "embed/tok", "enc_blocks/mlp/wi" ...
# Stacked (scan) params carry a leading layer axis -> rules below give the
# *trailing* axes; leading extra dims are replicated (None).

PARAM_RULES = (
    # embeddings / lm head: vocab x d_model
    (r"embed/tok$", ("tp", "fsdp")),
    (r"lm_head/w$", ("fsdp", "tp")),
    # attention projections
    (r"attn.*/wq$", ("fsdp", "tp")),
    (r"attn.*/wk$", ("fsdp", "tp_kv")),
    (r"attn.*/wv$", ("fsdp", "tp_kv")),
    (r"attn.*/wo$", ("tp", "fsdp")),
    # MLA
    (r"attn.*/wq_a$", ("fsdp", "tp")),
    (r"attn.*/wq_b$", ("fsdp", "tp")),
    (r"attn.*/wkv_a$", ("fsdp", None)),
    (r"attn.*/wk_b$", ("fsdp", "tp")),
    (r"attn.*/wv_b$", ("fsdp", "tp")),
    # dense mlp
    (r"mlp/wi$", ("fsdp", "tp")),
    (r"mlp/wg$", ("fsdp", "tp")),
    (r"mlp/wo$", ("tp", "fsdp")),
    # moe experts: (E, D, F) — experts over ep axis, D over fsdp
    (r"moe/(wi|wg)$", ("ep", "fsdp", None)),
    (r"moe/wo$", ("ep", None, "fsdp")),
    (r"moe/router$", ("fsdp", None)),
    (r"shared/(wi|wg)$", ("fsdp", "tp")),
    (r"shared/wo$", ("tp", "fsdp")),
    # ssm
    (r"ssm/in_proj$", ("fsdp", "tp")),
    (r"ssm/out_proj$", ("tp", "fsdp")),
    (r"ssm/conv_w$", (None, "tp")),
    # rg-lru
    (r"lru/(w_x|w_gate)$", ("fsdp", "tp")),
    (r"lru/(w_in_gate|w_rec_gate)$", ("tp", None)),
    (r"lru/out_proj$", ("tp", "fsdp")),
    (r"lru/conv_w$", (None, "tp")),
    # frontends / defaults
    (r"frontend/.*$", ("fsdp", None)),
)

_COMPILED_RULES = [(re.compile(pat), axes) for pat, axes in PARAM_RULES]


def param_logical_axes(path: str, ndim: int) -> Tuple:
    for rx, axes in _COMPILED_RULES:
        if rx.search(path):
            pad = (None,) * (ndim - len(axes))
            return pad + tuple(axes[-ndim:]) if ndim >= len(axes) else tuple(axes[-ndim:])
    return (None,) * ndim


def leaf_key(name: str):
    """``models.convert.leaf_key`` (imported where it is called: that
    module imports the model, whose MoE layer imports this one)."""
    from repro_torch.models.convert import leaf_key as key
    return key(name)


def param_spec(name: str, shape, mesh, prefix: str = "") -> Spec:
    """The spec of the port's parameter ``name`` (``blocks.3.attn.wq``)
    of ``shape``: its JAX leaf path's (``blocks/attn/wq``, after
    ``prefix``), without the leading layer entry of a stacked leaf."""
    path, layer = leaf_key(name)
    path = prefix + path
    if layer < 0:
        return resolve_spec(param_logical_axes(path, len(shape)), shape, mesh)
    axes = param_logical_axes(path, len(shape) + 1)[1:]
    return resolve_spec(axes, shape, mesh)


def param_shardings(tree, mesh, prefix: str = ""):
    """A spec for each tensor of ``tree``, in its structure: a module
    gives ``{parameter name: spec}`` (:func:`param_spec`); a dict is
    walked, its keys joined into the path with ``/`` (a key that names a
    parameter, as an optimizer state's moments do, is read as
    :func:`param_spec` reads it); an array (a tensor, or a numpy array of
    the JAX package's layout) by its path; other leaves (a step count)
    give ``()``."""
    if isinstance(tree, torch.nn.Module):
        return {n: param_spec(n, p.shape, mesh, prefix)
                for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: (param_spec(k, v.shape, mesh, prefix)
                    if isinstance(v, torch.Tensor) and "." in k
                    else param_shardings(v, mesh, f"{prefix}{k}/"))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) or hasattr(tree, "ndim"):
        path = prefix.rstrip("/")
        return resolve_spec(param_logical_axes(path, tree.ndim), tree.shape,
                            mesh)
    return ()


def batch_sharding(batch_tree, mesh):
    """Shard the leading (batch) dim of every batch leaf over dp."""

    def one(leaf):
        axes = ("dp",) + (None,) * (len(leaf.shape) - 1)
        return resolve_spec(axes, leaf.shape, mesh)

    if isinstance(batch_tree, dict):
        return {k: one(v) for k, v in batch_tree.items()}
    return one(batch_tree)


def cache_spec(shape, mesh) -> Spec:
    """The spec of one cache leaf of ``shape`` (a position, ``()``, gets
    ``()``): (L, B, S, KV/heads, Dh)-style, batch over dp, the axis after
    it over sp."""
    if len(shape) == 0:
        return ()
    # find the batch axis: stacked caches are (L, B, ...), flat are (B, ...)
    axes = [None] * len(shape)
    b_ax = 1 if len(shape) >= 2 else 0
    axes[b_ax] = "dp"
    if len(shape) >= 4:
        # (L, B, S, KV[, Dh]): shard the KV sequence over the model axis
        # (sp) — KV-head counts (<= 8) don't divide a 16-way axis, and
        # sequence sharding is what keeps 32k-half-MB-per-token caches
        # inside HBM (llama3 decode_32k: 34 GB -> 2.2 GB per device).
        # sp and tp_kv share the physical model axis, so seq wins.
        axes[b_ax + 1] = "sp"
    return resolve_spec(tuple(axes), shape, mesh)


def cache_sharding(cache_tree, mesh):
    """KV caches: (L, B, S, KV/heads, Dh)-style — batch over dp, heads over
    tp.  The position (a Python int in the port) gets ``()``."""
    return {k: cache_spec(getattr(v, "shape", ()), mesh)
            for k, v in cache_tree.items()}


# ---------------------------------------------------------------------------
# Placement on the ranks of a DeviceMesh
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes ``spec`` names, in its order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def block_index(entry, axes: Mapping[str, int], coord: Mapping[str, int],
                only=None) -> Tuple[int, int]:
    """(index, count) of the block at ``coord`` of a dimension split over
    ``entry``'s axes (those in ``only``, when given), the first major."""
    idx, n = 0, 1
    for a in _entry_axes(entry):
        if only is None or a in only:
            idx, n = idx * axes[a] + coord[a], n * axes[a]
    return idx, n


def block_slices(shape, spec: Spec, axes: Mapping[str, int],
                 coord: Mapping[str, int], only=None) -> Tuple[slice, ...]:
    """The slices of the block at ``coord`` of a leaf of ``shape``."""
    out = []
    for dim, entry in zip(shape, spec):
        i, n = block_index(entry, axes, coord, only)
        size = dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


class MeshRanks:
    """A rank's place on a ``DeviceMesh`` that spans the default process
    group: its coordinate (``coord``), every rank's (``coord_of``), and a
    process group for every set of the mesh's axes, whose members (the
    ranks that differ from this one on those axes alone) are in rank order,
    which is mesh-coordinate order.  Building one creates those groups, so
    every rank builds it at once (:func:`mesh_ranks`)."""

    def __init__(self, mesh):
        layout = mesh.mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.axes = dict(zip(self.names, layout.shape))
        self.world = layout.numel()
        if not dist.is_initialized() or dist.get_world_size() != self.world:
            raise RuntimeError(f"a {self.axes} mesh needs a process group "
                               f"of {self.world} ranks")
        self.rank = dist.get_rank()
        self.coord_of = {
            int(layout[idx]): dict(zip(self.names, idx))
            for idx in itertools.product(*(range(n) for n in layout.shape))}
        self.coord = self.coord_of[self.rank]
        self._groups = {}
        for r in range(1, len(self.names) + 1):
            for sub in itertools.combinations(self.names, r):
                rest = [a for a in self.names if a not in sub]
                for fixed in itertools.product(
                        *(range(self.axes[a]) for a in rest)):
                    members = sorted(
                        k for k, c in self.coord_of.items()
                        if all(c[a] == v for a, v in zip(rest, fixed)))
                    g = dist.new_group(members) if len(members) > 1 else None
                    if self.rank in members:
                        self._groups[sub] = (g, members)

    def _key(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in self.names if a in tuple(axes))

    def group(self, axes):
        """The process group of this rank and those that differ from it
        on ``axes`` alone (None: this rank alone)."""
        key = self._key(axes)
        return self._groups[key][0] if key else None

    def members(self, axes):
        key = self._key(axes)
        return self._groups[key][1] if key else [self.rank]

    def first_replica(self, spec: Spec) -> bool:
        """Whether this rank is at coordinate 0 on every axis ``spec``
        leaves replicated (one rank of each set of equal blocks)."""
        named = spec_axes(spec)
        return all(self.coord[a] == 0 for a in self.names if a not in named)

    def plan(self, spec: Spec, block_shape, keep=()):
        """(the shape, each member's place in it, the gathering group, the
        summing group) of the gather of a leaf whose block here is of
        ``block_shape``: over the axes ``spec`` names but those in
        ``keep`` (whose block each rank keeps), its gradient then summed
        over the axes ``spec`` does not name."""
        gather = tuple(a for a in spec_axes(spec) if a not in keep)
        for e in spec:
            ax = _entry_axes(e)
            if any(a in keep for a in ax) and any(a in gather for a in ax):
                raise ValueError(f"entry {e} is partly kept: {spec}")
        shape = tuple(b * block_index(e, self.axes, self.coord, gather)[1]
                      for b, e in zip(block_shape, spec))
        places = [block_slices(shape, spec, self.axes, self.coord_of[m],
                               gather) for m in self.members(gather)]
        rest = [a for a in self.names if a not in spec_axes(spec)]
        return shape, places, self.group(gather), self.group(rest)


_RANKS: Dict[int, Tuple[object, MeshRanks]] = {}


def mesh_ranks(mesh) -> MeshRanks:
    """The :class:`MeshRanks` of a ``DeviceMesh`` (built on first use, by
    every rank at once)."""
    if isinstance(mesh, MeshRanks):
        return mesh
    hit = _RANKS.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = (mesh, MeshRanks(mesh))
        _RANKS[id(mesh)] = hit
    return hit[1]


def coordinate(mesh) -> Dict[str, int]:
    """This rank's coordinate on ``mesh`` (a ``DeviceMesh``)."""
    return dict(mesh_ranks(mesh).coord)


def shard(x: torch.Tensor, spec: Spec, mesh, coord=None) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` (a copy): the block at
    ``coord`` (default: this rank's on the ``DeviceMesh`` ``mesh``; with
    a mapping of axis sizes, ``coord`` is required)."""
    axes = mesh_axes(mesh)
    coord = coordinate(mesh) if coord is None else coord
    return x[block_slices(x.shape, spec, axes, coord)].clone()


def unshard(block: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """:func:`shard`'s inverse: the leaf of which ``block`` is this rank's
    block, gathered over the axes ``spec`` names.  Its gradient is summed
    into each rank's block over those axes and then over the axes ``spec``
    does not name: the transpose of a sharded input's gather, as
    ``jax.grad`` takes it."""
    return coll.unshard(block, *mesh_ranks(mesh).plan(spec, block.shape))


def unshard_to(block: torch.Tensor, spec: Spec, mesh, dst: int = 0
               ) -> Optional[torch.Tensor]:
    """The leaf of which ``block`` is this rank's block, whole on the host
    of global rank ``dst`` (None on the other ranks): gathered there over
    the axes ``spec`` names from the ranks that hold the blocks ``dst``
    holds copies of (the others take no part)."""
    ranks = mesh_ranks(mesh)
    shape, places, group, _ = ranks.plan(spec, block.shape)
    if dst not in ranks.members(spec_axes(spec)):
        return None
    got = coll.gather_to_host(block, group, dst)
    if got is None:
        return None
    out = torch.empty(shape, dtype=block.dtype)
    for place, b in zip(places, got):
        out[place] = b
    return out


def batch_rows(batch, mesh):
    """This rank's rows of a batch (a tensor or a dict of them): each
    leaf's block for :func:`batch_sharding`."""
    specs = batch_sharding(batch, mesh)
    if isinstance(batch, dict):
        return {k: shard(v, specs[k], mesh) for k, v in batch.items()}
    return shard(batch, specs, mesh)


#: the embedding table: its rows are looked up before they are cast, so it
#: is gathered in float32 (its gradient sums a frequent token's rows in
#: float32, as the reference's does)
LOOKED_UP = re.compile(r"embed/tok$")


def shard_module(module: torch.nn.Module, mesh, compute_dtype=None):
    """Keep each parameter of ``module`` (whole on every rank) as this
    rank's block for :func:`param_spec` on the ``DeviceMesh`` ``mesh``.
    Sets ``module.mesh`` and ``module.shardings`` ({name: spec}), and
    ``module.gather_plans`` ({parameter: (:meth:`MeshRanks.plan`, the
    dtype it is gathered in)}): a leaf whose spec names ``model`` keeps
    its ``model`` block (the layers compute with it: tensor parallelism,
    an expert leaf's experts) and is gathered over the other axes its
    spec names; a leaf of two or more dimensions (each used as
    ``compute_dtype``) but the embedding table is cast to it before the
    gather, as XLA casts a sharded operand before gathering it."""
    ranks = mesh_ranks(mesh)
    module.mesh, module.shardings, module.gather_plans = mesh, {}, {}
    for name, p in list(module.named_parameters()):
        spec = param_spec(name, p.shape, mesh)
        owner, _, leaf = name.rpartition(".")
        p = torch.nn.Parameter(shard(p.detach(), spec, mesh),
                               requires_grad=p.requires_grad)
        module.get_submodule(owner)._parameters[leaf] = p
        path = leaf_key(name)[0]
        dtype = (compute_dtype if compute_dtype and p.ndim >= 2
                 and not LOOKED_UP.search(path) else p.dtype)
        module.shardings[name] = spec
        module.gather_plans[p] = (ranks.plan(spec, p.shape, ("model",)),
                                  dtype)
    return module


def gathered(tree: torch.nn.Module, plans, hoisted=None,
             dtype=None) -> Dict:
    """A parameter tree (``models.layers.ParamTree``) of a sharded module
    as a nested dict of its gathered leaves (``gather_plans``); a
    parameter in ``hoisted`` ({parameter: its gathered leaf}) is taken from
    there.  ``dtype``: every leaf of two or more dimensions gathered in it
    instead (serving: no gradient to sum, and a looked-up row cast after
    the lookup is the same value cast before it)."""
    out = {k: gathered(m, plans, hoisted, dtype)
           for k, m in tree._modules.items()}
    for k, p in tree._parameters.items():
        if hoisted and p in hoisted:
            out[k] = hoisted[p]
            continue
        (shape, places, group, rest), dt = plans[p]
        if dtype is not None and p.ndim >= 2:
            dt = dtype
        out[k] = coll.unshard(p, shape, places, group, rest, dt)
    return out


def hoist(module: torch.nn.Module, names) -> Dict:
    """{parameter: its gathered leaf, a tensor of its own that takes a
    gradient} for ``names`` of a sharded module: gathered once for
    several uses (a step's microbatches), its gradient summed over them
    and then reduced into the block (:func:`reduce_hoisted`)."""
    params = dict(module.named_parameters())
    out = {}
    for n in names:
        p = params[n]
        (shape, places, group, rest), dtype = module.gather_plans[p]
        with torch.no_grad():
            full = coll.unshard(p, shape, places, group, rest, dtype)
        out[p] = full.requires_grad_(True)
    return out


def reduce_hoisted(module: torch.nn.Module, p, grad) -> torch.Tensor:
    """The block's gradient of a hoisted leaf's gradient ``grad``."""
    (_, places, group, rest), _ = module.gather_plans[p]
    return coll.reduce_block(grad, places, group, rest, p.dtype)


# ---------------------------------------------------------------------------
# Serving caches on the ranks
# ---------------------------------------------------------------------------

def rows_entry(batch: int, mesh):
    """The spec entry of a batch of ``batch`` rows (``dp``'s axes, or None
    where they do not divide it): which rows a rank serves."""
    return resolve_spec(("dp",), (batch,), mesh)[0]


def place_rows(t: torch.Tensor, spec: Spec, axis: int, mesh, rows
               ) -> torch.Tensor:
    """This rank's block for ``spec`` (a copy) of the leaf of which ``t``
    holds this rank's batch rows (``rows``, their spec entry) along
    ``axis`` and all of every other dimension.  Where ``spec`` splits that
    axis as the rows are split, the block is cut from ``t``; else the rows
    are gathered over the ``dp`` ranks first."""
    ranks = mesh_ranks(mesh)
    if spec[axis] == rows:
        shape = list(t.shape)
        shape[axis] *= block_index(rows, ranks.axes, ranks.coord)[1]
        sl = list(block_slices(shape, spec, ranks.axes, ranks.coord))
        sl[axis] = slice(None)
        return t[tuple(sl)].clone()
    if rows is not None:
        t = torch.cat(coll.gather_blocks(t.contiguous(), ranks.group(
            _entry_axes(rows))), axis)
    return t[block_slices(t.shape, spec, ranks.axes, ranks.coord)].clone()


def rows_of(block: torch.Tensor, spec: Spec, axis: int, mesh, rows
            ) -> torch.Tensor:
    """:func:`place_rows`' inverse: this rank's batch rows along ``axis``,
    whole on every other dimension, of the leaf whose block for ``spec``
    is ``block`` (``block`` itself where that is what it holds; else
    gathered over the axes ``spec`` names)."""
    if spec[axis] == rows and all(
            e is None for i, e in enumerate(spec) if i != axis):
        return block
    ranks = mesh_ranks(mesh)
    shape, places, group, _ = ranks.plan(spec, block.shape)
    whole = coll.unshard(block, shape, places, group)
    i, n = block_index(rows, ranks.axes, ranks.coord)
    size = whole.shape[axis] // n
    return whole.narrow(axis, i * size, size).clone()
