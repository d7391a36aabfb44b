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
entry (:func:`param_spec`).  The port's models carry no sharding
constraints (one card runs a layer loop), so :func:`shard_activation`
checks its spec against the active mesh and returns its input as it is;
outside a :func:`mesh_context` it is a no-op, as in the reference.
"""
from __future__ import annotations

import math
import re
import threading
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.models.convert import leaf_key

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
    """``{axis name: size}`` of ``mesh``: a mapping as it is, or a
    ``DeviceMesh`` by its dimension names."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def current_mesh() -> Optional[Dict[str, int]]:
    return getattr(_state, "mesh", None)


@contextmanager
def mesh_context(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh_axes(mesh)
    try:
        yield mesh
    finally:
        _state.mesh = prev


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
    """``x`` as it is: the active mesh's spec for it is resolved (an
    unknown logical axis raises as the reference's does) but nothing
    annotates it (no-op without a mesh)."""
    mesh = current_mesh()
    if mesh is not None:
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
    :func:`param_spec` reads it); other leaves (a step count) give
    ``()``."""
    if isinstance(tree, torch.nn.Module):
        return {n: param_spec(n, p.shape, mesh, prefix)
                for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: (param_spec(k, v.shape, mesh, prefix)
                    if isinstance(v, torch.Tensor) and "." in k
                    else param_shardings(v, mesh, f"{prefix}{k}/"))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
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


def cache_sharding(cache_tree, mesh):
    """KV caches: (L, B, S, KV/heads, Dh)-style — batch over dp, heads over
    tp.  The position (a Python int in the port) gets ``()``."""

    def one(leaf):
        shape = getattr(leaf, "shape", ())
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

    return {k: one(v) for k, v in cache_tree.items()}
