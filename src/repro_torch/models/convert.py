"""Carry the JAX package's weights over to the port.

``repro.models.transformer.init_params`` returns a pytree whose per-layer
leaves are stacked along a leading layer axis (``blocks/attn/wq`` is
``(L, D, H * Dh)``).  :func:`params_from_jax` takes that tree as numpy
arrays (``jax.tree.map(np.asarray, params)``; nothing of JAX is imported
here), splits each stacked leaf along the layer axis, and loads the
result into a :class:`~repro_torch.models.transformer.Transformer`, so a
test can run both packages on identical weights.

:func:`train_state_to_jax` and :func:`train_state_from_jax` carry a whole
train state (``params``, the optimizer's ``opt``, ``step``) between the
port's layout (one tensor per layer, keyed by parameter name) and the JAX
package's (numpy arrays stacked over layers, nested by key), so a
checkpoint that either package's ``ckpt/store.py`` wrote restores in the
other.  A sharded state (``train.loop``: each rank holds blocks) goes out
as this rank's blocks in that layout, with their specs
(:func:`train_state_specs`), which ``ckpt.store.save`` gathers to rank 0
and ``ckpt.store.restore`` reads back as each rank's blocks.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import Transformer

#: top-level keys whose leaves carry a leading layer axis (hybrid
#: ``groups``: one axis over the groups, each holding lru0, lru1, attn)
STACKED = ("blocks", "dense_blocks", "moe_blocks", "groups", "rem_lru",
           "enc_blocks", "dec_blocks")


def _leaves(tree, prefix="") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + ".")
        else:
            yield path, v if isinstance(v, torch.Tensor) else np.asarray(v)


def leaf_key(name: str) -> Tuple[str, int]:
    """(the JAX tree's leaf path, the layer index or -1) of a parameter
    name: ``blocks.3.attn.wq`` -> (``blocks/attn/wq``, 3),
    ``embed.tok`` -> (``embed/tok``, -1)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), -1


def leaf_groups(names) -> Dict[str, List[str]]:
    """JAX leaf path -> the port's names of its tensors, layers in order,
    leaves in the JAX tree's order (``jax.tree_util.tree_leaves`` of a
    dict walks its keys sorted)."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        path, layer = leaf_key(name)
        groups.setdefault(path, []).append((layer, name))
    return {path: [n for _, n in sorted(groups[path])]
            for path in sorted(groups, key=lambda p: p.split("/"))}


def nest(flat: Dict[str, np.ndarray]) -> Dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    tree: Dict = {}
    for path, arr in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = arr
    return tree


def _at(tree: Dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _f32(a) -> torch.Tensor:
    """A leaf (numpy, or a tensor a sharded restore placed) as a float32
    tensor."""
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.from_numpy(np.array(a, np.float32))


def _jax(tensors: Dict[str, torch.Tensor], one, stacked) -> Dict:
    """The JAX package's nested tree of tensors keyed by the port's
    parameter names: ``one(t)`` of a leaf, ``stacked(ts)`` of a stack's
    layers in order."""
    flat = {}
    for path, names in leaf_groups(tensors).items():
        ts = [tensors[n] for n in names]
        flat[path] = one(ts[0]) if leaf_key(names[0])[1] < 0 \
            else stacked(ts)
    return nest(flat)


def jax_tree(tensors: Dict[str, torch.Tensor], host: bool = True) -> Dict:
    """The JAX package's nested tree (numpy, stacked over layers) of
    tensors keyed by the port's parameter names.  Not ``host``: the
    tensors on their device, each stacked leaf a function of no arguments
    that stacks it, which ``ckpt.store.save`` calls where it writes the
    leaf, so one stacked copy is alive at a time."""
    if host:
        return _jax(tensors, _host,
                    lambda ts: np.stack([_host(t) for t in ts]))
    return _jax(tensors, torch.Tensor.detach, lambda ts: functools.partial(
        torch.stack, [t.detach() for t in ts]))


def jax_like(tensors: Dict[str, torch.Tensor]) -> Dict:
    """:func:`jax_tree`'s tree as tensors on the meta device (shapes
    alone: a restore's ``like``)."""
    return _jax({n: torch.empty_like(t, device="meta")
                 for n, t in tensors.items()}, lambda t: t, torch.stack)


def jax_specs(model) -> Dict:
    """The specs of a sharded model's parameters in the JAX package's
    layout (:func:`jax_tree`'s tree; a stacked leaf's layer axis
    unsplit): ``parallel.api.param_shardings`` of the reference's tree."""
    flat = {}
    for path, names in leaf_groups(model.shardings).items():
        spec = model.shardings[names[0]]
        flat[path] = spec if leaf_key(names[0])[1] < 0 else (None,) + spec
    return nest(flat)


def _is_adamw(opt: Dict) -> bool:
    return set(opt) == {"m", "v"}


def opt_state_to_jax(opt: Dict) -> Dict:
    """The JAX package's optimizer state (numpy) of the port's: AdamW's
    ``m`` and ``v`` stacked as the parameters, Adafactor's per-leaf state
    nested by its leaf path."""
    if _is_adamw(opt):
        return {"m": jax_tree(opt["m"]), "v": jax_tree(opt["v"])}
    return nest({path: {k: _host(t) for k, t in leaf.items()}
                 for path, leaf in opt.items()})


def opt_state_from_jax(tree: Dict, like: Dict, device) -> Dict:
    """The port's optimizer state, in the layout of ``like``, holding the
    JAX optimizer state ``tree`` (numpy, or tensors), as tensors on
    ``device``."""
    if _is_adamw(like):
        return {k: {n: t.to(device)
                    for n, t in state_dict_from_jax(tree[k]).items()}
                for k in ("m", "v")}
    return {path: {k: _f32(_at(tree, path)[k]).to(device) for k in leaf}
            for path, leaf in like.items()}


def train_state_to_jax(state: Dict, like: bool = False) -> Dict:
    """The JAX package's train state (``init_train_state``'s tree, as
    numpy arrays) of the port's ``{"params": Transformer, "opt", "step"}``
    (``repro_torch.train.loop``).  Sharded: the parameters and AdamW's
    moments are this rank's blocks on its device (:func:`jax_tree`'s
    ``host=False``; with ``like``, :func:`jax_like`'s shapes of them),
    Adafactor's state (whole on every rank) numpy."""
    model = state["params"]
    opt = state["opt"]
    if model.mesh is None:
        tree = jax_tree
    else:
        tree = jax_like if like else functools.partial(jax_tree, host=False)
    return {"params": tree(dict(model.named_parameters())),
            "opt": ({k: tree(opt[k]) for k in ("m", "v")} if _is_adamw(opt)
                    else opt_state_to_jax(opt)),
            "step": np.asarray(state["step"], np.int32)}


def train_state_specs(state: Dict):
    """The specs of :func:`train_state_to_jax`'s tree of a sharded state
    (None: not sharded): the parameters' and AdamW's moments'
    (:func:`jax_specs`); Adafactor's state and the step replicated."""
    model = state["params"]
    if model.mesh is None:
        return None
    specs = jax_specs(model)
    return {"params": specs,
            "opt": {"m": specs, "v": specs} if _is_adamw(state["opt"])
            else {}}


def train_state_from_jax(tree: Dict, state: Dict) -> Dict:
    """The port's train state holding the JAX train state ``tree``
    (numpy arrays; sharded, this rank's blocks as ``ckpt.store.restore``
    places them): its parameters are loaded into ``state``'s model in
    place, its optimizer state comes as tensors on the model's device in
    the layout of ``state["opt"]``."""
    model = state["params"]
    model.load_state_dict(state_dict_from_jax(tree["params"]), strict=True)
    opt = opt_state_from_jax(tree["opt"], state["opt"], model.device)
    return {"params": model, "opt": opt, "step": int(tree["step"])}


def state_dict_from_jax(np_tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (dotted keys, one entry per layer) of a
    JAX parameter tree given as numpy arrays (or tensors)."""
    sd = {}
    for top, sub in np_tree.items():
        if top in STACKED:
            for path, arr in _leaves(sub):
                for layer in range(arr.shape[0]):
                    sd[f"{top}.{layer}.{path}"] = _f32(arr[layer])
        else:
            for path, arr in _leaves(sub):
                sd[f"{top}.{path}"] = _f32(arr)
    return sd


def params_from_jax(np_tree: Dict, cfg, device=None) -> Transformer:
    """A :class:`Transformer` of ``cfg`` on ``device`` holding the weights
    of ``np_tree`` (``load_state_dict`` raises on a missing, extra or
    misshapen key)."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(np_tree), strict=True)
    return model
