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
other.
"""
from __future__ import annotations

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
            yield path, np.asarray(v)


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


def jax_tree(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The JAX package's nested tree (numpy, stacked over layers) of
    tensors keyed by the port's parameter names."""
    flat = {}
    for path, names in leaf_groups(tensors).items():
        if leaf_key(names[0])[1] < 0:
            flat[path] = _host(tensors[names[0]])
        else:
            flat[path] = np.stack([_host(tensors[n]) for n in names])
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
    JAX optimizer state ``tree`` (numpy), as new tensors on ``device``."""
    if _is_adamw(like):
        return {k: {n: t.to(device)
                    for n, t in state_dict_from_jax(tree[k]).items()}
                for k in ("m", "v")}
    return {path: {k: torch.from_numpy(np.array(_at(tree, path)[k],
                                                np.float32)).to(device)
                   for k in leaf}
            for path, leaf in like.items()}


def train_state_to_jax(state: Dict) -> Dict:
    """The JAX package's train state (``init_train_state``'s tree, as
    numpy arrays) of the port's ``{"params": Transformer, "opt", "step"}``
    (``repro_torch.train.loop``)."""
    return {"params": jax_tree(dict(state["params"].named_parameters())),
            "opt": opt_state_to_jax(state["opt"]),
            "step": np.asarray(state["step"], np.int32)}


def train_state_from_jax(tree: Dict, state: Dict) -> Dict:
    """The port's train state holding the JAX train state ``tree``
    (numpy arrays): its parameters are loaded into ``state``'s model in
    place, its optimizer state comes as new tensors on the model's device
    in the layout of ``state["opt"]``."""
    model = state["params"]
    model.load_state_dict(state_dict_from_jax(tree["params"]), strict=True)
    return {"params": model,
            "opt": opt_state_from_jax(tree["opt"], state["opt"],
                                      model.device),
            "step": int(tree["step"])}


def state_dict_from_jax(np_tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (dotted keys, one entry per layer) of a
    JAX parameter tree given as numpy arrays."""
    sd = {}
    for top, sub in np_tree.items():
        if top in STACKED:
            for path, arr in _leaves(sub):
                for layer in range(arr.shape[0]):
                    sd[f"{top}.{layer}.{path}"] = torch.from_numpy(
                        np.array(arr[layer], np.float32))
        else:
            for path, arr in _leaves(sub):
                sd[f"{top}.{path}"] = torch.from_numpy(
                    np.array(arr, np.float32))
    return sd


def params_from_jax(np_tree: Dict, cfg, device=None) -> Transformer:
    """A :class:`Transformer` of ``cfg`` on ``device`` holding the weights
    of ``np_tree`` (``load_state_dict`` raises on a missing, extra or
    misshapen key)."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(np_tree), strict=True)
    return model
