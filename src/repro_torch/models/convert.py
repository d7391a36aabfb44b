"""Carry the JAX package's weights over to the port.

``repro.models.transformer.init_params`` returns a pytree whose per-layer
leaves are stacked along a leading layer axis (``blocks/attn/wq`` is
``(L, D, H * Dh)``).  :func:`params_from_jax` takes that tree as numpy
arrays (``jax.tree.map(np.asarray, params)``; nothing of JAX is imported
here), splits each stacked leaf along the layer axis, and loads the
result into a :class:`~repro_torch.models.transformer.Transformer`, so a
test can run both packages on identical weights.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

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
