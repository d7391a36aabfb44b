"""Sharded, manifest-atomic checkpoints.

Layout (the JAX package's, so either package restores the other's files):
    <dir>/step_<N>.tmp/            (written first)
        shard_<p>.npz              (one per host process)
        manifest.json              (leaf paths, shapes, dtypes, step)
    <dir>/step_<N>/                (atomic rename commits)
    <dir>/LATEST                   (text file, updated last)

A tree is nested dicts, lists and tuples of numpy arrays, torch tensors
or python scalars.  Leaves are named by their path: dict keys in sorted
order, sequence items as ``[i]``, joined by ``/`` (``{"a": {"b": x}}``
-> ``a/b``).  Restore loads every leaf on the host and puts it where the
matching leaf of ``like`` lives: a tensor's device, or numpy."""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """Leaves of ``tree`` keyed by path, in the JAX package's order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _unflatten(like, leaves, prefix=()):
    """Rebuild ``like``'s structure with the leaves keyed by path."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (str(k),))
                for k in like}
    if isinstance(like, (list, tuple)):
        seq = [_unflatten(v, leaves, prefix + (f"[{i}]",))
               for i, v in enumerate(like)]
        return type(like)(seq) if isinstance(like, list) else tuple(seq)
    return leaves["/".join(prefix)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Dict[str, Any],
         process_index: int = 0, process_count: int = 1):
    """Save a tree (tensors copied to the host)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if process_index == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(final, ignore_errors=True)
        os.makedirs(tmp)
    host = {k: _host(v) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, f"shard_{process_index}.npz"), **host)
    if process_index == 0:
        manifest = {
            "step": step,
            "process_count": process_count,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final) if not os.path.exists(final) else None
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, like, step: Optional[int] = None):
    """Restore into the structure of ``like`` (a tree of arrays, tensors
    or python scalars).  A tensor leaf comes back as a tensor on its
    ``like`` leaf's device; anything else comes back as numpy (a python
    scalar as a scalar)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for p in range(manifest["process_count"]):
        with np.load(os.path.join(d, f"shard_{p}.npz")) as z:
            for k in z.files:
                data[k] = z[k]

    leaves = {}
    for key, leaf in _flatten(like).items():
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        want_shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{key}: shape {arr.shape} != {want_shape}")
        if not hasattr(leaf, "dtype") and np.ndim(leaf) == 0:
            arr = arr.item()  # python scalar leaf (e.g. iterator step)
        elif isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, device=leaf.device)
        leaves[key] = arr
    return _unflatten(like, leaves), step
