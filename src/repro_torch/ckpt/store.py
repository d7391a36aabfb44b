"""Sharded, manifest-atomic checkpoints.

Layout (the JAX package's, so either package restores the other's files):
    <dir>/step_<N>.tmp/            (written first)
        shard_<p>.npz              (one per host process)
        manifest.json              (leaf paths, shapes, dtypes, step)
    <dir>/step_<N>/                (atomic rename commits)
    <dir>/LATEST                   (text file, updated last)

A tree is nested dicts, lists and tuples of numpy arrays, torch tensors
or python scalars; a leaf to save may also be a function of no arguments
that makes it, called where the leaf is written (a large leaf made from
parts, one at a time).  Leaves are named by their path: dict keys in sorted
order, sequence items as ``[i]``, joined by ``/`` (``{"a": {"b": x}}``
-> ``a/b``).  Restore reads every leaf on the host (each large one mapped
from the file) and puts it where the matching leaf of ``like`` lives: a
tensor's device (``device``'s for a tensor on the meta device, a shape
alone), or numpy.

On the ranks of a mesh (``parallel.api``): ``save(..., shardings=,
mesh=)`` takes each tensor leaf as this rank's block of the leaf for its
spec and gathers it on rank 0's host; under a process group of several
ranks, rank 0 alone writes the (whole; without shardings, the same on
every rank) tree, as one process of the JAX package's layout, and every
rank returns once it is written.
``restore(..., shardings=, mesh=)`` puts each rank's block of each leaf
on it: the elastic restore, onto any mesh whatever the saving one."""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import struct
import threading
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


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


def _specs(shardings, prefix=()):
    """A tree of specs keyed by path (dicts walked; a spec is a leaf)."""
    if not isinstance(shardings, dict):
        return {"/".join(prefix): shardings}
    out = {}
    for k in shardings:
        out.update(_specs(shardings[k], prefix + (str(k),)))
    return out


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def save(ckpt_dir: str, step: int, tree: Dict[str, Any],
         process_index: int = 0, process_count: int = 1, shardings=None,
         mesh=None):
    """Save a tree (tensors copied to the host leaf by leaf, each written
    as it comes; with ``shardings``, a tree of specs, each tensor leaf is
    this rank's block on the ``DeviceMesh`` ``mesh``, gathered on rank 0's
    host first)."""
    writer = _ranks() == 1 or dist.get_rank() == 0
    specs = {} if shardings is None else _specs(shardings)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if process_index == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(final, ignore_errors=True)
            os.makedirs(tmp)
    leaves = {}
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(_Npz(os.path.join(
            tmp, f"shard_{process_index}.npz"))) if writer else None
        for k, v in _flatten(tree).items():
            if callable(v):
                v = v()
            if isinstance(v, torch.Tensor) and k in specs:
                from repro_torch.parallel import api as par
                v = par.unshard_to(v.detach(), specs[k], mesh)
            if writer:
                arr = np.asanyarray(_host(v))
                out.add(k, arr)
                leaves[k] = {"shape": list(arr.shape),
                             "dtype": str(arr.dtype)}
            del v
    if writer and process_index == 0:
        manifest = {"step": step, "process_count": process_count,
                    "leaves": leaves}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final) if not os.path.exists(final) else None
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
    if _ranks() > 1:
        dist.barrier()
    return final


class _Npz:
    """An ``.npz`` file in ``np.savez``'s layout (each array a stored,
    uncompressed ``.npy`` member), each member written by a thread while
    the caller makes the next array (a gather, a copy to the host)."""

    def __init__(self, path: str):
        self.zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                  allowZip64=True)
        self.thread, self.error = None, None

    def _write(self, key, arr):
        try:
            with self.zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr)
        except BaseException as e:       # re-raised by the caller's thread
            self.error = e

    def _wait(self):
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        if self.error is not None:
            raise self.error

    def add(self, key: str, arr: np.ndarray):
        self._wait()
        self.thread = threading.Thread(target=self._write, args=(key, arr))
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self._wait()
        finally:
            self.zf.close()


def _members(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an ``.npz`` file (``np.savez`` stores its members
    uncompressed), each large one mapped from the file and read where it
    is used (an elastic restore reads its rank's blocks alone); a small or
    compressed one read whole."""
    out = {}
    fmt = np.lib.format
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            if info.compress_type != zipfile.ZIP_STORED \
                    or info.file_size < 1 << 20:
                with zf.open(info) as member:
                    out[key] = fmt.read_array(member)
                continue
            # the member's data follows its local header (30 bytes, then
            # its name and extra field), then the .npy header
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = fmt.read_magic(f)
            shape, fortran, dtype = (
                fmt.read_array_header_1_0(f) if version == (1, 0)
                else fmt.read_array_header_2_0(f))
            out[key] = np.memmap(path, dtype=dtype, mode="r",
                                 offset=f.tell(), shape=shape,
                                 order="F" if fortran else "C")
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _place(leaf, device):
    """Where a restored leaf goes: its ``like`` tensor's device, else
    ``device`` (default the CPU)."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return device or "cpu"


def restore(ckpt_dir: str, like, step: Optional[int] = None,
            shardings=None, mesh=None, device=None):
    """Restore into the structure of ``like`` (a tree of arrays, tensors
    or python scalars).  A tensor leaf comes back as a tensor on its
    ``like`` leaf's device; anything else comes back as numpy (a python
    scalar as a scalar); a tensor on the meta device comes back on
    ``device`` (default the CPU).  With ``shardings`` (a tree of specs)
    and ``mesh`` (a ``DeviceMesh``), each leaf with a spec comes back as
    this rank's block, a tensor on its ``like`` leaf's device (``device``
    for a numpy or meta one); its ``like`` leaf is the whole leaf or a
    block of it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for p in range(manifest["process_count"]):
        data.update(_members(os.path.join(d, f"shard_{p}.npz")))

    specs = {} if shardings is None else _specs(shardings)
    leaves = {}
    for key, leaf in _flatten(like).items():
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        want_shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else tuple(np.shape(leaf))
        spec = specs.get(key)
        if spec:
            from repro_torch.parallel import api as par
            block = np.ascontiguousarray(arr[par.block_slices(
                arr.shape, spec, par.mesh_axes(mesh), par.coordinate(mesh))])
            if want_shape not in (tuple(arr.shape), tuple(block.shape)):
                raise ValueError(f"{key}: shape {arr.shape} has no block "
                                 f"of {want_shape} for {spec}")
            arr = torch.from_numpy(block.copy() if not block.flags.writeable
                                   else block).to(_place(leaf, device))
            leaves[key] = arr
            continue
        arr = np.array(arr)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{key}: shape {arr.shape} != {want_shape}")
        elif not hasattr(leaf, "dtype") and np.ndim(leaf) == 0:
            arr = arr.item()  # python scalar leaf (e.g. iterator step)
        elif isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, device=_place(leaf, device))
        leaves[key] = arr
    return _unflatten(like, leaves), step
