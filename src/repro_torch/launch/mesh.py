"""Device meshes over ``torch.distributed`` process groups.

The counterpart of ``repro.launch.mesh``.  The reference builds its
meshes over whatever JAX devices exist (512 host devices in its dry-run);
the port's devices are the ranks of the default process group, one card
each, so a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
that group.  Each function raises unless the group exists and its world
size is the mesh's: nothing stands in for a mesh the world cannot hold.
:func:`elastic_shape` is ``make_elastic_mesh``'s shape arithmetic alone,
for a caller that has no group (the training CLI on one card).

The dry-run (``launch/dryrun.py``) alone builds the production meshes
over :func:`fake_group`: torch's ``fake`` backend, whose collectives
return at once (on meta tensors too), as one rank of a world of 256 or
512, the counterpart of the reference's 512 host devices.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world_size(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group; none is "
                           "initialized")
    return dist.get_world_size()


def _device_mesh(shape: Dict[str, int], device_type: str):
    """A ``DeviceMesh`` of ``shape`` (axis name -> size) over the default
    process group, which must hold exactly that many ranks."""
    n = math.prod(shape.values())
    world = _world_size(f"a {shape} mesh")
    if world != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {world}")
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axes: (data 16, model 16), or (pod 2, data
    16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return _device_mesh(production_shape(multi_pod), device_type)


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    """The default process group, for the body, as rank ``rank`` of a
    ``fake`` group of ``world`` ranks (``torch.testing``'s ``FakeStore``:
    no network, no card; every collective returns at once, its buffers
    untouched).  Destroyed on exit, so the next may have another size or
    rank.  Refuses to stand in for a group that exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def elastic_shape(n_devices: int, model_parallel: int = None
                  ) -> Dict[str, int]:
    """Best-effort ``{"data": n / mp, "model": mp}`` for ``n_devices``:
    ``model_parallel`` or gcd(n, 16), halved until it divides n."""
    n = n_devices
    mp = model_parallel or int(np.gcd(n, 16))
    while n % mp:
        mp //= 2
    return {"data": n // mp, "model": mp}


def make_elastic_mesh(n_devices: int = None, model_parallel: int = None,
                      device_type: str = "cuda"):
    """Best-effort (data, model) mesh for whatever ranks exist — the
    elastic-rescale path (checkpoint restore re-shards onto it)."""
    n = n_devices or _world_size("make_elastic_mesh")
    return _device_mesh(elastic_shape(n, model_parallel), device_type)


def make_pipe_mesh(n_stages: int, device_type: str = "cuda"):
    return _device_mesh({"pipe": n_stages}, device_type)
