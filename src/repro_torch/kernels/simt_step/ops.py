"""Dispatching wrapper of the SIMT step kernel: how the engine driver
advances a SIMT (or HBM-PIM all-bank compat) launch on the card.

``simt_step(cfg, st, ir, k)`` advances the state dict ``st`` by ``k``
gated SIMT steps of the image ``ir`` and returns the termination
predicate.  CPU tensors go to the plain version (:mod:`.ref`); CUDA
tensors launch the hand-written kernel (:mod:`.simt_step`) on the current
stream, or raise — there is no fallback.

:class:`SimtStep` is the same wrapper split for a driver (the state
checked once, then ``k`` steps a launch, in place; the predicate from a
device flag).  ``launches`` counts kernel launches (never plain-version
calls); callers may reset it to 0.  :func:`route` says which
configurations the kernel takes: every configuration of the SIMT engine
with at most 32 tasklets (one CUDA warp's lanes), at any DPU count.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.cycle_step.cycle_step import LEAVES as ENGINE_LEAVES
from repro_torch.kernels.simt_step import simt_step as k_simt
from repro_torch.kernels.simt_step.ref import simt_step_ref
from repro_torch.kernels.step_driver import StepDriver

#: CUDA kernel launches made by this module (a plain integer)
launches = 0

#: tasklets of one DPU: one warp's lanes
MAX_TASKLETS = 32


def route(cfg: DPUConfig, n_threads: Optional[int] = None) -> str:
    """The CUDA kernel that runs a SIMT launch of ``cfg`` with
    ``n_threads`` tasklets (default ``cfg.n_tasklets``) on the card:
    ``"simt_step"``.  Raises ``ValueError`` above 32 tasklets."""
    T = n_threads or cfg.n_tasklets
    if T > MAX_TASKLETS:
        raise ValueError(f"simt_step: {T} tasklets; the kernel runs one DPU "
                         f"on one warp, at most {MAX_TASKLETS}")
    return "simt_step"


class SimtStep(StepDriver):
    """A SIMT launch's state on the card, advanced ``k`` steps a launch.

    ``st``: the driver's dict of CUDA tensors (the keys, dtypes and shapes
    of ``simt.make_state_np``), updated in place; ``ir``: the (6, P) int32
    image on the same card; ``image``: ``ir`` as numpy, or None.  For the
    all-bank compat target ``cfg`` is its SIMT configuration (one warp of
    every tasklet, coalescing on)."""

    name = "simt_step"
    LEAVES = k_simt.LEAVES
    Args = k_simt.Args

    def __init__(self, cfg: DPUConfig, st: Dict[str, torch.Tensor],
                 ir: torch.Tensor, image: Optional[np.ndarray] = None):
        route(cfg, st["status"].shape[1])
        super().__init__(cfg, st, ir, image)

    def state_keys(self, cfg, st):
        # simt.make_state_np: the scalar engine's leaves and two more
        return set(ENGINE_LEAVES) | {"warp_next", "req_service"}

    def leaf_table(self, cfg, st):
        D, T = st["status"].shape
        return k_simt.leaf_table(cfg, D, T, st["wram"].shape[1],
                                 st["mram"].shape[1])

    def pack(self, cfg, image):
        return k_simt.pack_image(image)

    def configure(self, cfg, st, P):
        D, T = st["status"].shape
        fields, inv_bw = k_simt.config_fields(
            cfg, D, T, st["wram"].shape[1], st["mram"].shape[1], P, 1)
        for i, v in enumerate(fields):
            self.args.c[i] = v
        self.args.inv_bw = float(inv_bw)
        return k_simt.CONFIG.index("K")

    def library(self):
        k_simt.library()

    def call(self, stream):
        k_simt.simt_step_cuda(self.args, stream)

    def count(self):
        global launches
        launches += 1


def simt_step(cfg: DPUConfig, st: Dict[str, torch.Tensor], ir: torch.Tensor,
              k: int) -> bool:
    """Advance ``st`` by ``k`` gated SIMT steps of ``ir``; return the
    termination predicate.  On the card ``st``'s tensors are updated in
    place; on the CPU its entries are replaced."""
    dev = st["status"].device
    if dev.type == "cpu":
        return simt_step_ref(cfg, st, ir, k)
    if dev.type != "cuda":
        raise ValueError(f"simt_step: unsupported device {dev}")
    kern = SimtStep(cfg, st, ir)
    kern.launch(k)
    return kern.predicate()
