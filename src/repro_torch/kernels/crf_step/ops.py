"""Dispatching wrapper of the CRF step kernel: how the engine driver
advances an HBM-PIM command-stream launch on the card.

``crf_step(cfg, st, ir, k)`` advances the state dict ``st`` by ``k``
gated commands of the CRF image ``ir`` and returns the termination
predicate.  CPU tensors go to the plain version (:mod:`.ref`); CUDA
tensors launch the hand-written kernel (:mod:`.crf_step`), or raise —
there is no fallback.  :class:`CrfStep` is the same split for a driver;
``launches`` counts kernel launches, ``idle_launches`` those queued past
a run's end.  :func:`route` says which configurations the kernel takes:
``hbm_lanes`` up to 32 (one warp's lanes), at any bank count.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.crf_step import crf_step as k_crf
from repro_torch.kernels.crf_step.ref import crf_step_ref
from repro_torch.kernels.step_driver import StepDriver

#: CUDA kernel launches made by this module (a plain integer)
launches = 0
#: of those, the launches queued past a run's end (no DPU ran in them)
idle_launches = 0

#: SIMD lanes of one bank: one warp's lanes
MAX_LANES = 32


def route(cfg: DPUConfig) -> str:
    """The CUDA kernel that runs a command-stream launch of ``cfg`` on the
    card: ``"crf_step"``.  Raises ``ValueError`` above 32 ``hbm_lanes``."""
    if not 1 <= cfg.hbm_lanes <= MAX_LANES:
        raise ValueError(f"crf_step: hbm_lanes {cfg.hbm_lanes}; the kernel "
                         f"runs one bank on one warp, 1 to {MAX_LANES} lanes")
    return "crf_step"


class CrfStep(StepDriver):
    """A command-stream launch's state on the card, advanced ``k``
    commands a launch (``st``: the keys, dtypes and shapes of
    ``hbmpim.make_cmd_state_np``, CUDA tensors updated in place)."""

    name = "crf_step"
    LEAVES = k_crf.LEAVES
    Args = k_crf.Args

    def __init__(self, cfg: DPUConfig, st: Dict[str, torch.Tensor],
                 ir: torch.Tensor, image: Optional[np.ndarray] = None,
                 **kw):
        route(cfg)
        super().__init__(cfg, st, ir, image, **kw)

    def state_keys(self, cfg, st):
        return set(k_crf.STATE_KEYS)

    def leaf_table(self, cfg, st):
        return k_crf.leaf_table(cfg, st["cycle"].shape[0],
                                st["mram"].shape[1], st["c_hist"].shape[1])

    def pack(self, cfg, image):
        return k_crf.pack_image(image)

    def configure(self, cfg, st, P):
        fields = k_crf.config_fields(cfg, st["cycle"].shape[0],
                                     st["mram"].shape[1], P, 1,
                                     st["c_hist"].shape[1])
        for i, v in enumerate(fields):
            self.args.c[i] = v
        self.args.burst = float(np.float32(cfg.hbm_lanes * 4))
        return k_crf.CONFIG.index("K")

    def library(self):
        k_crf.library()

    def call(self, stream):
        k_crf.crf_step_cuda(self.args, stream)

    def count(self):
        global launches
        launches += 1

    def count_idle(self):
        global idle_launches
        idle_launches += 1


def crf_step(cfg: DPUConfig, st: Dict[str, torch.Tensor], ir: torch.Tensor,
             k: int) -> bool:
    """Advance ``st`` by ``k`` gated commands of ``ir``; return the
    termination predicate (in place on the card)."""
    dev = st["status"].device
    if dev.type == "cpu":
        return crf_step_ref(cfg, st, ir, k)
    if dev.type != "cuda":
        raise ValueError(f"crf_step: unsupported device {dev}")
    kern = CrfStep(cfg, st, ir)
    kern.launch(k)
    return kern.predicate()
