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

:func:`launch_route` says how a launch runs: :func:`pick_route` (a pure
function of the sizes and a card's :class:`RouteLimits`) with the
current card's limits: ``"resident_smem"`` (one cooperative launch a
K-block, one bank a block with the image and the rows it touches staged
in shared memory) while they fit a block and every bank's block fits on
the card at once (GEMVS at full width: an image of 1,024 slots and 1,134
rows of 16 words, 107 KB, two blocks an SM, 264 banks on an H100), else
``"global"`` (MRAM in device memory, a run and a tail launch a K-block).
Both give the same state bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.crf_step import crf_step as k_crf
from repro_torch.kernels.crf_step.ref import crf_step_ref
from repro_torch.kernels.step_driver import (RouteLimits, StepDriver,
                                             smem_dpus_of)

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


def smem_banks(n_slots: int, n_rows: int, lanes: int,
               lim: RouteLimits) -> int:
    """The most banks the resident_smem route holds at once on a card of
    limits ``lim`` for an image of ``n_slots`` slots touching ``n_rows``
    rows of ``lanes`` words: 0 when they do not fit a block."""
    return smem_dpus_of(k_crf.smem_bytes(n_slots, n_rows, lanes), lim)


def pick_route(n_banks: int, n_slots: int, n_rows: int, lanes: int,
               lim: RouteLimits) -> str:
    """``"resident_smem"`` up to :func:`smem_banks` banks, else
    ``"global"``: a pure function of the sizes and ``lim``."""
    held = smem_banks(n_slots, n_rows, lanes, lim)
    return "resident_smem" if n_banks <= held else "global"


def launch_route(n_banks: int, n_slots: int, n_rows: int,
                 lanes: int) -> str:
    """:func:`pick_route` with the current CUDA device's limits (builds
    the library)."""
    return pick_route(n_banks, n_slots, n_rows, lanes, k_crf.card_limits())


class CrfStep(StepDriver):
    """A command-stream launch's state on the card, advanced ``k``
    commands a launch (``st``: the keys, dtypes and shapes of
    ``hbmpim.make_cmd_state_np``, CUDA tensors updated in place).
    ``route``: :func:`launch_route`'s choice, or the route asked for (a
    key of ``LAUNCHERS``: a launch the card refuses then raises)."""

    name = "crf_step"
    LEAVES = k_crf.LEAVES
    ROUTES = tuple(k_crf.LAUNCHERS)
    SECTIONS = True
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
        D, M = st["cycle"].shape[0], st["mram"].shape[1]
        fields = k_crf.config_fields(cfg, D, M, P, 1, st["c_hist"].shape[1])
        for i, v in enumerate(fields):
            self.args.c[i] = v
        self.args.burst = float(np.float32(cfg.hbm_lanes * 4))
        # the resident_smem route's staged image, rows and their copies
        W, self.table = cfg.hbm_lanes, k_crf.row_table(self.image_np)
        rows = self.table.rows
        self.staged = torch.from_numpy(k_crf.staged_image(
            self.image_np, self.table, W, M)).to(self.device)
        self.args.staged = self.staged.data_ptr()
        self.segs = [torch.from_numpy(k_crf.segments(rows, W, M, only))
                     .to(self.device) for only in (None, self.table.written)]
        self.args.load, self.args.store = (t.data_ptr() for t in self.segs)
        self.args.n_load, self.args.n_store = (len(t) for t in self.segs)
        self.args.rows = len(rows)
        self.args.store_top = k_crf.writes_top(self.table.written, W, M)
        self._dims = (D, P, len(rows), W)
        return k_crf.CONFIG.index("K")

    def library(self):
        k_crf.library(self.sections is not None)

    def pick_route(self):
        return launch_route(*self._dims)

    def call(self, stream):
        k_crf.LIB.launch(self.route, self.args, stream,
                         self.sections is not None)

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
