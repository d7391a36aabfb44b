"""Dispatching wrapper of the SIMT step kernel: how the engine driver
advances a SIMT (or HBM-PIM all-bank compat) launch on the card.

``simt_step(cfg, st, ir, k)`` advances the state dict ``st`` by ``k``
gated SIMT steps of the image ``ir`` and returns the termination
predicate.  CPU tensors go to the plain version (:mod:`.ref`); CUDA
tensors launch the hand-written kernel (:mod:`.simt_step`) on the current
stream, or raise — there is no fallback.

:class:`SimtStep` is the same wrapper split for a driver (the state
checked once, then ``k`` steps a launch, in place; the predicate from a
flag).  ``launches`` counts kernel launches (never plain-version calls),
``idle_launches`` those queued past a run's end; callers may reset both
to 0.  :func:`route` says which
configurations the kernel takes: every configuration of the SIMT engine
with at most 32 tasklets (one CUDA warp's lanes), at any DPU count.
:func:`launch_route` says how a launch runs: the pure :func:`pick_route`
with the current card's limits: ``"resident_smem"`` (one launch of K steps, a DPU a
block with its WRAM row and atomics in shared memory, the tail folded
in) while a DPU's rows fit in a block and every block fits on the card
at once, else ``"global"`` (WRAM in device memory, a run and a tail
kernel a launch).  Both give the same state bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.cycle_step.cycle_step import LEAVES as ENGINE_LEAVES
from repro_torch.kernels.simt_step import simt_step as k_simt
from repro_torch.kernels.simt_step.ref import simt_step_ref
from repro_torch.kernels.step_driver import (RouteLimits, StepDriver,
                                             smem_dpus_of, smem_route_bytes)

#: CUDA kernel launches made by this module (a plain integer)
launches = 0
#: of those, the launches queued past a run's end (no DPU ran in them)
idle_launches = 0

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


def smem_bytes(n_threads: int, wram_words: int,
               atomic_words: int = DPUConfig.atomic_bits) -> int:
    """The resident_smem route's shared memory a block: the register
    file, WRAM and the atomics, each rounded up to 16 bytes
    (``smem_route_bytes`` in the kernel)."""
    return smem_route_bytes(n_threads, wram_words, atomic_words)


def pick_route(n_dpus: int, n_threads: int, wram_words: int,
               lim: RouteLimits,
               atomic_words: int = DPUConfig.atomic_bits) -> str:
    """How a SIMT launch of ``n_dpus`` DPUs runs on a card of limits
    ``lim`` (a pure function): ``"resident_smem"`` while the card holds
    that many blocks of :func:`smem_bytes` at once, else ``"global"``."""
    held = smem_dpus_of(smem_bytes(n_threads, wram_words, atomic_words), lim)
    return "resident_smem" if n_dpus <= held else "global"


def launch_route(n_dpus: int, n_threads: int, wram_words: int,
                 atomic_words: int = DPUConfig.atomic_bits) -> str:
    """:func:`pick_route` with the current CUDA device's limits (builds
    the library)."""
    return pick_route(n_dpus, n_threads, wram_words, k_simt.card_limits(),
                      atomic_words)


class SimtStep(StepDriver):
    """A SIMT launch's state on the card, advanced ``k`` steps a launch.

    ``st``: the driver's dict of CUDA tensors (the keys, dtypes and shapes
    of ``simt.make_state_np``), updated in place; ``ir``: the (6, P) int32
    image on the same card; ``image``: ``ir`` as numpy, or None.  For the
    all-bank compat target ``cfg`` is its SIMT configuration (one warp of
    every tasklet, coalescing on).  ``route``: :func:`launch_route`'s
    pick, or the route asked for (a key of ``LAUNCHERS``; a launch the
    card refuses raises).  ``sections``: an int64 CUDA tensor for the
    profiling build, or None."""

    name = "simt_step"
    LEAVES = k_simt.LEAVES
    ROUTES = tuple(k_simt.LAUNCHERS)
    SECTIONS = True
    Args = k_simt.Args

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
        route(cfg, T)
        self._dims = (D, T, st["wram"].shape[1], cfg.atomic_bits)
        fields, inv_bw = k_simt.config_fields(
            cfg, D, T, st["wram"].shape[1], st["mram"].shape[1], P, 1)
        for i, v in enumerate(fields):
            self.args.c[i] = v
        self.args.inv_bw = float(inv_bw)
        return k_simt.CONFIG.index("K")

    def library(self):
        k_simt.library(self.sections is not None)

    def pick_route(self):
        return launch_route(*self._dims)

    def call(self, stream):
        k_simt.LIB.launch(self.route, self.args, stream,
                          self.sections is not None)

    def count(self):
        global launches
        launches += 1

    def count_idle(self):
        global idle_launches
        idle_launches += 1


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
