"""Dispatching wrapper of the fused cycle step: how the engine driver
advances a launch on the card.

``cycle_step(cfg, st, ir, k)`` advances the state dict ``st`` by ``k``
gated engine steps of the image ``ir`` and returns the termination
predicate.  CPU tensors go to the plain version (:mod:`.ref`: ``k`` eager
steps); CUDA tensors launch the hand-written kernel (:mod:`.cycle_step`)
on the current stream, or raise — there is no fallback.

:class:`CycleStep` is the same wrapper split for a driver: it checks the
state once (every leaf's device, dtype, shape and contiguity) and then
launches ``k`` steps at a time, updating the leaves in place; the kernel
writes the predicate into a device flag that :meth:`CycleStep.predicate`
reads (one host sync per launch).  ``launches`` counts kernel launches
(never plain-version calls); callers may reset it to 0.

:func:`route` says which configurations the kernel takes: every knob of
the scalar engine (the Table I defaults, ``forwarding``, ``unified_rf``,
``superscalar`` up to :data:`MAX_SLOTS`, ``mmu``, ``cache_mode``,
``event_skip``, ``collect_detail``, ``mram_bw_scale``) with at most 32
tasklets, one warp's lanes (UPMEM has at most 24), at any DPU count.
:func:`launch_route` says how a launch of D DPUs runs: ``"resident"``
(one cooperative launch of K steps, no barrier a step) up to
:func:`~repro_torch.kernels.cycle_step.cycle_step.max_dpus` DPUs, as
many as the card holds blocks of the kernel at once, ``"stepwise"`` (a
plan and a run launch a step) above it.  Both give the same state bit
for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.cycle_step.cycle_step import (
    CONFIG, DPUS_PER_BLOCK, LEAVES, MAX_SLOTS, Args, config_fields,
    cycle_step_cuda, leaf_table, max_dpus, pack_image)
from repro_torch.kernels.cycle_step.ref import cycle_step_ref
from repro_torch.kernels.step_driver import StepDriver

#: CUDA kernel launches made by this module (a plain integer)
launches = 0

#: tasklets of one DPU: one warp's lanes
MAX_TASKLETS = 32

_INT32_MAX = 2**31 - 1


def route(cfg: DPUConfig, n_threads: Optional[int] = None) -> str:
    """The CUDA kernel that runs a launch of ``cfg`` with ``n_threads``
    tasklets (default ``cfg.n_tasklets``) on the card: ``"cycle_step"``.
    Raises ``ValueError`` for a configuration it cannot take."""
    T = n_threads or cfg.n_tasklets
    if not 1 <= T <= MAX_TASKLETS:
        raise ValueError(f"cycle_step: {T} tasklets; the kernel runs one "
                         f"DPU on one warp, at most {MAX_TASKLETS}")
    if not 1 <= cfg.superscalar <= MAX_SLOTS:
        raise ValueError(f"cycle_step: superscalar {cfg.superscalar}; the "
                         f"kernel plans 1 to {MAX_SLOTS} issue slots")
    for name in ("row_bytes", "page_bytes", "line_bytes", "timeseries_window",
                 "timeseries_len", "atomic_bits", "tlb_entries",
                 "small_dma_words"):
        if getattr(cfg, name) < 1:
            raise ValueError(f"cycle_step: {name} {getattr(cfg, name)} < 1")
    if not 0 <= cfg.max_cycles <= _INT32_MAX:
        raise ValueError(f"cycle_step: max_cycles {cfg.max_cycles} is no "
                         "int32")
    return "cycle_step"


def launch_route(n_dpus: int, n_threads: int) -> str:
    """How a launch of ``n_dpus`` DPUs of ``n_threads`` tasklets runs on
    the current CUDA device: ``"resident"`` when every block fits at
    once (:func:`max_dpus`), else ``"stepwise"`` (builds the library)."""
    return "resident" if n_dpus <= max_dpus(n_threads) else "stepwise"


class CycleStep(StepDriver):
    """A launch's state on the card, checked once, advanced ``k`` steps a
    kernel launch.

    ``st``: the driver's dict of CUDA tensors (the keys, dtypes and shapes
    of ``engine.make_state_np``), updated in place; ``ir``: the (6, P)
    int32 instruction image on the same card; ``image``: ``ir`` as numpy
    (saves a copy back), or None.  ``route`` is :func:`launch_route`'s
    choice for the state's DPU count."""

    name = "cycle_step"
    LEAVES = LEAVES
    Args = Args

    def state_keys(self, cfg, st):
        return set(LEAVES)

    def leaf_table(self, cfg, st):
        if st["status"].dim() != 2 or st["wram"].dim() != 2 \
                or st["mram"].dim() != 2:
            raise ValueError("cycle_step: status, wram and mram must be 2-d")
        D, T = st["status"].shape
        return leaf_table(cfg, D, T, st["wram"].shape[1], st["mram"].shape[1])

    def pack(self, cfg, image):
        return pack_image(cfg, image)

    def scratch(self, D):
        # one vote a block, each DPU's published step and each step's
        # DMA-width votes (the kernel leaves the latter zero for the next
        # launch; sized by run)
        grid = -(-D // DPUS_PER_BLOCK)
        self.partial = torch.zeros(grid, dtype=torch.int32, device=self.device)
        self.prog = torch.zeros(D, dtype=torch.int64, device=self.device)
        self.wide = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.args.partial = self.partial.data_ptr()
        self.args.prog = self.prog.data_ptr()

    def configure(self, cfg, st, P):
        D, T = st["status"].shape
        route(cfg, T)
        self._dt = (D, T)
        fields, inv_bw, inv_win = config_fields(
            cfg, D, T, st["wram"].shape[1], st["mram"].shape[1], P, 1)
        for i, v in enumerate(fields):
            self.args.c[i] = v
        self.args.inv_bw = float(inv_bw)
        self.args.inv_win = float(inv_win)
        self.args.base = 0
        return CONFIG.index("K")

    def library(self):
        self.route = launch_route(*self._dt)   # builds the library

    def count(self):
        global launches
        launches += 1

    def run(self, k: int) -> None:
        """:meth:`launch` without the count (timing loops)."""
        if k < 1:
            raise ValueError(f"cycle_step: k = {k} < 1")
        if k > self.wide.numel():
            self.wide = torch.zeros(k, dtype=torch.int32, device=self.device)
            self.args.wide = self.wide.data_ptr()
        self.args.c[self._k] = k
        cycle_step_cuda(self.args,
                        torch.cuda.current_stream(self.device).cuda_stream,
                        self.route)
        self.args.base += k     # steps are numbered across launches


def cycle_step(cfg: DPUConfig, st: Dict[str, torch.Tensor], ir: torch.Tensor,
               k: int) -> bool:
    """Advance ``st`` by ``k`` gated steps of ``ir``; return the
    termination predicate.  On the card ``st``'s tensors are updated in
    place; on the CPU its entries are replaced."""
    dev = st["status"].device
    if dev.type == "cpu":
        return cycle_step_ref(cfg, st, ir, k)
    if dev.type != "cuda":
        raise ValueError(f"cycle_step: unsupported device {dev}")
    kern = CycleStep(cfg, st, ir)
    kern.launch(k)
    return kern.predicate()

