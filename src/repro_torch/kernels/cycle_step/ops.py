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

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.cycle_step.cycle_step import (
    CONFIG, DPUS_PER_BLOCK, LEAVES, MAX_SLOTS, Args, config_fields,
    cycle_step_cuda, leaf_table, library, max_dpus, pack_image)
from repro_torch.kernels.cycle_step.ref import cycle_step_ref

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


class CycleStep:
    """A launch's state on the card, checked once, advanced ``k`` steps a
    kernel launch.

    ``st``: the driver's dict of CUDA tensors (the keys, dtypes and shapes
    of ``engine.make_state_np``), updated in place; ``ir``: the (6, P)
    int32 instruction image on the same card; ``image``: ``ir`` as numpy
    (saves a copy back), or None.  ``route`` is :func:`launch_route`'s
    choice for the state's DPU count."""

    def __init__(self, cfg: DPUConfig, st: Dict[str, torch.Tensor],
                 ir: torch.Tensor, image: Optional[np.ndarray] = None):
        dev = st["status"].device if "status" in st else ir.device
        if dev.type != "cuda":
            raise ValueError(f"cycle_step: the kernel runs on CUDA tensors, "
                             f"got {dev}")
        D, T = _check_state(cfg, st, dev)
        route(cfg, T)
        if not (ir.device == dev and ir.dtype == torch.int32
                and ir.dim() == 2 and ir.shape[0] == 6 and ir.shape[1] > 0):
            raise ValueError(f"cycle_step: ir must be a (6, P) int32 tensor "
                             f"on {dev}, got {tuple(ir.shape)} {ir.dtype} "
                             f"on {ir.device}")
        with torch.cuda.device(dev):    # builds the library at first use
            self.route = launch_route(D, T)
        if image is None:
            image = ir.cpu().numpy()
        P = ir.shape[1]
        self.image = torch.from_numpy(pack_image(cfg, image)).to(dev)
        W, M = st["wram"].shape[1], st["mram"].shape[1]
        grid = -(-D // DPUS_PER_BLOCK)
        # scratch of the kernel: one vote a block, the predicate, each
        # DPU's published step and each step's DMA-width votes (the
        # kernel leaves the latter zero for the next launch)
        self.partial = torch.zeros(grid, dtype=torch.int32, device=dev)
        self.flag = torch.zeros(1, dtype=torch.int32, device=dev)
        self.prog = torch.zeros(D, dtype=torch.int64, device=dev)
        self.wide = torch.zeros(0, dtype=torch.int32, device=dev)
        self.st = st
        self.device = dev
        fields, inv_bw, inv_win = config_fields(cfg, D, T, W, M, P, 1)
        args = Args()
        for i, name in enumerate(LEAVES):
            args.leaf[i] = st[name].data_ptr()
        args.image = self.image.data_ptr()
        args.partial = self.partial.data_ptr()
        args.flag = self.flag.data_ptr()
        args.prog = self.prog.data_ptr()
        args.base = 0
        for i, v in enumerate(fields):
            args.c[i] = v
        args.inv_bw = float(inv_bw)
        args.inv_win = float(inv_win)
        self.args = args
        self._k = CONFIG.index("K")

    def launch(self, k: int) -> None:
        """Advance ``k`` steps in one kernel launch on the current stream
        (the kernel stops early once no DPU runs), counted."""
        global launches
        self.run(k)
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

    def predicate(self) -> bool:
        """The termination predicate after the last launch (syncs)."""
        return bool(self.flag.item())


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


def _check_state(cfg: DPUConfig, st: Dict[str, torch.Tensor], dev):
    """Raise the precise reason the kernel cannot take ``st``; return
    (D, T)."""
    missing = [k for k in LEAVES if k not in st]
    extra = [k for k in st if k not in LEAVES]
    if missing or extra:
        raise ValueError(f"cycle_step: state keys differ from the engine's: "
                         f"missing {missing}, unexpected {extra}")
    if st["status"].dim() != 2 or st["wram"].dim() != 2 \
            or st["mram"].dim() != 2:
        raise ValueError("cycle_step: status, wram and mram must be 2-d")
    D, T = st["status"].shape
    table = leaf_table(cfg, D, T, st["wram"].shape[1], st["mram"].shape[1])
    for name, (dtype, shape) in table.items():
        t = st[name]
        if t.device != dev:
            raise ValueError(f"cycle_step: {name} on {t.device}, status on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"cycle_step: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"cycle_step: {name} shape {tuple(t.shape)} != "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"cycle_step: {name} must be contiguous")
    return D, T
