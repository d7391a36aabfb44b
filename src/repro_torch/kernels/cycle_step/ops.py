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
writes the predicate into a flag that :meth:`CycleStep.predicate` reads
(one host sync per launch).  ``launches`` counts kernel launches (never
plain-version calls), ``idle_launches`` those of them that the pipelined
loop queued past a run's end (no DPU ran in them); callers may reset
both to 0.

:func:`route` says which configurations the kernel takes: every knob of
the scalar engine (the Table I defaults, ``forwarding``, ``unified_rf``,
``superscalar`` up to :data:`MAX_SLOTS`, ``mmu``, ``cache_mode``,
``event_skip``, ``collect_detail``, ``mram_bw_scale``) with at most 32
tasklets, one warp's lanes (UPMEM has at most 24), at any DPU count.
:func:`launch_route` says how a launch of D DPUs runs: :func:`pick_route`
(a pure function of the launch's sizes and a card's :class:`RouteLimits`)
with the current card's limits: ``"resident_smem"`` (one cooperative launch of K
steps, one DPU a block with its WRAM row and atomics in shared memory)
while a DPU's rows fit in a block's shared memory and every block fits
on the card at once (396 DPUs of 64 KiB WRAM on an H100), else
``"resident"`` (the same with WRAM in device memory, four DPUs a block)
up to :func:`~repro_torch.kernels.cycle_step.cycle_step.max_dpus` DPUs
(2,112 on an H100), else ``"resident_carry"`` (the same with each
resident warp carrying :func:`carry_factor` DPUs, their lane state
parked in shared memory: 2 at a full 2,560-DPU system, padded to 4,096)
while that many DPUs' shared memory fits a block, else ``"stepwise"`` (a
plan and a run launch a step).  All four give the same state bit for
bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.cycle_step import cycle_step as k_step
from repro_torch.kernels.cycle_step.cycle_step import (
    CONFIG, DPUS_PER_BLOCK, LAUNCHERS, LEAVES, LIB, MAX_CARRY, MAX_SLOTS,
    PARK_WORDS, Args, config_fields, leaf_table, pack_image)
from repro_torch.kernels.cycle_step.ref import cycle_step_ref
from repro_torch.core import isa
from repro_torch.kernels.step_driver import (RouteLimits, StepDriver,
                                             smem_dpus_of, smem_route_bytes)

#: CUDA kernel launches made by this module (a plain integer)
launches = 0
#: of those, the launches queued past a run's end (no DPU ran in them)
idle_launches = 0

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


def smem_bytes(n_threads: int, wram_words: int,
               atomic_words: int = DPUConfig.atomic_bits) -> int:
    """The resident_smem route's shared memory a block: the register file
    and the issue plan, WRAM and the atomics, each rounded up to 16 bytes
    (``smem_route_bytes`` in the kernel)."""
    return smem_route_bytes(n_threads, wram_words, atomic_words,
                            plan_words=MAX_SLOTS * 3)


def smem_dpus(n_threads: int, wram_words: int, lim: RouteLimits,
              atomic_words: int = DPUConfig.atomic_bits) -> int:
    """The most DPUs the resident_smem route holds at once on a card of
    limits ``lim``: 0 when a DPU's rows do not fit in a block."""
    return smem_dpus_of(smem_bytes(n_threads, wram_words, atomic_words),
                        lim)


def carry_bytes(n: int, n_threads: int) -> int:
    """The resident_carry route's dynamic shared memory a block: four
    warps, each with ``n`` DPUs' register files, issue plans and parked
    lane state (``carry_route_bytes`` in the kernel)."""
    per_dpu = n_threads * isa.N_REGS + MAX_SLOTS * 3 + PARK_WORDS
    return 4 * DPUS_PER_BLOCK * n * per_dpu


def carry_held(n: int, n_threads: int, lim: RouteLimits) -> int:
    """The most DPUs the resident_carry route holds at once with ``n``
    DPUs a warp on a card of limits ``lim``: ``n`` times the warps of the
    blocks every SM holds at once (by registers, and by shared memory);
    0 when ``n`` DPUs' shared memory does not fit a block."""
    need = carry_bytes(n, n_threads)
    if need > lim.smem_block:
        return 0
    blocks = min(lim.carry_blocks, lim.smem_sm // (need + lim.carry_extra))
    return lim.sms * blocks * DPUS_PER_BLOCK * n


def carry_factor(n_dpus: int, n_threads: int, lim: RouteLimits) -> int:
    """The DPUs a warp carries on the resident_carry route: the least
    ``n`` >= 2 (up to :data:`MAX_CARRY`) whose :func:`carry_held` takes
    ``n_dpus``, or 0 when none does."""
    for n in range(2, MAX_CARRY + 1):
        if carry_bytes(n, n_threads) > lim.smem_block:
            return 0
        if n_dpus <= carry_held(n, n_threads, lim):
            return n
    return 0


def carry_map(n_dpus: int, n: int):
    """Where the resident_carry kernel keeps each DPU with ``n`` DPUs a
    warp: ``(R, grid, warp, slot)``: ``R = ceil(n_dpus / n)`` warps carry
    DPUs, in ``grid`` blocks of four warps; DPU d is slot ``d // R`` of
    warp ``d % R`` (``warp`` and ``slot``: int64 arrays over the DPUs)."""
    R = -(-n_dpus // n)
    d = np.arange(n_dpus, dtype=np.int64)
    return R, -(-R // DPUS_PER_BLOCK), d % R, d // R


def route_of(n_dpus: int, smem_held: int, resident_held: int,
             carry: int = 0) -> str:
    """``"resident_smem"`` up to ``smem_held`` DPUs, else ``"resident"``
    up to ``resident_held``, else ``"resident_carry"`` when some factor
    ``carry`` > 0 holds them, else ``"stepwise"``."""
    if n_dpus <= smem_held:
        return "resident_smem"
    if n_dpus <= resident_held:
        return "resident"
    return "resident_carry" if carry else "stepwise"


def pick_route(n_dpus: int, n_threads: int, wram_words: int,
               lim: RouteLimits,
               atomic_words: int = DPUConfig.atomic_bits) -> str:
    """How a launch of ``n_dpus`` DPUs of ``n_threads`` tasklets and
    ``wram_words`` of WRAM runs on a card of limits ``lim``: a pure
    function, :func:`route_of` with :func:`smem_dpus`,
    ``lim.resident_dpus`` and :func:`carry_factor`."""
    return route_of(n_dpus,
                    smem_dpus(n_threads, wram_words, lim, atomic_words),
                    lim.resident_dpus,
                    carry_factor(n_dpus, n_threads, lim))


def launch_route(n_dpus: int, n_threads: int,
                 wram_words: int = DPUConfig().wram_words,
                 atomic_words: int = DPUConfig.atomic_bits) -> str:
    """:func:`pick_route` with the current CUDA device's limits
    (:func:`~repro_torch.kernels.cycle_step.cycle_step.card_limits`;
    builds the library)."""
    return pick_route(n_dpus, n_threads, wram_words,
                      k_step.card_limits(n_threads), atomic_words)


class CycleStep(StepDriver):
    """A launch's state on the card, checked once, advanced ``k`` steps a
    kernel launch.

    ``st``: the driver's dict of CUDA tensors (the keys, dtypes and shapes
    of ``engine.make_state_np``), updated in place; ``ir``: the (6, P)
    int32 instruction image on the same card; ``image``: ``ir`` as numpy
    (saves a copy back), or None.  ``route`` is :func:`launch_route`'s
    choice for the state's sizes, or the route asked for (a key of
    ``LAUNCHERS``: a launch the card refuses then raises).  ``sections``:
    an int64 CUDA tensor of ``len(SECTIONS)`` for the profiling build,
    or None."""

    name = "cycle_step"
    LEAVES = LEAVES
    ROUTES = tuple(LAUNCHERS)
    SECTIONS = True
    Args = Args

    def __init__(self, cfg, st, ir, image=None, route=None, sections=None,
                 report: bool = False):
        super().__init__(cfg, st, ir, image, route, sections)
        # a rank of a sharded run (compile_cache.Shard): each K-block
        # reports its wide and window-dependent DMAs and G, may take the
        # agreed windows instead of its own, and catch-up launches hold go
        # true (the resident route's Args.report / forced / go_floor)
        self.report = None
        if report:
            if self.route != "resident":
                raise ValueError("a sharded run's blocks take the resident "
                                 f"route, not {self.route!r}")
            # a report and a forced word a step for each parity: launch
            # n + 1 writes its own while launch n's is read
            self.report = [None, None]
            self.forced = [None, None]

    def block(self, k: int, forced=None) -> int:
        """Queue one launch of ``k`` steps of a sharded run's block
        (``forced``: (k, slots) bools, the agreed windows of a replay);
        returns its parity, for :meth:`block_bits`."""
        p = self.args.parity
        if self.report[p] is None or self.report[p].numel() < 2 * k + 1:
            self.report[p] = torch.zeros(2 * k + 1, dtype=torch.int32,
                                         device=self.device)
            self.forced[p] = torch.zeros(k, dtype=torch.int32,
                                         device=self.device)
        self.report[p].zero_()
        self.args.report = self.report[p].data_ptr()
        self.args.forced = 0
        if forced is not None:
            bits = (np.asarray(forced, np.int64)
                    << np.arange(forced.shape[1])).sum(1)
            self.forced[p][:k].copy_(torch.from_numpy(bits.astype(np.int32)))
            self.args.forced = self.forced[p].data_ptr()
        self.args.go_floor = 0
        return self.run(k)

    def block_bits(self, parity: int, k: int) -> tuple:
        """What the block launched as ``parity`` reported: (G, the
        predicate after it, (k, slots) wide bits, (k, slots) bits of the
        DMAs that depended on the window); waits for that launch alone."""
        run_after = self.flag_of(parity)
        rep = self.report[parity][:2 * k + 1].cpu().numpy()
        ss = np.arange(self.cfg.superscalar)
        return (int(rep[2 * k]), run_after,
                ((rep[:k, None] >> ss) & 1).astype(bool),
                ((rep[k:2 * k, None] >> ss) & 1).astype(bool))

    def catch_up(self, n: int) -> None:
        """One launch of ``n`` steps with ``go`` held true (every DPU of
        the block stopped: each takes them with nothing to issue)."""
        self.args.report = 0
        self.args.forced = 0
        self.args.go_floor = n
        self.run(n)
        self.args.go_floor = 0

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
        # one vote a block (a block is one DPU on resident_smem), each
        # DPU's published step or kStopped, each step's DMA-width votes
        # and (stepwise) the predicate word (the kernels leave them zero
        # for the next launch), each DPU's ring of issue plans
        # (resident_smem); the last two sized by call
        self.partial = torch.zeros(D, dtype=torch.int32, device=self.device)
        self.prog = torch.zeros(D, dtype=torch.int64, device=self.device)
        self.wide = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.ring = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.args.partial = self.partial.data_ptr()
        self.args.prog = self.prog.data_ptr()

    def configure(self, cfg, st, P):
        D, T = st["status"].shape
        route(cfg, T)
        self._dims = (D, T, st["wram"].shape[1], cfg.atomic_bits)
        fields, inv_bw, inv_win = config_fields(
            cfg, D, T, st["wram"].shape[1], st["mram"].shape[1], P, 1)
        for i, v in enumerate(fields):
            self.args.c[i] = v
        self.args.inv_bw = float(inv_bw)
        self.args.inv_win = float(inv_win)
        self.args.base = 0
        return CONFIG.index("K")

    def library(self):
        k_step.library(self.sections is not None)

    def pick_route(self):
        return launch_route(*self._dims)

    def call(self, stream):
        k = self.args.c[self._k]
        if self.route == "resident_carry" and not self.args.carry:
            # the picker's factor; asked for below the resident limit, 2;
            # past what the card holds, 2 and a refused launch
            D, T = self._dims[:2]
            self.args.carry = carry_factor(D, T, k_step.card_limits(T)) or 2
        if k + 1 > self.wide.numel():
            self.wide = torch.zeros(k + 1, dtype=torch.int32,
                                    device=self.device)
            self.args.wide = self.wide.data_ptr()
        if self.route == "resident_smem" and k > self.args.ring_k:
            # a new ring holds no tag of this run's steps: zero is none
            self.ring = torch.zeros(self._dims[0] * k, dtype=torch.int64,
                                    device=self.device)
            self.args.ring = self.ring.data_ptr()
            self.args.ring_k = k
        LIB.launch(self.route, self.args, stream, self.sections is not None)
        self.args.base += k     # steps are numbered across launches

    def count(self):
        global launches
        launches += 1

    def count_idle(self):
        global idle_launches
        idle_launches += 1


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

