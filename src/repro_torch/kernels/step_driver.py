"""What the step kernels' drivers share: a launch's state on the card,
checked once (every leaf's device, dtype, shape and contiguity), advanced
K steps a launch, the predicate read from a flag the kernel writes; and,
for the kernels with routes (``cycle_step``, ``simt_step``,
``crf_step``), their library (:class:`StepLibrary`), a resident_smem
block's shared memory (:func:`smem_route_bytes`) and the card's limits on
it (:class:`RouteLimits`, :func:`smem_dpus_of`).

A subclass names its kernel (``name``), its routes (``ROUTES``, in the
order its picker prefers them), its leaves and their table (``LEAVES``,
:meth:`leaf_table`), the state keys the plain version's state has
(:meth:`state_keys`), its ``Args`` structure, its configuration
(:meth:`configure`), its library, its route picker (:meth:`pick_route`)
and its C launcher (:meth:`call`), and its launch counts (:meth:`count`,
:meth:`count_idle`).  By default a launch is the SIMT and CRF kernels'
global scheme: two ordinary kernels (a run kernel that steps each
simulated DPU while it runs, and a tail kernel that gives the DPUs that
stopped early their gated steps and writes the predicate;
``csrc/simt_step.cu`` and ``csrc/crf_step.cu`` explain it).

The flag is two int32 words of pinned host memory that the kernel writes
through the card's unified addressing: launch n writes word n % 2 (its
parity).  So :meth:`StepDriver.drive` queues launch n + 1 before it reads
launch n's word (:func:`drive_blocks`), and the card never waits for the
host between K-step blocks.  Every launch is counted where it is made
(:meth:`StepDriver.run`); the one queued past a run's end, in which no
DPU runs, is counted a second time apart (``idle_launches``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.kernels.build import build_library, load_library

#: ptxas reports registers and spills (kept in the build log)
FLAGS = ("-Xptxas", "-v")
#: the profiling build's define: each DPU's lane 0 sums clock64() deltas
#: per section of a step (``step_common.cuh``'s ``enum Section``) into
#: ``Args.sections``
SECTIONS_FLAG = "-DSTEP_SECTIONS"
#: the sections of ``step_common.cuh``'s ``enum Section``: a step's parts
#: in the order it runs them and the swaps of a warp that carries several
#: DPUs, a launch's parts outside its steps, then the steps taken and the
#: launch's cycles
SECTIONS = ("plan", "dram", "issue", "dma", "classify", "park", "load",
            "vote", "store", "steps", "launch")


@dataclass(frozen=True)
class RouteLimits:
    """What a card allows a step kernel's resident routes (bytes, but the
    counts): its SMs, the dynamic shared memory a block may opt in to, the
    shared memory of an SM, what a block of the kernel's resident_smem
    route takes besides its dynamic shared memory (the runtime's
    reservation and the kernel's static shared memory), the blocks of that
    kernel an SM holds at most for its registers and the block limit, and
    (``cycle_step`` only) the DPUs its global-WRAM resident route holds at
    once, and its resident_carry kernel's blocks an SM for its registers
    and the block limit and what a block of it takes besides its dynamic
    shared memory."""

    sms: int
    smem_block: int
    smem_sm: int
    smem_extra: int
    smem_blocks: int
    resident_dpus: int = 0
    carry_blocks: int = 0
    carry_extra: int = 0


#: an H100 SXM's limits, as its CUDA device attributes and occupancy
#: queries give them (``cycle_step.card_limits`` on an NVIDIA H100 80GB
#: HBM3; ``test_route_picker_mirrors_the_card`` checks the picker): 132
#: SMs, 227 KiB of opt-in shared memory a block, 228 KiB an SM, 1 KiB
#: reserved a block plus the cycle step's 32 bytes of static shared memory
#: (the SIMT kernel's 16), 16 blocks an SM of either resident_smem kernel
#: for their registers, the cycle step's resident route's 2,112 DPUs
#: (132 SMs x 4 blocks x 4 DPUs), and its resident_carry kernel's 4
#: blocks an SM (128 registers a thread) and 1 KiB reserved a block plus
#: its 16 bytes of static shared memory (the launch's vote).  What the
#: CPU tests hold the route pickers to.
H100 = RouteLimits(sms=132, smem_block=232448, smem_sm=233472,
                   smem_extra=1024 + 32, smem_blocks=16, resident_dpus=2112,
                   carry_blocks=4, carry_extra=1024 + 16)


def smem_route_bytes(n_threads: int, wram_words: int, atomic_words: int,
                     plan_words: int = 0) -> int:
    """A resident_smem block's dynamic shared memory (bytes): the register
    file and ``plan_words`` of issue plan (the cycle step's), WRAM and the
    atomics, each rounded up to 16 bytes (``smem_route_bytes`` in each
    kernel, which ``StepLibrary.smem_bytes`` reads)."""
    def up4(n):
        return (n + 3) & ~3
    return 4 * (up4(n_threads * isa.N_REGS + plan_words) + up4(wram_words)
                + up4(atomic_words))


def smem_dpus_of(need: int, lim: RouteLimits) -> int:
    """The most DPUs (blocks) of ``need`` bytes of dynamic shared memory
    a card of limits ``lim`` holds at once: 0 when a block cannot have
    them."""
    if need > lim.smem_block:
        return 0
    return lim.sms * min(lim.smem_blocks,
                         lim.smem_sm // (need + lim.smem_extra))


class StepLibrary:
    """A routed step kernel's shared library, built at first use
    (``kernels/build.load_library``) in two variants, the plain build and
    the profiling one (:data:`SECTIONS_FLAG`), each checked once against
    the Python side: ``layout`` maps each ``<name>_<key>()`` the library
    exports to the value it must return, ``launchers`` maps each route to
    its C launcher, ``int f(const Args*, cudaStream_t)``.  Every library
    also exports ``<name>_smem_bytes`` of three ints (T, W, A for the
    DPU kernels; P, rows, W for ``crf_step``) and
    ``<name>_card_limits(int out[5])``."""

    def __init__(self, name: str, sources: Sequence, headers: Sequence,
                 layout: Dict[str, int], launchers: Dict[str, str]):
        self.name, self.sources, self.headers = name, sources, headers
        self.layout, self.launchers = layout, launchers
        self._libs: Dict[bool, ctypes.CDLL] = {}

    def _lib_args(self, sections: bool) -> tuple:
        return (self.name + ("_sections" if sections else ""), self.sources,
                self.headers, FLAGS + ((SECTIONS_FLAG,) if sections else ()))

    def build(self) -> Path:
        """Build the plain library on disk if it is not there yet, without
        loading it into the process (so a later first launch times the
        load and not nvcc); returns its path."""
        return build_library(*self._lib_args(False))

    def load(self, sections: bool = False) -> ctypes.CDLL:
        """Build (once) and load the library (``sections``: the profiling
        build); raises if its layout is not this module's."""
        if sections in self._libs:
            return self._libs[sections]
        lib = load_library(*self._lib_args(sections))
        got = {}
        for key in self.layout:
            fn = getattr(lib, f"{self.name}_{key}")
            fn.argtypes, fn.restype = [], ctypes.c_int
            got[key] = fn()
        bad = {k: (got[k], v) for k, v in self.layout.items() if got[k] != v}
        if bad:
            raise RuntimeError(f"{self.name} library layout differs: {bad}")
        for cname in self.launchers.values():
            fn = getattr(lib, cname)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"{self.name}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        fn = getattr(lib, f"{self.name}_card_limits")
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        self._libs[sections] = lib
        return lib

    def launch(self, route: str, args, stream: int,
               sections: bool = False) -> None:
        """Launch ``args``' K steps on ``stream`` (a ``cudaStream_t`` as
        int) by ``route``.  Raises on a launch error, a refused
        cooperative launch or shared-memory opt-in included."""
        fn = getattr(self.load(sections), self.launchers[route])
        err = fn(ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch ({route}) "
                               f"failed: cudaError {err}")

    def smem_bytes(self, *sizes: int) -> int:
        """The library's own count of a resident_smem block's dynamic
        shared memory (bytes) for its three sizes, which the Python side
        mirrors (:func:`smem_route_bytes`, ``crf_step.smem_bytes``)."""
        return getattr(self.load(), f"{self.name}_smem_bytes")(*sizes)

    def card_limits(self, resident_dpus: int = 0) -> RouteLimits:
        """The current CUDA device's :class:`RouteLimits` for the
        library's resident_smem kernel (``resident_dpus``: the caller's
        global-WRAM resident route's DPUs).  Raises on a CUDA error."""
        out = (ctypes.c_int * 5)()
        err = getattr(self.load(), f"{self.name}_card_limits")(out)
        if err != 0:
            raise RuntimeError(f"{self.name} device query failed: "
                               f"cudaError {-err}")
        return RouteLimits(*out, resident_dpus=resident_dpus)


def drive_blocks(launch: Callable[[], int], flag: Callable[[int], bool],
                 limit: Optional[int] = None) -> Tuple[int, int]:
    """Run launches until one leaves no DPU running, each queued before
    the flag of the one before it is read.  ``launch()`` queues (and
    counts) one launch and returns its token; ``flag(token)`` waits for
    that launch alone and returns its predicate (some DPU still runs
    after it).  The caller knows some DPU runs now.  ``limit``: stop
    after that many launches, none queued past them.

    Returns (the launches that began with a DPU running, the launches
    queued past the end): the launch queued after the one that ended the
    run starts with no DPU running and changes nothing; at ``limit`` there
    is none."""
    prev = launch()
    n = 1
    while limit is None or n < limit:
        cur = launch()              # queued before prev's flag is read
        if not flag(prev):
            return n, 1             # cur started with no DPU running
        n += 1
        prev = cur
    return n, 0


class StepDriver:
    """``run(k)`` (or ``launch(k)``) runs k steps in one counted launch on
    the current stream, ``predicate()`` reads the flag the kernel wrote
    (one host sync), ``drive(k)`` runs to the end with each launch queued
    before the last one's flag is read.

    ``route``: one of ``ROUTES`` asked for (a launch the card refuses
    then raises), or None for :meth:`pick_route`'s.  ``sections``: an
    int64 CUDA tensor that the profiling build (:data:`SECTIONS_FLAG`)
    adds each launch's per-section cycles into, or None (the plain
    build); only for a kernel with ``SECTIONS``."""

    name = "?"
    LEAVES: tuple = ()
    ROUTES: tuple = ("global",)
    SECTIONS = False

    def __init__(self, cfg, st: Dict[str, torch.Tensor], ir: torch.Tensor,
                 image: Optional[np.ndarray] = None,
                 route: Optional[str] = None,
                 sections: Optional[torch.Tensor] = None):
        if route is not None and route not in self.ROUTES:
            raise ValueError(f"{self.name}: no route {route!r}; the routes "
                             f"are {list(self.ROUTES)}")
        if sections is not None and not self.SECTIONS:
            raise ValueError(f"{self.name} has no profiling build")
        dev = st["status"].device if "status" in st else ir.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel runs on CUDA tensors, "
                             f"got {dev}")
        self._check_state(cfg, st, dev)
        if not (ir.device == dev and ir.dtype == torch.int32
                and ir.dim() == 2 and ir.shape[0] == 6 and ir.shape[1] > 0):
            raise ValueError(f"{self.name}: ir must be a (6, P) int32 tensor "
                             f"on {dev}, got {tuple(ir.shape)} {ir.dtype} on "
                             f"{ir.device}")
        if image is None:
            image = ir.cpu().numpy()
        self.cfg, self.ir, self.image_np = cfg, ir, image
        self.route, self.sections = route, sections
        self.st, self.device = st, dev
        self.image = torch.from_numpy(self.pack(cfg, image)).to(dev)
        # the predicate after a launch of parity p, in flag[p]: pinned host
        # memory, which the kernel writes directly (unified addressing)
        self.flag = torch.zeros(2, dtype=torch.int32, pin_memory=True)
        self._flag = self.flag.numpy()
        # each parity's last launch, recorded on the stream after it
        self._done = [torch.cuda.Event(), torch.cuda.Event()]
        self._last = None           # parity of the last launch
        args = self.Args()
        for i, name in enumerate(self.LEAVES):
            args.leaf[i] = st[name].data_ptr()
        args.image = self.image.data_ptr()
        args.flag = self.flag.data_ptr()
        if sections is not None:
            args.sections = sections.data_ptr()
        self.args = args
        self.scratch(st["status"].shape[0])
        self._k = self.configure(cfg, st, ir.shape[1])
        with torch.cuda.device(dev):    # builds the library at first use
            self.library()
            if self.route is None:
                self.route = self.pick_route()

    def like(self, st: Dict[str, torch.Tensor], route: Optional[str] = None,
             sections: Optional[torch.Tensor] = None) -> "StepDriver":
        """A driver of the same kernel, configuration and image over the
        state ``st`` (say, a copy of this one's), on ``route`` (None: this
        one's)."""
        return type(self)(self.cfg, st, self.ir, self.image_np,
                          route=route or self.route, sections=sections)

    # ---- what a kernel provides ----
    def state_keys(self, cfg, st) -> set:
        raise NotImplementedError

    def leaf_table(self, cfg, st) -> dict:
        raise NotImplementedError

    def pack(self, cfg, image: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def scratch(self, D: int) -> None:
        """Allocate the kernel's scratch beside the flag and point
        ``self.args`` at it: each DPU's phase-1 steps and the two votes
        (alternate launches use alternate ones)."""
        self.stop = torch.zeros(D, dtype=torch.int32, device=self.device)
        self.vote = torch.zeros(2, dtype=torch.int32, device=self.device)
        self.args.stop = self.stop.data_ptr()
        self.args.vote = self.vote.data_ptr()

    def configure(self, cfg, st, P: int) -> int:
        """Fill ``self.args``' configuration; return the index of K."""
        raise NotImplementedError

    def library(self):
        raise NotImplementedError

    def pick_route(self) -> str:
        """The route of this launch's sizes on the current device."""
        return self.ROUTES[0]

    def call(self, stream: int) -> None:
        """Launch ``self.args``' K steps on ``stream`` by ``self.route``;
        raises if the card refuses."""
        raise NotImplementedError

    def count(self) -> None:
        """Add one to the kernel's launch count."""
        raise NotImplementedError

    def count_idle(self) -> None:
        """Add one to the kernel's count of launches queued past a run's
        end."""
        raise NotImplementedError

    # ---- the driver ----
    def run(self, k: int) -> int:
        """Advance ``k`` steps in one launch (the kernel stops early once
        no DPU runs), counted once it is queued; returns its parity."""
        if k < 1:
            raise ValueError(f"{self.name}: k = {k} < 1")
        self.args.c[self._k] = k
        stream = torch.cuda.current_stream(self.device)
        self.call(stream.cuda_stream)
        self.count()
        return self._ran(stream)

    def launch(self, k: int) -> None:
        """:meth:`run`, for a caller that reads :meth:`predicate`."""
        self.run(k)

    def _ran(self, stream) -> int:
        """Book the launch just queued on ``stream``: record its event and
        flip the parity for the next one; returns its parity."""
        p = self.args.parity
        self._done[p].record(stream)
        self._last = p
        self.args.parity = p ^ 1
        return p

    def flag_of(self, parity: int) -> bool:
        """The predicate after the last launch of ``parity``: waits for
        that launch alone (the ones queued after it may still run)."""
        self._done[parity].synchronize()
        return bool(self._flag[parity])

    def predicate(self) -> bool:
        """The termination predicate after the last launch (waits for
        it)."""
        if self._last is None:
            raise RuntimeError(f"{self.name}: no launch yet")
        return self.flag_of(self._last)

    def drive(self, k: int, limit: Optional[int] = None) -> int:
        """Launch ``k`` steps at a time until no DPU runs (some DPU runs
        now), each launch queued before the last one's flag is read
        (:func:`drive_blocks`); ``limit``: at most that many launches.
        Returns the launches that began with a DPU running; the one queued
        past the end is counted in :meth:`count_idle` too."""
        n, idle = drive_blocks(lambda: self.run(k), self.flag_of, limit)
        for _ in range(idle):
            self.count_idle()
        return n

    def _check_state(self, cfg, st, dev):
        want = self.state_keys(cfg, st)
        if set(st) != want:
            raise ValueError(
                f"{self.name}: state keys differ from the engine's: missing "
                f"{sorted(want - set(st))}, unexpected {sorted(set(st) - want)}")
        for name, (dtype, shape) in self.leaf_table(cfg, st).items():
            t = st[name]
            if t.device != dev:
                raise ValueError(f"{self.name}: {name} on {t.device}, status "
                                 f"on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"{self.name}: {name} must be {dtype}, got "
                                f"{t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{self.name}: {name} shape "
                                 f"{tuple(t.shape)} != {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {name} must be contiguous")
