"""Engine-driver cache: every simulation of the port enters the engine here.

The port of :mod:`repro.core.compile_cache`, with the same keys, buckets
and counters.  Torch runs eagerly, so there is no executable to compile;
what a cache entry holds is the step driver built for each device it has
run on (the step closure and its device-resident isa tables), so a warm
relaunch rebuilds nothing.

* **Keys** — ``(backend, DPUConfig.static_key(), program bucket, DPU
  bucket, tasklet count, MRAM words)``, as in the reference.
* **Shape buckets** — the program axis and the DPU axis are padded to
  power-of-two buckets with masked inactive lanes (``DONE`` status,
  ``STOP``-filled program tail); padded lanes never issue, never touch
  DRAM, and are sliced off before results are returned, so bucketed runs
  are bit-exact vs. unpadded ones.
* **K steps per check** — the driver runs :data:`STEPS_PER_CHECK` steps
  between host reads of the termination predicate: one host sync per K
  simulated cycles, not one per cycle.  The step is gated on the
  predicate on the device, so the steps taken after it turned false
  change nothing.
* **The fused kernel** — on the card every K-step block is one launch of
  the backend's hand-written kernel (:meth:`~repro_torch.core.backend
  .ExecBackend.card_kernel`: :mod:`repro_torch.kernels.cycle_step` for
  the scalar engine, the ALU inside it; :mod:`~repro_torch.kernels
  .simt_step` for the SIMT engine and the all-bank compat target;
  :mod:`~repro_torch.kernels.crf_step` for the CRF command model),
  which writes the predicate into a flag in pinned host memory; the
  host queues launch n + 1 before it reads launch n's flag, so the card
  does not wait for the host between blocks; the one launch queued past
  the end changes nothing (no DPU runs), and its steps are not counted.  A
  backend without a kernel raises there.  On the CPU the plain step runs, traced once per launch
  (:func:`_traced_step`) so Python leaves the loop.
* **Devices** — ``device=None`` means the CUDA card; without one every
  entry point raises instead of running on the CPU.  ``device="cpu"``
  asks for the CPU.

The reference donates the state buffers to XLA; here the state is built
per launch and the step updates its WRAM/MRAM tensors in place instead.

:func:`prepare` sets a launch up as :func:`run` drives it (profilers use
it); :func:`prewarm` builds an entry ahead of time; :func:`stats` exposes
the hit/miss counters the tests assert on, plus the steps the driver
took and the wall it spent in its K-step loops (``loop_s``: a caller that
reads its delta across a run tells the run's set-up, the state and MRAM
image to the device and back and the host's work, from its simulation).
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core import engine, isa
from repro_torch.core.backend import resolve_backend
from repro_torch.core.carry import (resolve_device, state_to_numpy,
                                    state_to_torch)
from repro_torch.core.config import DPUConfig

#: smallest padded program length (instruction slots)
PROGRAM_BUCKET_FLOOR = 64
#: smallest padded DPU-axis width
DPU_BUCKET_FLOOR = 1
#: simulated cycles (steps) between host checks of the termination predicate
STEPS_PER_CHECK = 64


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def program_bucket(n_instrs: int, capacity: int) -> int:
    """Padded program length for an ``n_instrs``-long kernel.

    One slot past the program is always included (when capacity allows)
    so a fall-through off the last instruction still lands on the
    assembler's ``STOP`` padding, exactly as with full-capacity images."""
    return min(int(capacity), pow2_bucket(n_instrs + 1, PROGRAM_BUCKET_FLOOR))


def dpu_bucket(n_dpus: int) -> int:
    return pow2_bucket(n_dpus, DPU_BUCKET_FLOOR)


@dataclass
class _Entry:
    """One cached driver: the backend's step and predicate, built once
    per device (``drivers``) for one key."""

    make: Callable
    key: tuple
    launches: int = 0
    steps: int = 0
    loop_s: float = 0.0
    drivers: Dict[str, tuple] = field(default_factory=dict)

    def driver(self, device: torch.device) -> tuple:
        d = self.drivers.get(str(device))
        if d is None:
            d = self.make(device)
            self.drivers[str(device)] = d
        return d


@dataclass
class Prepared:
    """A launch set up as the driver runs it (:func:`prepare`).

    ``st`` is the device state.  On the CPU the first step has run
    eagerly (it builds the per-launch caches) and ``cpu_step`` is the
    step traced over this launch's image.  On CUDA, ``kernel`` is the
    backend's kernel driver over ``st`` (``ExecBackend.card_kernel``,
    e.g. :class:`~repro_torch.kernels.cycle_step.ops.CycleStep`): each
    :meth:`advance` is one launch that updates ``st`` in place, and the
    predicate is the flag the kernel writes; :meth:`finish` runs the
    launch to its end with each launch queued before the last one's flag
    is read.  ``steps`` counts the steps asked for so far."""

    entry: _Entry
    ir: torch.Tensor
    st: Dict[str, torch.Tensor]
    step_fn: Callable
    cond: Callable
    kernel: Optional[object] = None
    cpu_step: Optional[Callable] = None
    steps: int = 0
    pred: Optional[bool] = None

    def running(self) -> bool:
        """The termination predicate (reading it syncs the host)."""
        if self.kernel is None:
            return bool(self.cond(self.st))
        if self.pred is None:
            self.pred = self.kernel.predicate()
        return self.pred

    def advance(self, k: int):
        """``k`` more steps: one kernel launch on CUDA, ``k`` steps of
        the plain version on the CPU.  Gated on the device, so steps past
        the end change nothing."""
        if self.kernel is None:
            step = self.cpu_step or self.step_fn
            for _ in range(k):
                self.st = step(self.ir, self.st)
        else:
            self.kernel.launch(k)
            self.pred = None
        self.steps += k

    def finish(self, k: int) -> None:
        """Advance ``k`` steps a block until the predicate is false.  On
        CUDA the kernel driver's pipelined loop (``drive``): the launch
        queued past the end adds no steps."""
        if self.kernel is None or not self.running():
            while self.running():
                self.advance(k)
            return
        self.steps += k * self.kernel.drive(k)
        self.pred = False


_LOCK = threading.Lock()
_ENTRIES: Dict[tuple, _Entry] = {}
_HITS = 0
_MISSES = 0
# the sharded runs' (run_sharded): votes, replays, catch-ups, loop seconds
_VOTES = 0
_REPLAYS = 0
_CATCH_UPS = 0
_SHARD_LOOP_S = 0.0


def _get_entry(cfg: DPUConfig, be: "backends.ExecBackend", P: int, Dp: int,
               T: int, M: int) -> _Entry:
    global _HITS, _MISSES
    key = (be.name, be.static_key(cfg), P, Dp, T, M)
    with _LOCK:
        entry = _ENTRIES.get(key)
        if entry is None:
            _MISSES += 1
            entry = _Entry(make=lambda dev: be.step_driver(cfg, T, dev),
                           key=key)
            _ENTRIES[key] = entry
        else:
            _HITS += 1
        return entry


def _padded_state(cfg: DPUConfig, be: "backends.ExecBackend", binary,
                  wram_init, mram_init, T: int, Dp: int,
                  all_done: bool = False, ndpus_reg: int = None,
                  dpu_base: int = 0):
    """Initial state padded to the DPU bucket, masked lanes DONE (host
    numpy).

    ``ndpus_reg`` overrides the ``N_DPUS`` register the kernels read —
    runtime state, not part of any cache key; ``dpu_base`` is added to the
    ``DPU_ID`` register of the scalar engine's DPUs (a rank's block of a
    sharded run keeps the global ids)."""
    D = cfg.n_dpus
    if Dp != D:
        wram_init = np.concatenate(
            [wram_init, np.zeros((Dp - D, wram_init.shape[1]), np.int32)])
        mram_init = np.concatenate(
            [mram_init, np.zeros((Dp - D, mram_init.shape[1]), np.int32)])
        cfg = cfg.replace(n_dpus=Dp)
    st = be.make_state(cfg, binary, wram_init, mram_init, T)
    if Dp != D:
        be.pad_lanes(cfg, st, D)                # masked lanes never issue
    if ndpus_reg is not None:
        be.set_ndpus(st, D, ndpus_reg)
    if dpu_base:
        st["regs"][:D, :, isa.R_DPU] += dpu_base
    if all_done:
        be.finish_all(st)
    return st


def prepare(cfg: DPUConfig, binary, wram_init, mram_init,
            n_threads: int = None, backend: str = None, pad: bool = True,
            ndpus_reg: int = None, device=None,
            all_done: bool = False) -> Prepared:
    """Set a launch up as :func:`run` drives it: look up (or build) the
    cache entry, pad the state to the buckets, place it and the
    instruction image on ``device``; on the CPU take the first step, on
    CUDA set the backend's kernel up over the state.  The arguments are
    :func:`run`'s; ``all_done`` marks every lane DONE (:func:`prewarm`)."""
    device = resolve_device(device)
    be = backends.get(resolve_backend(cfg, backend))
    T = n_threads or cfg.n_tasklets
    be.validate(cfg, binary, T)
    wram_init = np.ascontiguousarray(np.asarray(wram_init, np.int32))
    mram_init = np.ascontiguousarray(np.asarray(mram_init, np.int32))
    capacity = binary.opcode.shape[0]
    P = program_bucket(binary.n_instrs, capacity) if pad else capacity
    Dp = dpu_bucket(cfg.n_dpus) if pad else cfg.n_dpus
    st0 = _padded_state(cfg, be, binary, wram_init, mram_init, T, Dp,
                        all_done=all_done, ndpus_reg=ndpus_reg)
    entry = _get_entry(cfg, be, P, Dp, T, mram_init.shape[1])
    ir_np = np.stack([np.asarray(a[:P], np.int32) for a in binary.arrays])
    ir = torch.from_numpy(ir_np).to(device)
    step, cond = entry.driver(device)
    prep = Prepared(entry, ir, state_to_torch(st0, device), step, cond)
    if device.type == "cuda":
        prep.kernel = be.card_kernel(cfg, prep.st, ir, ir_np)
        alive = (st0["status"] != engine.DONE).any(-1) \
            & (st0["cycle"] < cfg.max_cycles)
        prep.pred = bool(alive.any())
    elif prep.running():
        prep.advance(1)
        prep.cpu_step = _traced_step(step, ir, prep.st)
    return prep


def _traced_step(step: Callable, ir: torch.Tensor,
                 st: Dict[str, torch.Tensor]) -> Callable:
    """``step`` as a TorchScript trace taken on a copy of ``st``: the same
    torch operations in the same order (so the same bits), run without
    the Python interpreter between them: ~1.7x faster than the eager
    step at a few DPUs.  The trace holds the image ``ir`` decoded (the step's
    constants), so it serves one launch."""
    keys = tuple(st)

    def flat(ir, *leaves):
        out = step(ir, dict(zip(keys, leaves)))
        return tuple(out[k] for k in keys)

    with warnings.catch_warnings():     # deprecated in favour of compile
        warnings.simplefilter("ignore", DeprecationWarning)
        traced = torch.jit.trace(flat, (ir,) + tuple(st[k].clone()
                                                     for k in keys),
                                 check_trace=False)

    def run(ir, st):
        return dict(zip(keys, traced(ir, *(st[k] for k in keys))))

    return run


def _drive(prep: Prepared, k: int) -> Dict[str, torch.Tensor]:
    """Run a prepared launch to termination, ``k`` steps per check (its
    wall, from the state on the device to the predicate false, added to
    the entry's ``loop_s``)."""
    t0 = time.perf_counter()
    prep.finish(k)                 # one flag read per k steps
    prep.entry.steps += prep.steps
    prep.entry.launches += 1
    prep.entry.loop_s += time.perf_counter() - t0
    return prep.st


def run(cfg: DPUConfig, binary, wram_init, mram_init, n_threads: int = None,
        backend: str = None, pad: bool = True, ndpus_reg: int = None,
        device=None, steps_per_check: int = None) -> Dict[str, np.ndarray]:
    """Simulate ``binary`` to completion through the driver cache.

    * ``backend`` — a registered backend name (default:
      :func:`~repro_torch.core.backend.resolve_backend`);
    * ``pad=False`` disables shape bucketing (exact shapes; used by the
      bit-exactness tests as the unpadded reference);
    * ``ndpus_reg`` overrides the ``N_DPUS`` register;
    * ``device`` — torch device (None = the CUDA card, see
      :func:`resolve_device`);
    * ``steps_per_check`` — steps between predicate checks (default
      :data:`STEPS_PER_CHECK`; the result does not depend on it).

    Returns the final state as a host-numpy pytree sliced back to the
    logical ``cfg.n_dpus`` rows."""
    out = state_to_numpy(_drive(
        prepare(cfg, binary, wram_init, mram_init, n_threads, backend, pad,
                ndpus_reg, device),
        steps_per_check or STEPS_PER_CHECK))
    if out["status"].shape[0] != cfg.n_dpus:
        out = {k: v[:cfg.n_dpus] for k, v in out.items()}
    return out


def prewarm(cfg: DPUConfig, binary, mram_words: int = None,
            n_threads: int = None, backend: str = None,
            device=None) -> tuple:
    """Build (or look up) the driver a later :func:`run` will use, on
    ``device``, without simulating anything: launches an all-``DONE``
    state, so the driver stops at its first predicate check.  Returns
    the cache key.

    ``mram_words`` must match the MRAM image width of the real launch
    (default: ``cfg.mram_words``)."""
    M = mram_words or cfg.mram_words
    wram = np.zeros((cfg.n_dpus, 1), np.int32)
    mram = np.zeros((cfg.n_dpus, M), np.int32)
    prep = prepare(cfg, binary, wram, mram, n_threads, backend,
                   device=device, all_done=True)
    _drive(prep, STEPS_PER_CHECK)
    if prep.ir.device.type == "cuda":
        torch.cuda.synchronize(prep.ir.device)
    return prep.entry.key


# ---------------------------------------------------------------------------
# The DPU axis split over the ranks of a process group
# ---------------------------------------------------------------------------


def dpu_block(n_dpus: int, world: int, rank: int) -> tuple:
    """(first DPU, one past the last) of ``rank``'s block of ``n_dpus``
    DPUs split over ``world`` ranks in order (the first ``n_dpus %
    world`` blocks one DPU larger)."""
    q, r = divmod(n_dpus, world)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


@dataclass
class BlockBits:
    """What a K-block told of a rank's DPUs: ``G``, the first step at
    which none of them ran (K: some ran through); ``run_after``, whether
    one still runs after it; per step and issue slot, whether one's DMA
    was wide (``wide``) and whether one's DMA depends on the window
    (``clip``, ``engine.StepControl``)."""

    G: int
    run_after: bool
    wide: np.ndarray
    clip: np.ndarray


class Shard:
    """This rank's block of DPUs of a run whose DPU axis is split over the
    ranks of ``group`` (:func:`dpu_block`): the scalar engine's state of
    the block (its DPUs keep their global ids and the whole system's
    ``N_DPUS``), padded to its bucket, on ``device`` (``"meta"``: the
    state alone, for the dry-run's count).

    The DPUs are not independent: a stopped DPU still takes steps while
    any DPU runs (``go``), and a DMA's copy window is set by the widest
    DMA of its issue slot on every DPU, which decides what a DMA of
    exactly ``small_dma_words`` that reaches the last word of its row (or
    lies that far below word 0) writes.  Each K-block therefore:

    1. runs its K steps on the block alone (:meth:`block`: ``go`` and the
       widths its own), recording per step whether a DMA was wide and
       whether one depended on the window;
    2. agrees with the other ranks in one all-reduce (:meth:`consensus`,
       a maximum: whether any DPU runs after the block, the first step at
       which none ran, and each step's and slot's wide bit);
    3. where a DMA of this rank depended on the window and the window it
       took is not the one the whole system took, replays the run from
       its start with every K-block's agreed widths so far (deterministic;
       no collective), which must then report what it reported before;
    4. takes the steps it missed with ``go`` true (the first step at
       which no DPU of any rank ran, from the first at which none of its
       own did): its stopped DPUs' retirements, barrier releases, port
       drains and time series (:meth:`catch_up`).

    Every rank takes part in every vote until no DPU of any rank runs;
    the next K-block is queued before a vote (:meth:`run`).
    On the card each K-block is one launch of ``cycle_step`` on the
    resident route, its widths forced from a device word a step on a
    replay, and the catch-up a launch of as many steps with ``go`` held
    true (``ops.CycleStep``'s ``report`` / ``forced`` / ``go_floor``)."""

    def __init__(self, cfg: DPUConfig, binary, wram_init, mram_init,
                 n_threads: int, group, device=None, ndpus_reg: int = None):
        import torch.distributed as dist

        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        lo, hi = dpu_block(cfg.n_dpus, self.world, self.rank)
        self.lo, self.hi = lo, hi
        self.cfg = cfg.replace(n_dpus=hi - lo)
        self.T = n_threads or cfg.n_tasklets
        self.K = STEPS_PER_CHECK
        self.SS = cfg.superscalar
        be = backends.get(resolve_backend(self.cfg))
        if be.name != "scalar":
            raise ValueError(f"a sharded run takes the scalar engine, not "
                             f"{be.name!r}")
        be.validate(self.cfg, binary, self.T)
        self._be, self.binary = be, binary
        self._inputs = (np.ascontiguousarray(np.asarray(
            wram_init, np.int32)[lo:hi]), np.ascontiguousarray(np.asarray(
                mram_init, np.int32)[lo:hi]))
        self._ndpus = cfg.n_dpus if ndpus_reg is None else ndpus_reg
        self.log = []            # (this rank's BlockBits, agreed BlockBits)
        self.replays = 0
        self.catch_ups = 0       # catch-ups taken (on the card, launches)
        self._start()

    def _start(self):
        """The block's initial state on the device."""
        cfg, be = self.cfg, self._be
        capacity = self.binary.opcode.shape[0]
        P = program_bucket(self.binary.n_instrs, capacity)
        Dp = dpu_bucket(cfg.n_dpus)
        st0 = _padded_state(cfg, be, self.binary, *self._inputs, self.T, Dp,
                            ndpus_reg=self._ndpus, dpu_base=self.lo)
        self.st = state_to_torch(st0, self.device)
        ir_np = np.stack([np.asarray(a[:P], np.int32)
                          for a in self.binary.arrays])
        self.ir = torch.from_numpy(ir_np).to(self.device)
        self.kernel = None
        if self.device.type == "cuda":
            from repro_torch.kernels.cycle_step import ops as step_ops
            self.kernel = step_ops.CycleStep(
                cfg, self.st, self.ir, ir_np,
                route="resident", report=True)
        elif self.device.type != "meta":
            entry = _get_entry(cfg, be, P, Dp, self.T,
                               self._inputs[1].shape[1])
            self.step, self.cond = entry.driver(self.device)

    # ---- one K-block ----
    def launch(self, forced: np.ndarray = None):
        """Queue K steps of this rank's DPUs (``forced``: each step's and
        slot's agreed wide bit, a replay's; None: this rank's own); a
        token for :meth:`bits` (on the CPU the steps run now)."""
        if self.kernel is not None:
            return self.kernel.block(self.K, forced)
        return self._cpu_block(forced)

    def bits(self, token) -> BlockBits:
        """The :class:`BlockBits` of the K-block ``token`` stands for."""
        if self.kernel is not None:
            return BlockBits(*self.kernel.block_bits(token, self.K))
        return token

    def block(self, forced: np.ndarray = None) -> BlockBits:
        return self.bits(self.launch(forced))

    def _cpu_block(self, forced) -> BlockBits:
        K, SS = self.K, self.SS
        wide = np.zeros((K, SS), bool)
        clip = np.zeros((K, SS), bool)
        G = K
        for t in range(K):
            if not bool(self.cond(self.st)):
                G = t           # the steps left change nothing here
                break
            ctl = engine.StepControl(
                wide=None if forced is None else forced[t])
            self.st = self.step(self.ir, self.st, ctl)
            wide[t], clip[t] = ctl.wide_bits, ctl.clip_bits
        return BlockBits(G, bool(self.cond(self.st)), wide, clip)

    def catch_up(self, n: int) -> None:
        """``n`` steps with ``go`` true and no DPU of this rank running."""
        if n <= 0:
            return
        self.catch_ups += 1
        if self.kernel is not None:
            self.kernel.catch_up(n)
            return
        for _ in range(n):
            self.st = self.step(self.ir, self.st, engine.StepControl(go=True))

    def consensus(self, bits: BlockBits = None) -> BlockBits:
        """The whole system's :class:`BlockBits` (``clip`` this rank's): a
        maximum over the ranks of [run_after, G, wide bits], one
        all-reduce of ``2 + K * superscalar`` int32 (on meta, without
        ``bits``: the exchange alone, the dry-run's count)."""
        from repro_torch.parallel import collectives as coll

        n = 2 + self.K * self.SS
        if bits is None:
            v = torch.zeros(n, dtype=torch.int32, device="meta")
            coll.max_over(v, self.group)
            return None
        v = np.concatenate([[int(bits.run_after), bits.G],
                            bits.wide.reshape(-1).astype(np.int32)])
        dev = _comm_device(self.group, self.device)
        got = coll.max_over(torch.tensor(v, dtype=torch.int32, device=dev),
                            self.group).cpu().numpy()
        return BlockBits(int(got[1]), bool(got[0]),
                         got[2:].reshape(self.K, self.SS).astype(bool),
                         bits.clip)

    def _replay(self) -> None:
        """The run again from its start with every K-block's agreed
        widths; each block must report what it reported the first time."""
        self.replays += 1
        self._start()
        for mine, agreed in self.log:
            got = self.block(agreed.wide)
            if got.G != mine.G or not np.array_equal(got.wide, mine.wide):
                raise RuntimeError(
                    "a replay with the system's DMA windows changed this "
                    "rank's own steps (where its DPUs stop, or their DMAs' "
                    "widths): the ranks would have to agree again")
            self.catch_up(agreed.G - got.G)

    def run(self) -> Dict[str, torch.Tensor]:
        """Every K-block to the end; returns the block's final state (on
        the device).  ``loop_s``: its wall.

        Block n + 1 is queued before block n's bits are read and agreed:
        where block n then needs a catch-up, none of this rank's DPUs ran
        past it, so block n + 1 changed nothing and the catch-up may
        follow it; where it needs a replay, the replay starts the state
        again and block n + 1 is queued anew; after the last block it is
        a launch in which no DPU runs."""
        t0 = time.perf_counter()
        pending = self.launch()
        while True:
            queued = self.launch()
            mine = self.bits(pending)
            agreed = self.consensus(mine)
            self.log.append((mine, agreed))
            if (mine.clip & (mine.wide != agreed.wide)).any():
                self._replay()
                queued = self.launch()
            else:
                self.catch_up(agreed.G - mine.G)
            if not agreed.run_after:
                if self.kernel is not None:
                    torch.cuda.synchronize(self.device)
                self.loop_s = time.perf_counter() - t0
                return self.st
            pending = queued


def _comm_device(group, device) -> torch.device:
    """Where a collective over ``group`` takes its tensors: ``device`` (the
    card) where the group has an NCCL backend, else the host (gloo)."""
    import torch.distributed as dist

    if "nccl" in str(dist.get_backend(group)):
        return torch.device(device)
    return torch.device("cpu")


def gather_blocks(block: Dict[str, np.ndarray], n_dpus: int, group,
                  device=None) -> Dict[str, np.ndarray]:
    """The whole system's state from every rank's block (host numpy, this
    rank's DPU rows): each leaf gathered over ``group`` in rank order (on
    ``device``, the card, where the group's backend is NCCL)."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as coll

    world = dist.get_world_size(group)
    spans = [dpu_block(n_dpus, world, r) for r in range(world)]
    rows = max(hi - lo for lo, hi in spans)
    dev = _comm_device(group, device or "cpu")
    out = {}
    for k, v in block.items():
        pad = np.zeros((rows,) + v.shape[1:], v.dtype)
        pad[:v.shape[0]] = v
        got = torch.stack(coll.gather_blocks(torch.from_numpy(pad).to(dev),
                                             group)).cpu().numpy()
        if all(hi - lo == rows for lo, hi in spans):
            out[k] = got.reshape((world * rows,) + v.shape[1:])
        else:
            out[k] = np.concatenate([g[:hi - lo]
                                     for g, (lo, hi) in zip(got, spans)])
    return out


def run_sharded(cfg: DPUConfig, binary, wram_init, mram_init, group,
                n_threads: int = None, ndpus_reg: int = None,
                device=None) -> Dict[str, np.ndarray]:
    """:func:`run` with the DPU axis split over the ranks of ``group``
    (:class:`Shard`): every rank calls it with the whole system's
    arguments and simulates its block.  Returns the whole final state on
    every rank (:func:`gather_blocks`), host numpy; :func:`stats` counts
    its votes, replays and catch-ups."""
    global _VOTES, _REPLAYS, _CATCH_UPS, _SHARD_LOOP_S
    shard = Shard(cfg, binary, wram_init, mram_init, n_threads, group,
                  device, ndpus_reg)
    out = state_to_numpy(shard.run())
    with _LOCK:
        _VOTES += len(shard.log)
        _REPLAYS += shard.replays
        _CATCH_UPS += shard.catch_ups
        _SHARD_LOOP_S += shard.loop_s
    return gather_blocks({k: v[:shard.hi - shard.lo] for k, v in out.items()},
                         cfg.n_dpus, group, shard.device)


# ---------------------------------------------------------------------------
# introspection (tests + benchmarks)
# ---------------------------------------------------------------------------


def stats() -> Dict[str, float]:
    """Cache counters.  ``misses`` counts driver builds — a same-shape
    relaunch must leave it unchanged; ``steps`` counts engine steps taken
    by every driver (K per launch of the fused kernel on the card, the
    steps past the predicate included); ``loop_s`` is the wall seconds
    every driver spent in its K-step loops (on the card, the kernel
    launches and flag reads).  Each but ``entries`` is cumulative until
    :func:`clear`: a caller reads a run's share as the delta across it.
    ``votes``, ``replays`` and ``catch_ups`` count what the ranks of a
    sharded run (:func:`run_sharded`) agreed, replayed and caught up;
    its K-block loop's wall is in ``loop_s``."""
    with _LOCK:
        return {
            "entries": len(_ENTRIES),
            "hits": _HITS,
            "misses": _MISSES,
            "launches": sum(e.launches for e in _ENTRIES.values()),
            "steps": sum(e.steps for e in _ENTRIES.values()),
            "loop_s": (sum(e.loop_s for e in _ENTRIES.values())
                       + _SHARD_LOOP_S),
            "votes": _VOTES,
            "replays": _REPLAYS,
            "catch_ups": _CATCH_UPS,
        }


def cache_info():
    """Per-entry detail: key, launch count, steps, devices built for."""
    with _LOCK:
        return [{"key": e.key, "launches": e.launches, "steps": e.steps,
                 "devices": sorted(e.drivers)}
                for e in _ENTRIES.values()]


def clear():
    """Drop every cached driver and zero the counters (tests)."""
    global _HITS, _MISSES, _VOTES, _REPLAYS, _CATCH_UPS, _SHARD_LOOP_S
    with _LOCK:
        _ENTRIES.clear()
        _HITS = _MISSES = _VOTES = _REPLAYS = _CATCH_UPS = 0
        _SHARD_LOOP_S = 0.0
