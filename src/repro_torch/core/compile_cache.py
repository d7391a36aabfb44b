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
from repro_torch.core import engine
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
                  all_done: bool = False, ndpus_reg: int = None):
    """Initial state padded to the DPU bucket, masked lanes DONE (host
    numpy).

    ``ndpus_reg`` overrides the ``N_DPUS`` register the kernels read —
    runtime state, not part of any cache key."""
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
# introspection (tests + benchmarks)
# ---------------------------------------------------------------------------


def stats() -> Dict[str, float]:
    """Cache counters.  ``misses`` counts driver builds — a same-shape
    relaunch must leave it unchanged; ``steps`` counts engine steps taken
    by every driver (K per launch of the fused kernel on the card, the
    steps past the predicate included); ``loop_s`` is the wall seconds
    every driver spent in its K-step loops (on the card, the kernel
    launches and flag reads).  Each but ``entries`` is cumulative until
    :func:`clear`: a caller reads a run's share as the delta across it."""
    with _LOCK:
        return {
            "entries": len(_ENTRIES),
            "hits": _HITS,
            "misses": _MISSES,
            "launches": sum(e.launches for e in _ENTRIES.values()),
            "steps": sum(e.steps for e in _ENTRIES.values()),
            "loop_s": sum(e.loop_s for e in _ENTRIES.values()),
        }


def cache_info():
    """Per-entry detail: key, launch count, steps, devices built for."""
    with _LOCK:
        return [{"key": e.key, "launches": e.launches, "steps": e.steps,
                 "devices": sorted(e.drivers)}
                for e in _ENTRIES.values()]


def clear():
    """Drop every cached driver and zero the counters (tests)."""
    global _HITS, _MISSES
    with _LOCK:
        _ENTRIES.clear()
        _HITS = 0
        _MISSES = 0
