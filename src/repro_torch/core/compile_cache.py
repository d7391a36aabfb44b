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
* **CUDA graphs** — on the card, the steps after the first replay the
  step as CUDA-graph segments around its ALU calls (:class:`_StepGraph`);
  the ALU kernel is launched between them through its counting wrapper.
  On the CPU every step runs eagerly.
* **Devices** — ``device=None`` means the CUDA card; without one every
  entry point raises instead of running on the CPU.  ``device="cpu"``
  asks for the CPU.

The reference donates the state buffers to XLA; here the state is built
per launch and the step updates its WRAM/MRAM tensors in place instead.

:func:`prepare` sets a launch up as :func:`run` drives it (profilers use
it); :func:`prewarm` builds an entry ahead of time; :func:`stats` exposes
the hit/miss counters the tests assert on, plus the steps the driver
took.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core.backend import resolve_backend
from repro_torch.core.carry import (resolve_device, state_to_numpy,
                                    state_to_torch)
from repro_torch.core.config import DPUConfig
from repro_torch.kernels.alu_exec.ops import alu_exec

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

    ``st`` is the device state after the first step, which runs eagerly
    (it builds the per-launch caches).  On CUDA, while the run goes on,
    ``graph`` holds the step captured as a :class:`_StepGraph` over that
    state; its replays update ``st`` in place.  ``steps`` counts the
    steps taken so far."""

    entry: _Entry
    ir: torch.Tensor
    st: Dict[str, torch.Tensor]
    step_fn: Callable
    cond: Callable
    graph: Optional["_StepGraph"] = None
    steps: int = 0

    def running(self) -> bool:
        """The termination predicate (reading it syncs the host)."""
        return bool(self.cond(self.st))

    def step(self):
        """One more step: a graph replay on CUDA, an eager step on the
        CPU.  Gated on the device, so a step past the end changes
        nothing."""
        if self.graph is None:
            self.st = self.step_fn(self.ir, self.st)
        else:
            self.graph.replay()
        self.steps += 1


class _StepGraph:
    """One engine step captured as CUDA-graph segments around its ALU
    calls: segment 0, ALU, segment 1, ..., ALU, last segment.

    Eager torch issues each op of a step as its own launch from Python,
    and the host's dispatch, not the card, bounds the step.  A replay
    launches a whole segment at once.  The ALU kernel stays outside the
    graphs: :meth:`replay` launches it through its wrapper between
    segments (into a static output buffer), so every launch is counted
    where it happens.  The segments read the static state ``st`` and the
    last one copies the step's result back into it, so replays chain."""

    def __init__(self, step, ir, st: Dict[str, torch.Tensor]):
        self.graphs, self.reqs, self.outs = [], [], []
        gen = step.coro(ir, st)
        pool = None
        while True:
            g = torch.cuda.CUDAGraph()
            req = None
            with torch.cuda.graph(g, pool=pool):
                try:
                    req = gen.send(self.outs[-1] if self.outs else None)
                except StopIteration as done:
                    for key, val in done.value.items():
                        if val is not st[key]:
                            st[key].copy_(val)
            pool = g.pool()
            self.graphs.append(g)
            if req is None:
                break
            self.reqs.append(req)
            self.outs.append(torch.empty_like(req[0]))

    def replay(self):
        self.graphs[0].replay()
        for (op, a, b), out, g in zip(self.reqs, self.outs, self.graphs[1:]):
            alu_exec(op, a, b, out=out)
            g.replay()


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
    instruction image on ``device``, take the first step and, on CUDA if
    the run goes on, capture the step graph.  The arguments are
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
    ir = torch.from_numpy(np.stack([np.asarray(a[:P], np.int32)
                                    for a in binary.arrays])).to(device)
    step, cond = entry.driver(device)
    prep = Prepared(entry, ir, state_to_torch(st0, device), step, cond)
    if prep.running():
        prep.step()
        if device.type == "cuda" and prep.running():
            prep.graph = _StepGraph(step, ir, prep.st)
    return prep


def _drive(prep: Prepared, k: int) -> Dict[str, torch.Tensor]:
    """Run a prepared launch to termination, ``k`` steps per check."""
    while prep.running():          # the one host sync per k steps
        for _ in range(k):
            prep.step()
    prep.entry.steps += prep.steps
    prep.entry.launches += 1
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


def stats() -> Dict[str, int]:
    """Cache counters.  ``misses`` counts driver builds — a same-shape
    relaunch must leave it unchanged; ``steps`` counts engine steps taken
    by every driver (each issues ``cfg.superscalar`` ALU calls)."""
    with _LOCK:
        return {
            "entries": len(_ENTRIES),
            "hits": _HITS,
            "misses": _MISSES,
            "launches": sum(e.launches for e in _ENTRIES.values()),
            "steps": sum(e.steps for e in _ENTRIES.values()),
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
