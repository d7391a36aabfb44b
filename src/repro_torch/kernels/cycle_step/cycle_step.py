"""CUDA binding of the fused cycle-step kernel (``csrc/cycle_step.cu``).

The kernel runs K whole simulated cycles of every DPU per launch, each
issue slot's ALU on the device function of ``alu_exec.cuh``.  It replaces
no Pallas kernel of its own: it absorbs the ALU kernel
(``repro.kernels.alu_exec``) into the engine step
(``repro.core.engine.make_step_traced``) that called it.  Built with
``nvcc`` for ``sm_90a`` at first use and bound through ctypes.

The kernel reads three things besides the state:

* the state leaves, by pointer, in the order of :data:`LEAVES`;
* the decoded instruction image, 12 int32 per slot (:func:`pack_image`):
  the engine's :func:`~repro_torch.core.engine.decode_image` rows, the
  19 flags packed into one word;
* the configuration, as int32 fields in the order of :data:`CONFIG` and
  the two float32 reciprocals of :class:`~repro_torch.core.engine.StepConsts`
  (:func:`config_fields`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import engine, isa
from repro_torch.core.config import DPUConfig
from repro_torch.kernels.step_driver import RouteLimits, StepLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "cycle_step.cu",)
HEADERS = (CSRC.parents[1] / "alu_exec" / "csrc" / "alu_exec.cuh",
           CSRC.parents[1] / "step_common.cuh")
#: state leaves in the kernel's order (``enum Leaf``), which is
#: ``engine.make_state_np``'s
LEAVES = (
    "cycle", "pc", "regs", "status", "next_issue", "last_dest", "last_ready",
    "port_busy", "rr", "wram", "mram", "atomic", "req_valid", "req_wram",
    "req_mram", "req_bytes", "req_write", "req_enq", "eng_active",
    "eng_thread", "eng_finish", "open_row", "tlb_tags", "tlb_lru", "dc_tags",
    "dc_lru", "dc_dirty", "c_active", "c_idle_mem", "c_idle_rev",
    "c_idle_rf", "c_issued", "c_cls", "c_hist", "c_dma_rd", "c_dma_wr",
    "c_dma_rd_bytes", "c_dma_wr_bytes", "c_row_hit", "c_row_miss",
    "c_tlb_hit", "c_tlb_miss", "c_dc_hit", "c_dc_miss", "c_acq_retry",
    "ts_buf", "ts_acc")

#: int32 fields of the kernel's configuration (``enum Cfg``)
CONFIG = (
    "D", "T", "W", "M", "A", "E", "n_sets", "ways", "L", "P", "K",
    "max_cycles", "row_bytes", "row_hit_overhead", "row_miss_overhead",
    "page_bytes", "line_bytes", "small_dma_words", "revolver_cycles",
    "timeseries_window", "superscalar", "forwarding", "unified_rf", "mmu",
    "cache_mode", "event_skip", "collect_detail")

#: issue slots per cycle the kernel plans (``MAX_SLOTS``) and DPUs (warps)
#: per block (``DPB``)
MAX_SLOTS = 8
DPUS_PER_BLOCK = 4
#: the resident_carry route: the words a carried DPU's lane state takes
#: parked in shared memory (``PARK_WORDS``: 13 rows of 32 per-lane words
#: and 9 words of the DPU's own), and the most DPUs a warp carries
#: (``MAX_CARRY``)
PARK_WORDS = 13 * 32 + 9
MAX_CARRY = 32

#: int32 words per instruction slot of the packed image (``enum Field``):
#: the 10 rows of ``decode_image``'s ints, the flags, one pad word
N_FIELDS = 12

_BOOL_LEAVES = ("req_valid", "req_write", "eng_active", "dc_dirty")
_FLOAT_LEAVES = ("c_dma_rd_bytes", "c_dma_wr_bytes", "ts_buf", "ts_acc")


def leaf_table(cfg: DPUConfig, D: int, T: int, W: int, M: int
               ) -> Dict[str, Tuple[torch.dtype, tuple]]:
    """Every leaf the kernel reads and writes: name -> (dtype, shape), for
    ``D`` DPUs of ``T`` tasklets, ``W`` WRAM and ``M`` MRAM words."""
    n_sets = max(1, cfg.dcache_bytes // cfg.line_bytes // cfg.dcache_ways)
    ways = cfg.dcache_ways if cfg.cache_mode else 1
    sets = n_sets if cfg.cache_mode else 1
    shapes = {
        "regs": (D, T, isa.N_REGS), "wram": (D, W), "mram": (D, M),
        "atomic": (D, cfg.atomic_bits), "tlb_tags": (D, cfg.tlb_entries),
        "tlb_lru": (D, cfg.tlb_entries), "dc_tags": (D, sets, ways),
        "dc_lru": (D, sets, ways), "dc_dirty": (D, sets, ways),
        "c_cls": (D, 6), "c_hist": (D, T + 1),
        "ts_buf": (D, cfg.timeseries_len)}
    per_thread = ("pc", "status", "next_issue", "last_dest", "last_ready",
                  "req_valid", "req_wram", "req_mram", "req_bytes",
                  "req_write", "req_enq")
    table = {}
    for name in LEAVES:
        dtype = (torch.bool if name in _BOOL_LEAVES else torch.float32
                 if name in _FLOAT_LEAVES else torch.int32)
        shape = shapes.get(name, (D, T) if name in per_thread else (D,))
        table[name] = (dtype, shape)
    return table


def pack_image(cfg: DPUConfig, img: np.ndarray) -> np.ndarray:
    """(6, P) instruction image (numpy) -> (P, N_FIELDS) int32: each
    slot's :func:`~repro_torch.core.engine.decode_image` fields, then its
    19 flags as bits of one word.  Raises ``ValueError`` if a register
    field lies outside [0, N_REGS): the kernel reads the register file of
    the issuing tasklet only."""
    ints, flags = engine.decode_image(cfg, np.asarray(img, np.int32))
    regs = ints[:3]
    if regs.size and (regs.min() < 0 or regs.max() >= isa.N_REGS):
        raise ValueError("cycle_step: the instruction image names a "
                         f"register outside [0, {isa.N_REGS})")
    P = ints.shape[1]
    out = np.zeros((P, N_FIELDS), np.int32)
    out[:, :10] = ints.T
    out[:, 10] = (flags.astype(np.int64)
                  << np.arange(flags.shape[0])[:, None]).sum(0)
    return out


def config_fields(cfg: DPUConfig, D: int, T: int, W: int, M: int, P: int,
                  K: int) -> Tuple[list, np.float32, np.float32]:
    """(int32 fields in :data:`CONFIG` order, inv_bw, inv_win): the
    constants a launch passes, the reciprocals built as ``StepConsts``
    builds them (XLA's x / c -> x * (1/c) in float32)."""
    table = leaf_table(cfg, D, T, W, M)
    _, sets, ways = table["dc_tags"][1]
    vals = dict(
        D=D, T=T, W=W, M=M, A=cfg.atomic_bits, E=cfg.tlb_entries,
        n_sets=sets, ways=ways, L=cfg.timeseries_len, P=P, K=K,
        row_hit_overhead=cfg.row_hit_overhead,
        row_miss_overhead=cfg.row_miss_overhead)
    fields = [int(vals[n]) if n in vals else int(getattr(cfg, n))
              for n in CONFIG]
    inv_bw = np.float32(1) / np.float32(cfg.effective_mram_bw)
    inv_win = np.float32(1) / np.float32(cfg.timeseries_window)
    return fields, inv_bw, inv_win


class Args(ctypes.Structure):
    """The kernel's ``struct Args``, passed by value."""

    _fields_ = [("leaf", ctypes.c_void_p * len(LEAVES)),
                ("image", ctypes.c_void_p),
                ("partial", ctypes.c_void_p),
                ("flag", ctypes.c_void_p),
                ("prog", ctypes.c_void_p),
                ("wide", ctypes.c_void_p),
                ("ring", ctypes.c_void_p),
                ("sections", ctypes.c_void_p),
                ("base", ctypes.c_int64),
                ("parity", ctypes.c_int32),
                ("ring_k", ctypes.c_int32),
                ("c", ctypes.c_int32 * len(CONFIG)),
                ("inv_bw", ctypes.c_float),
                ("inv_win", ctypes.c_float),
                ("carry", ctypes.c_int32),
                ("report", ctypes.c_void_p),
                ("forced", ctypes.c_void_p),
                ("go_floor", ctypes.c_int32)]


#: how a launch orders the DPUs -> its C launcher: ``"resident_smem"``,
#: one cooperative launch of K steps, one DPU a block with its WRAM row in
#: shared memory (as many DPUs as the card holds such blocks at once);
#: ``"resident"``, the same with WRAM in device memory, four DPUs a block
#: (at most :func:`max_dpus`); ``"resident_carry"``, the same with each
#: resident warp carrying ``Args.carry`` DPUs (``ops.carry_factor``); or
#: ``"stepwise"``, a plan and a run launch a step (any number of DPUs)
LAUNCHERS = {"resident_smem": "cycle_step_launch_smem",
             "resident": "cycle_step_launch",
             "resident_carry": "cycle_step_launch_carry",
             "stepwise": "cycle_step_launch_stepwise"}

#: the kernel's library (``step_driver.StepLibrary``: the plain and the
#: ``STEP_SECTIONS`` build, its layout checked against this module's)
LIB = StepLibrary(
    "cycle_step", SOURCES, HEADERS,
    layout=dict(max_slots=MAX_SLOTS, dpus_per_block=DPUS_PER_BLOCK,
                park_words=PARK_WORDS, max_carry=MAX_CARRY,
                n_leaves=len(LEAVES), n_config=len(CONFIG),
                n_fields=N_FIELDS, args_bytes=ctypes.sizeof(Args)),
    launchers=LAUNCHERS)


def library(sections: bool = False) -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library (``sections``:
    the profiling build)."""
    return LIB.load(sections)


def max_dpus(n_threads: int) -> int:
    """The most DPUs of ``n_threads`` tasklets the resident route can take
    on the current CUDA device: every block of the kernel resident at
    once.  Raises on a CUDA error."""
    fn = library().cycle_step_max_dpus
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    n = fn(n_threads)
    if n < 0:
        raise RuntimeError(f"cycle_step occupancy query failed: cudaError "
                           f"{-n}")
    return n


def _int_fn(name: str, n_args: int):
    fn = getattr(library(), name)
    fn.argtypes, fn.restype = [ctypes.c_int] * n_args, ctypes.c_int
    return fn


def card_limits(n_threads: int) -> RouteLimits:
    """The current device's limits for launches of ``n_threads``
    tasklets: the resident_smem kernel's, :func:`max_dpus`, and the
    resident_carry kernel's blocks an SM and a block's fixed shared
    memory."""
    out = (ctypes.c_int * 2)()
    fn = library().cycle_step_carry_limits
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"cycle_step device query failed: cudaError "
                           f"{-err}")
    return dataclasses.replace(LIB.card_limits(max_dpus(n_threads)),
                               carry_blocks=out[0], carry_extra=out[1])


def carry_bytes(n: int, n_threads: int) -> int:
    """The library's own count of the resident_carry route's dynamic
    shared memory a block (``ops.carry_bytes`` mirrors it)."""
    return _int_fn("cycle_step_carry_bytes", 2)(n, n_threads)


def carry_blocks(nbytes: int) -> int:
    """The resident_carry kernel's blocks an SM of the current device with
    ``nbytes`` of dynamic shared memory, as the card's occupancy query
    gives them (what ``ops.carry_held`` models).  Raises on a CUDA
    error."""
    n = _int_fn("cycle_step_carry_blocks", 1)(nbytes)
    if n < 0:
        raise RuntimeError(f"cycle_step occupancy query failed: cudaError "
                           f"{-n}")
    return n
