"""CUDA binding of the SIMT step kernel (``csrc/simt_step.cu``).

The kernel runs K whole simulated cycles of every DPU of the SIMT engine
per launch, each lane's ALU on the device function of ``alu_exec.cuh``.
It replaces no Pallas kernel of its own: the JAX package runs the step
(``repro.core.simt.make_step_traced``) as jnp code whose ALU is
``repro.core.engine.alu_exec``, the jnp mirror of the Pallas kernel
``repro.kernels.alu_exec``.  Built with ``nvcc`` for ``sm_90a`` at first
use and bound through ctypes.

The kernel reads, besides the state leaves of :data:`LEAVES` (by
pointer), the decoded image (:func:`pack_image`: the rows of
``repro_torch.core.simt.decode_image``, 8 int32 a slot) and the int32
configuration fields of :data:`CONFIG` with the float32 reciprocal of the
DMA bandwidth (:func:`config_fields`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import isa, simt
from repro_torch.core.config import DPUConfig
from repro_torch.kernels.step_driver import RouteLimits, StepLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "simt_step.cu",)
HEADERS = (CSRC.parents[1] / "alu_exec" / "csrc" / "alu_exec.cuh",
           CSRC.parents[1] / "step_common.cuh")

#: the state leaves the kernel reads or writes, in its order (``enum Leaf``)
LEAVES = (
    "cycle", "pc", "regs", "status", "next_issue", "rr", "wram", "mram",
    "atomic", "req_valid", "req_mram", "req_bytes", "req_enq", "req_service",
    "eng_active", "eng_thread", "eng_finish", "open_row", "warp_next",
    "c_active", "c_idle_mem", "c_idle_rev", "c_issued", "c_cls", "c_hist",
    "c_dma_rd", "c_dma_wr", "c_dma_rd_bytes", "c_dma_wr_bytes", "c_row_hit",
    "c_row_miss", "c_acq_retry")

#: int32 fields of the kernel's configuration (``enum Cfg``)
CONFIG = ("D", "T", "simt_width", "W", "M", "A", "P", "K", "max_cycles",
          "row_bytes", "row_miss_overhead", "coalescing", "mul_extra",
          "div_extra", "event_skip")

#: DPUs (warps) per block (``DPB``)
DPUS_PER_BLOCK = 4
#: int32 words per instruction slot of the packed image (``enum Field``)
N_FIELDS = 8

_INT32_MAX = 2**31 - 1


def leaf_table(cfg: DPUConfig, D: int, T: int, W: int, M: int
               ) -> Dict[str, Tuple[torch.dtype, tuple]]:
    """Every leaf the kernel reads and writes: name -> (dtype, shape), for
    ``D`` DPUs of ``T`` tasklets, ``W`` WRAM and ``M`` MRAM words."""
    shapes = {"regs": (D, T, isa.N_REGS), "wram": (D, W), "mram": (D, M),
              "atomic": (D, cfg.atomic_bits), "c_cls": (D, 6),
              "c_hist": (D, T + 1), "warp_next": (D, T // cfg.simt_width)}
    per_thread = ("pc", "status", "next_issue", "req_valid", "req_mram",
                  "req_bytes", "req_enq", "req_service")
    table = {}
    for name in LEAVES:
        dtype = (torch.bool if name in ("req_valid", "eng_active")
                 else torch.float32 if name.endswith("_bytes")
                 and name.startswith("c_") else torch.int32)
        table[name] = (dtype, shapes.get(
            name, (D, T) if name in per_thread else (D,)))
    return table


def pack_image(img: np.ndarray) -> np.ndarray:
    """(6, P) instruction image -> (P, N_FIELDS) int32: each slot's
    :func:`repro_torch.core.simt.decode_image` fields.  Raises
    ``ValueError`` if a register field lies outside [0, N_REGS): the
    kernel reads the register file of the issuing lanes only."""
    dec = simt.decode_image(np.asarray(img, np.int32))
    regs = dec[1:4]
    if regs.size and (regs.min() < 0 or regs.max() >= isa.N_REGS):
        raise ValueError("simt_step: the instruction image names a "
                         f"register outside [0, {isa.N_REGS})")
    return np.ascontiguousarray(dec.T)


def config_fields(cfg: DPUConfig, D: int, T: int, W: int, M: int, P: int,
                  K: int) -> Tuple[list, np.float32]:
    """(int32 fields in :data:`CONFIG` order, inv_bw): the constants a
    launch passes, the reciprocal built as ``simt.SimtConsts`` builds it.
    A ``max_cycles`` past int32 is passed as the int32 maximum, which an
    int32 cycle count never passes either."""
    vals = dict(D=D, T=T, W=W, M=M, A=cfg.atomic_bits, P=P, K=K,
                max_cycles=min(int(cfg.max_cycles), _INT32_MAX))
    fields = [int(vals[n]) if n in vals else int(getattr(cfg, n))
              for n in CONFIG]
    bw = cfg.effective_mram_bw * (cfg.coalesced_bw_mult
                                  if cfg.coalescing else 1.0)
    return fields, np.float32(1) / np.float32(bw)


class Args(ctypes.Structure):
    """The kernel's ``struct Args``, passed by value."""

    _fields_ = [("leaf", ctypes.c_void_p * len(LEAVES)),
                ("image", ctypes.c_void_p),
                ("stop", ctypes.c_void_p),
                ("vote", ctypes.c_void_p),
                ("flag", ctypes.c_void_p),
                ("sections", ctypes.c_void_p),
                ("parity", ctypes.c_int32),
                ("c", ctypes.c_int32 * len(CONFIG)),
                ("inv_bw", ctypes.c_float)]


#: the kernel's routes -> C launcher: ``"resident_smem"``, one launch of K
#: steps, one DPU a block with its WRAM row and atomics in shared memory,
#: the tail folded in (every block resident at once); ``"global"``, WRAM
#: in device memory, a run and a tail kernel a launch (any DPU count)
LAUNCHERS = {"resident_smem": "simt_step_launch_smem",
             "global": "simt_step_launch"}

#: the kernel's library (``step_driver.StepLibrary``)
LIB = StepLibrary(
    "simt_step", SOURCES, HEADERS,
    layout=dict(dpus_per_block=DPUS_PER_BLOCK, n_leaves=len(LEAVES),
                n_config=len(CONFIG), n_fields=N_FIELDS,
                args_bytes=ctypes.sizeof(Args)),
    launchers=LAUNCHERS)


def library(sections: bool = False) -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library (``sections``:
    the profiling build)."""
    return LIB.load(sections)


def card_limits() -> RouteLimits:
    """The current device's limits for the resident_smem kernel."""
    return LIB.card_limits()
