"""CUDA binding of the CRF command-step kernel (``csrc/crf_step.cu``).

The kernel runs K commands of every bank of the HBM-PIM command model per
launch.  It replaces no Pallas kernel: the JAX package runs the step
(``repro.core.hbmpim.make_cmd_step``) as jnp code.  Built with ``nvcc``
for ``sm_90a`` at first use and bound through ctypes.

The kernel reads, besides the state leaves of :data:`LEAVES` (by
pointer), the image's op, destination, a, b and target of each slot
(:func:`pack_image`, 8 int32 a slot) and the int32 configuration fields
of :data:`CONFIG` with the float32 burst size (:func:`config_fields`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "crf_step.cu",)
#: ptxas reports registers and spills (kept in the build log)
FLAGS = ("-Xptxas", "-v")

#: the state leaves the kernel reads or writes, in its order (``enum Leaf``)
LEAVES = ("cycle", "pc", "status", "loop_left", "open_row", "grf_a", "grf_b",
          "srf", "mram", "c_active", "c_idle_mem", "c_issued", "c_cls",
          "c_hist", "c_dma_rd", "c_dma_wr", "c_dma_rd_bytes",
          "c_dma_wr_bytes", "c_row_hit", "c_row_miss")

#: every leaf of ``hbmpim.make_cmd_state_np``'s state
STATE_KEYS = frozenset(LEAVES) | {
    "c_idle_rev", "c_idle_rf", "c_tlb_hit", "c_tlb_miss", "c_dc_hit",
    "c_dc_miss", "c_acq_retry", "ts_buf", "ts_acc"}

#: int32 fields of the kernel's configuration (``enum Cfg``)
CONFIG = ("D", "hbm_lanes", "M", "P", "K", "H", "max_cycles",
          "row_hit_overhead", "row_miss_overhead", "xfer")

#: banks (warps) per block (``DPB``)
DPUS_PER_BLOCK = 4
#: int32 words per instruction slot of the packed image
N_FIELDS = 8

_INT32_MAX = 2**31 - 1


def leaf_table(cfg: DPUConfig, D: int, M: int, H: int
               ) -> Dict[str, Tuple[torch.dtype, tuple]]:
    """Every leaf the kernel reads and writes: name -> (dtype, shape), for
    ``D`` banks, ``M`` MRAM words and ``H`` histogram bins."""
    W = cfg.hbm_lanes
    shapes = {"status": (D, 1), "grf_a": (D, 8, W), "grf_b": (D, 8, W),
              "srf": (D, 8), "mram": (D, M), "c_cls": (D, 6),
              "c_hist": (D, H)}
    return {name: (torch.float32 if name.endswith("_bytes") else torch.int32,
                   shapes.get(name, (D,))) for name in LEAVES}


def xfer(cfg: DPUConfig) -> int:
    """A bank operand's burst transfer cycles (``make_cmd_step``'s)."""
    return max(1, int(np.ceil((cfg.hbm_lanes * 4)
                              / (cfg.effective_mram_bw
                                 * cfg.coalesced_bw_mult))))


def pack_image(img: np.ndarray) -> np.ndarray:
    """(6, P) CRF image -> (P, N_FIELDS) int32: op, destination, a, b,
    target, three zero words."""
    img = np.asarray(img, np.int32)
    out = np.zeros((img.shape[1], N_FIELDS), np.int32)
    out[:, :5] = img[:5].T
    return out


def config_fields(cfg: DPUConfig, D: int, M: int, P: int, K: int,
                  H: int) -> list:
    """The int32 fields of :data:`CONFIG` a launch passes (a
    ``max_cycles`` past int32 as the int32 maximum: an int32 cycle count
    never passes either)."""
    vals = dict(D=D, M=M, P=P, K=K, H=H, xfer=xfer(cfg),
                max_cycles=min(int(cfg.max_cycles), _INT32_MAX))
    return [int(vals[n]) if n in vals else int(getattr(cfg, n))
            for n in CONFIG]


class Args(ctypes.Structure):
    """The kernel's ``struct Args``, passed by value."""

    _fields_ = [("leaf", ctypes.c_void_p * len(LEAVES)),
                ("image", ctypes.c_void_p),
                ("stop", ctypes.c_void_p),
                ("vote", ctypes.c_void_p),
                ("flag", ctypes.c_void_p),
                ("parity", ctypes.c_int32),
                ("c", ctypes.c_int32 * len(CONFIG)),
                ("burst", ctypes.c_float)]


_FNS = {}


def library() -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library, and check that
    its layout is this module's."""
    lib = load_library("crf_step", SOURCES, (), FLAGS)
    if not _FNS:
        for name in ("dpus_per_block", "n_leaves", "n_config", "args_bytes"):
            fn = getattr(lib, f"crf_step_{name}")
            fn.argtypes, fn.restype = [], ctypes.c_int
            _FNS[name] = fn()
        want = dict(dpus_per_block=DPUS_PER_BLOCK, n_leaves=len(LEAVES),
                    n_config=len(CONFIG), args_bytes=ctypes.sizeof(Args))
        bad = {k: (_FNS[k], v) for k, v in want.items() if _FNS[k] != v}
        if bad:
            raise RuntimeError(f"crf_step library layout differs: {bad}")
        fn = lib.crf_step_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS["launch"] = fn
    return lib


def crf_step_cuda(args: Args, stream: int) -> None:
    """Launch ``args.c[K]`` commands on ``stream``.  Raises on a launch
    error."""
    if not _FNS:
        library()
    err = _FNS["launch"](ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"crf_step kernel launch failed: cudaError {err}")
