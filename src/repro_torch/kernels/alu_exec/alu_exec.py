"""CUDA binding of the ALU kernel (``csrc/alu_exec.cu``).

The counterpart of the Pallas module ``repro.kernels.alu_exec.alu_exec``:
that one tiles the lanes into (8, 128) int32 blocks for the TPU's VPU;
this one launches a flat elementwise CUDA kernel, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "alu_exec.cu",)
HEADERS = (CSRC / "alu_exec.cuh",)


_LAUNCH = None


def library() -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library."""
    global _LAUNCH
    lib = load_library("alu_exec", SOURCES, HEADERS)
    if _LAUNCH is None:
        fn = lib.alu_exec_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return lib


def alu_exec_cuda(op: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out = alu(op, a, b)``.

    All four tensors: contiguous int32 on one CUDA device, same size > 0
    (checked by the caller).  Raises on a launch error."""
    if _LAUNCH is None:
        library()
    err = _LAUNCH(op.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  op.numel(), torch.cuda.current_stream(op.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alu_exec kernel launch failed: cudaError {err}")
