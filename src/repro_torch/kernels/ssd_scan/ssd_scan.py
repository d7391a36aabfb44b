"""CUDA binding of the SSD scan kernel (``csrc/ssd_scan.cu``).

The counterpart of the Pallas module ``repro.kernels.ssd_scan.ssd_scan``:
that one computes one chunk per launch over a (batch x heads) grid, and
``ssd_scan_op`` carries the state across chunks with a host-side
``lax.scan``; this one launches once per sequence, one CTA per (head,
batch), and carries the state across chunks in shared memory.  Built with
``nvcc`` for ``sm_90a`` at first use and bound through ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ssd_scan.cu",)

#: kernel dtype codes of the C interface (x, B, C and y)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FNS = {}


def library() -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library."""
    lib = load_library("ssd_scan", SOURCES)
    if not _FNS:
        fn = lib.ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int64
        limit = lib.ssd_scan_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int64
        _FNS.update(launch=fn, smem=smem, limit=limit)
    return lib


def smem_fits(n: int, p: int, q: int) -> bool:
    """Whether the kernel's shared memory for (N, P, Q) fits one block."""
    library()
    return _FNS["smem"](n, p, q) <= _FNS["limit"]()


def ssd_scan_cuda(x, dt, A, Bm, Cm, y, state, chunk: int) -> None:
    """Launch the kernel on the current stream: ``y, state = ssd(x, ...)``.

    Contiguous x/y (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N),
    state (B,H,N,P) f32 on one CUDA device; ``chunk <= S`` (checked by the
    caller).  Raises on a launch error."""
    library()
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    err = _FNS["launch"](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, G, N, P,
        chunk, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
