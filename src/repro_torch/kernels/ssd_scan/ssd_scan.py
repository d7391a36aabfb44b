"""CUDA bindings of the SSD scan kernels (``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_tc.cu``).

The counterparts of the Pallas module ``repro.kernels.ssd_scan.ssd_scan``:
that one computes one chunk per launch over a (batch x heads) grid, and
``ssd_scan_op`` carries the state across chunks with a host-side
``lax.scan``.  The scalar kernel launches once per sequence, one CTA per
(head, batch), and carries the state across chunks in shared memory (any
width, float32 or bfloat16).  The tensor-core kernels (bfloat16, N and P
multiples of 16) split the scan into four chunk-parallel launches:
C B^T per group, chunk states, state passing, chunk outputs.  Each
library is built with ``nvcc`` for ``sm_90a`` at first use and bound
through ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ssd_scan.cu",)
SOURCES_TC = (CSRC / "ssd_scan_tc.cu",)
#: ptxas reports the tensor-core kernels' registers and spills (build log)
FLAGS_TC = ("-Xptxas", "-v")
#: rows of the tensor-core kernels' tiles (``kT``)
TC_TILE = 64

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


_FNS_TC = {}


def library_tc() -> ctypes.CDLL:
    """Build (once) and load the tensor-core kernels' shared library."""
    lib = load_library("ssd_scan_tc", SOURCES_TC, flags=FLAGS_TC)
    if not _FNS_TC:
        fn = lib.ssd_scan_tc_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_tc_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int64
        limit = lib.ssd_scan_tc_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int64
        _FNS_TC.update(launch=fn, smem=smem, limit=limit)
    return lib


def smem_fits_tc(n: int, p: int, q: int) -> bool:
    """Whether the tensor-core kernels' shared memory for (N, P, Q) fits
    one block."""
    library_tc()
    need = _FNS_TC["smem"](n, p, q)
    return 0 <= need <= _FNS_TC["limit"]()


def ssd_scan_tc_cuda(x, dt, A, Bm, Cm, y, state, chunk: int) -> None:
    """Launch the four tensor-core route kernels on the current stream:
    ``y, state = ssd(x, ...)``.

    bfloat16 x/Bm/Cm/y, float32 dt/A/state, contiguous, as
    :func:`ssd_scan_cuda`; x, Bm and Cm 16-byte aligned; N and P
    multiples of 16 up to 128; ``chunk <= S`` (all checked by the
    caller).  Allocates the scratch (each chunk's own and incoming state,
    its seg and dt, and C B^T) from the caching allocator.  Raises on a
    launch error."""
    library_tc()
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // chunk)
    dev, f32 = x.device, torch.float32
    qt = -(-chunk // TC_TILE) * TC_TILE
    # each chunk's own state; its incoming state as bf16 hi and lo; its
    # seg and dt; the group's C B^T
    dS = torch.empty((B, H, nc, N, P), dtype=f32, device=dev)
    s_in = torch.empty((B, H, nc, 2, N, P), dtype=torch.bfloat16, device=dev)
    seg = torch.empty((B, H, nc, 2, chunk), dtype=f32, device=dev)
    cb = torch.empty((B, G, nc, qt, qt), dtype=f32, device=dev)
    err = _FNS_TC["launch"](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), dS.data_ptr(),
        s_in.data_ptr(), seg.data_ptr(), cb.data_ptr(), B, S, H, G, N, P,
        chunk, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan tensor-core kernel launch failed: "
                           f"cudaError {err}")
