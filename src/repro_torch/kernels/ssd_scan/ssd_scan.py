"""CUDA bindings of the SSD scan kernels (``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_tc.cu``).

The counterparts of the Pallas module ``repro.kernels.ssd_scan.ssd_scan``:
that one computes one chunk per launch over a (batch x heads) grid, and
``ssd_scan_op`` carries the state across chunks with a host-side
``lax.scan``.  The scalar kernel launches once per sequence, one CTA per
(head, batch), and carries the state across chunks in shared memory (any
width, float32 or bfloat16).  The tensor-core kernels (bfloat16, N and P
multiples of 16) split the scan into four chunk-parallel launches:
C B^T per group, chunk states, state passing, chunk outputs.  Both
routes keep each chunk's incoming state when asked (training: the scalar
kernel writes them in f32, the tensor-core route's state pass already
holds them as a bf16 hi + lo pair), and two backward libraries read them
(no Pallas counterpart: the JAX package differentiates its jnp
``ssd_chunked``): ``csrc/ssd_scan_bwd_tc.cu`` (bfloat16, the tensor-core
forward's shapes: six chunk-parallel launches on mma.sync) and
``csrc/ssd_scan_bwd.cu`` (two kernels, scalar FMAs; either forward's
states).  The tensor-core sources share ``csrc/mma_common.cuh``.  Each
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
SOURCES_BWD = (CSRC / "ssd_scan_bwd.cu",)
SOURCES_BWD_TC = (CSRC / "ssd_scan_bwd_tc.cu",)
#: the mma.sync pieces both tensor-core sources include
HEADERS_TC = (CSRC / "mma_common.cuh",)
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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
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


def ssd_scan_cuda(x, dt, A, Bm, Cm, y, state, chunk: int,
                  states=None) -> None:
    """Launch the kernel on the current stream: ``y, state = ssd(x, ...)``
    (and, given ``states``, each chunk's incoming state into it).

    Contiguous x/y (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N),
    state (B,H,N,P) f32 and states (B,H,ceil(S / chunk),N,P) f32 on one
    CUDA device; ``chunk <= S`` (checked by the caller).  Raises on a
    launch error."""
    library()
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    err = _FNS["launch"](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if states is None else states.data_ptr(), B, S, H, G, N, P,
        chunk, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")


_FNS_TC = {}


def library_tc() -> ctypes.CDLL:
    """Build (once) and load the tensor-core kernels' shared library."""
    lib = load_library("ssd_scan_tc", SOURCES_TC, HEADERS_TC, FLAGS_TC)
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


def ssd_scan_tc_cuda(x, dt, A, Bm, Cm, y, state, chunk: int):
    """Launch the four tensor-core route kernels on the current stream:
    ``y, state = ssd(x, ...)``.

    bfloat16 x/Bm/Cm/y, float32 dt/A/state, contiguous, as
    :func:`ssd_scan_cuda`; x, Bm and Cm 16-byte aligned; N and P
    multiples of 16 up to 128; ``chunk <= S`` (all checked by the
    caller).  Allocates the scratch (each chunk's own and incoming state,
    its seg and dt, and C B^T) from the caching allocator, and returns the
    incoming states (B,H,nc,2,N,P) bf16 hi and lo, which the backward pass
    reads.  Raises on a launch error."""
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
    return s_in


_FNS_BWD = {}


def library_bwd() -> ctypes.CDLL:
    """Build (once) and load the backward kernels' shared library."""
    lib = load_library("ssd_scan_bwd", SOURCES_BWD)
    if not _FNS_BWD:
        fn = lib.ssd_scan_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_bwd_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int64
        limit = lib.ssd_scan_bwd_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int64
        _FNS_BWD.update(launch=fn, smem=smem, limit=limit)
    return lib


def smem_fits_bwd(n: int, p: int, q: int) -> bool:
    """Whether the backward kernels' shared memory for (N, P, Q) fits one
    block."""
    library_bwd()
    return _FNS_BWD["smem"](n, p, q) <= _FNS_BWD["limit"]()


def _bwd_outputs(x, N, nc):
    """(dx, ddt, dBh, dCh, dA) for a backward launch, uninitialised."""
    B, S, H, _ = x.shape
    dev, f32 = x.device, torch.float32
    return (torch.empty_like(x),
            torch.empty((B, S, H), dtype=f32, device=dev),
            torch.empty((B, S, H, N), dtype=f32, device=dev),
            torch.empty((B, S, H, N), dtype=f32, device=dev),
            torch.empty((B, nc, H), dtype=f32, device=dev))


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dy, states, dfinal, chunk: int,
                      parts: int = 3, scratch: torch.Tensor = None):
    """Launch the two scalar backward kernels on the current stream;
    returns (dx in x's dtype, ddt (B,S,H), dB and dC per head (B,S,H,N),
    dA per (batch, chunk, head) (B,nc,H), all but dx float32).

    x, dt, A, Bm, Cm as the forward took them, ``dy`` (B,S,H,P) in x's
    dtype, ``states`` the forward's chunk-start states (float32
    (B,H,nc,N,P), or the tensor-core route's bf16 (B,H,nc,2,N,P) hi and
    lo), ``dfinal`` (B,H,N,P) float32 or None, all contiguous on one CUDA
    device (checked by the caller).  ``parts`` 1 launches the state pass
    alone, 2 the chunk kernel alone (timing each apart; it reads the
    ``scratch`` the pass filled), 3 both.  Allocates the outputs and,
    unless given, the scratch (each chunk's outgoing state's gradient,
    (B,H,nc,N,P) float32).  Raises on a launch error."""
    library_bwd()
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // chunk)
    hilo = states.dtype == torch.bfloat16
    if scratch is None:
        scratch = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                              device=x.device)
    outs = _bwd_outputs(x, N, nc)
    err = _FNS_BWD["launch"](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), states.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in outs), B, S, H, G, N, P, chunk,
        DTYPES[x.dtype], int(hilo), parts,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: "
                           f"cudaError {err}")
    return outs


_FNS_BWD_TC = {}


def library_bwd_tc() -> ctypes.CDLL:
    """Build (once) and load the tensor-core backward kernels' shared
    library."""
    lib = load_library("ssd_scan_bwd_tc", SOURCES_BWD_TC, HEADERS_TC,
                       FLAGS_TC)
    if not _FNS_BWD_TC:
        fn = lib.ssd_scan_bwd_tc_launch
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_scan_bwd_tc_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int64
        limit = lib.ssd_scan_bwd_tc_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int64
        scratch = lib.ssd_scan_bwd_tc_scratch_bytes
        scratch.argtypes = [ctypes.c_int] * 7
        scratch.restype = ctypes.c_int64
        _FNS_BWD_TC.update(launch=fn, smem=smem, limit=limit,
                           scratch=scratch)
    return lib


def smem_fits_bwd_tc(n: int, p: int, q: int) -> bool:
    """Whether the tensor-core backward kernels' shared memory for (N, P,
    Q) fits one block."""
    library_bwd_tc()
    need = _FNS_BWD_TC["smem"](n, p, q)
    return 0 <= need <= _FNS_BWD_TC["limit"]()


def ssd_scan_bwd_tc_cuda(x, dt, A, Bm, Cm, dy, states, dfinal, chunk: int,
                         parts: int = 63, scratch: torch.Tensor = None):
    """Launch the six tensor-core backward kernels on the current stream;
    returns what :func:`ssd_scan_bwd_cuda` returns.

    bfloat16 x, Bm, Cm, ``dy`` and the tensor-core forward's ``states``
    (B,H,nc,2,N,P) hi and lo, float32 dt, A and ``dfinal`` (B,H,N,P) or
    None, contiguous on one CUDA device; x, Bm, Cm, dy and states 16-byte
    aligned; N and P multiples of 16 up to 128; ``chunk <= S`` (all
    checked by the caller).  ``parts`` a mask of the launches (1 C B^T, 2
    chunk states, 4 state pass, 8 key tiles, 16 query tiles, 32 finish;
    one alone times it apart and reads the ``scratch`` the others filled),
    63 all.  Allocates the outputs and, unless given, the scratch (a uint8
    buffer :func:`scratch_bwd_tc` sizes).  Raises on a launch error."""
    library_bwd_tc()
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if scratch is None:
        scratch = scratch_bwd_tc(x, Bm, chunk)
    outs = _bwd_outputs(x, N, -(-S // chunk))
    err = _FNS_BWD_TC["launch"](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), states.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in outs), B, S, H, G, N, P, chunk, parts,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan tensor-core backward kernel launch "
                           f"failed: cudaError {err}")
    return outs


def scratch_bwd_tc(x, Bm, chunk: int) -> torch.Tensor:
    """The tensor-core backward's scratch for x (B,S,H,P), Bm (B,S,G,N)
    and ``chunk`` (C B^T, seg and dt, each chunk's own and outgoing state
    gradients, per-row partial sums), as one uint8 buffer."""
    library_bwd_tc()
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    return torch.empty(_FNS_BWD_TC["scratch"](B, S, H, G, N, P, chunk),
                       dtype=torch.uint8, device=x.device)
