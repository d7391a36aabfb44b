"""CUDA bindings of the flash-attention kernels.

The counterparts of the Pallas module
``repro.kernels.flash_attention.flash_attention``: that one runs a
(B, H, S / bq) grid in order on one TPU core, holding the whole K/V of a
head in VMEM.  On the H100 two kernels compute its function, each its own
library, built with ``nvcc`` for ``sm_90a`` at first use and bound through
ctypes:

* ``csrc/flash_attention_sm90.cu`` (bf16; Dk and Dv multiples of 16 up to
  256): one CTA per (128-row query tile, head, batch), K/V tiles streamed
  by TMA, both products on the tensor cores (wgmma);
* ``csrc/flash_attention.cu`` (float32 or bf16, any width that fits): one
  CTA per (64-row query tile, head, batch), scalar FMAs.

Both forwards write each row's log-sum-exp when given an ``lse`` tensor
(training); two backward libraries read it (no Pallas counterpart: the JAX
package differentiates its jnp attention), each two kernels (dq, then dk
and dv):

* ``csrc/flash_attention_bwd_sm90.cu`` (bf16; Dk and Dv multiples of 16
  up to 256): TMA and wgmma, as the forward (``csrc/sm90_common.cuh``);
* ``csrc/flash_attention_bwd.cu`` (float32 or bf16, Dk, Dv up to 192):
  scalar FMAs on f32 shared-memory tiles.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "flash_attention.cu",)
SOURCES_SM90 = (CSRC / "flash_attention_sm90.cu",)
SOURCES_BWD = (CSRC / "flash_attention_bwd.cu",)
SOURCES_BWD_SM90 = (CSRC / "flash_attention_bwd_sm90.cu",)
#: the Hopper pieces both tensor-core sources include
HEADERS_SM90 = (CSRC / "sm90_common.cuh",)
#: ptxas reports the tensor-core backward's registers and spills (build log)
FLAGS_BWD_SM90 = ("-Xptxas", "-v")

#: kernel dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FNS = {}


def library() -> ctypes.CDLL:
    """Build (once) and load the scalar kernel's shared library."""
    lib = load_library("flash_attention", SOURCES)
    if "launch" not in _FNS:
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.flash_attention_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_int64
        limit = lib.flash_attention_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int64
        _FNS.update(launch=fn, smem=smem, limit=limit)
    return lib


def library_sm90() -> ctypes.CDLL:
    """Build (once) and load the tensor-core kernel's shared library."""
    lib = load_library("flash_attention_sm90", SOURCES_SM90, HEADERS_SM90)
    if "sm90" not in _FNS:
        fn = lib.flash_attention_sm90_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS["sm90"] = fn
    return lib


def library_bwd() -> ctypes.CDLL:
    """Build (once) and load the backward kernels' shared library."""
    lib = load_library("flash_attention_bwd", SOURCES_BWD)
    if "bwd" not in _FNS:
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.flash_attention_bwd_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_int64
        limit = lib.flash_attention_bwd_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int64
        _FNS.update(bwd=fn, bwd_smem=smem, bwd_limit=limit)
    return lib


def library_bwd_sm90() -> ctypes.CDLL:
    """Build (once) and load the tensor-core backward kernels' shared
    library."""
    lib = load_library("flash_attention_bwd_sm90", SOURCES_BWD_SM90,
                       HEADERS_SM90, FLAGS_BWD_SM90)
    if "bwd_sm90" not in _FNS:
        fn = lib.flash_attention_bwd_sm90_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        scratch = lib.flash_attention_bwd_sm90_scratch
        scratch.argtypes = [ctypes.c_int] * 3
        scratch.restype = ctypes.c_int64
        _FNS.update(bwd_sm90=fn, bwd_sm90_scratch=scratch)
    return lib


def smem_fits(dk: int, dv: int) -> bool:
    """Whether the scalar kernel's shared memory for (Dk, Dv) fits one
    block."""
    library()
    return _FNS["smem"](dk, dv) <= _FNS["limit"]()


def smem_fits_bwd(dk: int, dv: int) -> bool:
    """Whether the backward kernels' shared memory for (Dk, Dv) fits one
    block."""
    library_bwd()
    return _FNS["bwd_smem"](dk, dv) <= _FNS["bwd_limit"]()


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool, window: int,
                         lse: torch.Tensor = None) -> None:
    """Launch the scalar kernel on the current stream:
    ``out = attention(q, k, v)`` (and, given ``lse``, each row's
    log-sum-exp into it).

    Contiguous (B,S,H,Dk), (B,S,KV,Dk), (B,S,KV,Dv), (B,S,H,Dv) tensors of
    one dtype (float32 or bfloat16) and a float32 (B,H,S) ``lse`` on one
    CUDA device (checked by the caller).  Raises on a launch error."""
    library()
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    err = _FNS["launch"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, Dk, Dv, int(causal), int(window), Dk ** -0.5, DTYPES[q.dtype],
        _ptr(lse), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")


def flash_attention_sm90_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              causal: bool, window: int,
                              lse: torch.Tensor = None) -> None:
    """Launch the tensor-core kernel on the current stream:
    ``out = attention(q, k, v)`` (and, given a float32 (B,H,S) ``lse``,
    each row's log-sum-exp into it).

    Contiguous bf16 (B,S,H,Dk), (B,S,KV,Dk), (B,S,KV,Dv), (B,S,H,Dv)
    tensors on one CUDA device, 16-byte aligned, Dk and Dv multiples of 16
    up to 256 (checked by the caller).  Raises on a launch error."""
    library_sm90()
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    err = _FNS["sm90"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, Dk, Dv, int(causal), int(window), Dk ** -0.5, _ptr(lse),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_sm90 kernel launch failed: cudaError {err}")


def flash_attention_bwd_cuda(q, k, v, o, dout, lse, dq, dk, dv,
                             causal: bool, window: int, parts: int = 3,
                             scratch: torch.Tensor = None) -> torch.Tensor:
    """Launch the scalar backward kernels on the current stream: ``dq,
    dk, dv = d attention(q, k, v) given do``, from the forward's ``o`` and
    ``lse``.

    Contiguous q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv), o and ``dout``
    (B,S,H,Dv) of one dtype, ``lse`` (B,H,S) float32, and dq, dk, dv shaped
    and typed as q, k, v, on one CUDA device (checked by the caller).
    ``parts`` 1 launches the dq kernel alone, 2 the dk/dv kernel alone
    (timing each apart), 3 both.  Returns the (B,H,S) float32 scratch
    rowsum(do o) the dq kernel fills and the other reads (allocated unless
    given).  Raises on a launch error."""
    library_bwd()
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    if scratch is None:
        scratch = torch.empty((B, H, S), dtype=torch.float32,
                              device=q.device)
    err = _FNS["bwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, H, KV, Dk, Dv, int(causal),
        int(window), Dk ** -0.5, DTYPES[q.dtype], parts,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward kernel launch failed: cudaError {err}")
    return scratch


def flash_attention_bwd_sm90_cuda(q, k, v, o, dout, lse, dq, dk, dv,
                                  causal: bool, window: int, parts: int = 3,
                                  scratch: torch.Tensor = None
                                  ) -> torch.Tensor:
    """Launch the tensor-core backward kernels on the current stream:
    ``dq, dk, dv = d attention(q, k, v) given do``, from the forward's
    ``o`` and ``lse``.

    Contiguous bf16 q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv), o and
    ``dout`` (B,S,H,Dv), 16-byte aligned, ``lse`` (B,H,S) float32, dq, dk,
    dv shaped and typed as q, k, v, on one CUDA device; Dk and Dv
    multiples of 16 up to 256 (checked by the caller).  ``parts`` as
    :func:`flash_attention_bwd_cuda`'s.  Returns the float32 scratch of
    each row's (lse, rowsum(do o)) the dq kernel fills and the other reads
    (allocated unless given).  Raises on a launch error."""
    library_bwd_sm90()
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    if scratch is None:
        scratch = torch.empty(_FNS["bwd_sm90_scratch"](B, H, S),
                              dtype=torch.float32, device=q.device)
    err = _FNS["bwd_sm90"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, H, KV, Dk, Dv, int(causal),
        int(window), Dk ** -0.5, parts,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_sm90 kernel launch failed: "
                           f"cudaError {err}")
    return scratch
