"""Dispatching wrapper of the SSD scan: what
``repro_torch.models.ssm.ssd_chunked`` calls.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` computes the chunked Mamba-2 SSD
scan of a whole sequence (``repro.models.ssm.ssd_chunked``; in float32 the
Pallas kernel ``repro.kernels.ssd_scan`` driven by ``ssd_scan_op``).  A
CPU tensor goes to the plain-torch version (:func:`.ref.ssd_scan_ref`); a
CUDA tensor launches one of two hand-written CUDA routes
(:mod:`.ssd_scan`) on the current stream, or raises — there is no
fallback.  :func:`route` picks it from the dtype, the widths and the
chunk alone:

* ``"tc"`` — ``csrc/ssd_scan_tc.cu`` (chunk-parallel, mma.sync tensor
  cores, four launches): bfloat16 with N and P multiples of 16 and a
  chunk that is a multiple of 64 (mamba2-130m: N 128, P 64, chunk 256);
* ``"scalar"`` — ``csrc/ssd_scan.cu`` (one CTA per (head, batch), scalar
  FMAs): float32, and bfloat16 at the shapes ``"tc"`` does not take.

``launches`` counts the scans handed to either route and ``launches_tc``
those of the tensor-core route (never plain-version calls); callers may
reset either to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (
    DTYPES, TC_TILE, smem_fits, smem_fits_tc, ssd_scan_cuda, ssd_scan_tc_cuda)

#: scans handed to a CUDA route by :func:`ssd_scan` (a plain integer)
launches = 0
#: of which on the tensor-core route
launches_tc = 0

#: largest state width N and head width P the kernels' registers hold
MAX_N, MAX_P = 128, 128
#: the tensor-core route's widths: multiples of one bf16 mma k-step (its
#: chunks: multiples of its TC_TILE-row tiles)
TC_STEP = 16


def route(dtype: torch.dtype, n: int, p: int, chunk: int) -> str:
    """The CUDA route that takes a (dtype, N, P, chunk) scan: ``"tc"`` or
    ``"scalar"``.  Raises ``TypeError`` for a dtype neither takes and
    ``ValueError`` for widths above ``MAX_N`` / ``MAX_P`` or a chunk
    below 1 (shared memory is checked at launch)."""
    if dtype not in DTYPES:
        raise TypeError(f"ssd_scan: {dtype}; the kernels take float32 or "
                        "bfloat16")
    if not (0 < n <= MAX_N and 0 < p <= MAX_P and chunk >= 1):
        raise ValueError(f"ssd_scan: N {n}, P {p}, chunk {chunk}; the "
                         f"kernels take N up to {MAX_N}, P up to {MAX_P}")
    if (dtype == torch.bfloat16 and n % TC_STEP == 0 and p % TC_STEP == 0
            and chunk % TC_TILE == 0):
        return "tc"
    return "scalar"


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """x (B,S,H,P), dt (B,S,H) f32, A (H,) f32 negative, Bm/Cm (B,S,G,N)
    with G dividing H -> (y (B,S,H,P) in x's dtype, final state
    (B,H,N,P) f32)."""
    global launches, launches_tc
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    Q = min(chunk, S)
    kernel = route(x.dtype, N, P, chunk)
    fits = smem_fits_tc if kernel == "tc" else smem_fits
    if not fits(N, P, Q):
        raise ValueError(f"ssd_scan: N {N}, P {P}, chunk {Q} exceed the "
                         f"{kernel} kernels' shared memory")
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    if kernel == "tc":
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"ssd_scan: {name}'s data is not 16-byte "
                                 "aligned (the kernels copy it by cp.async)")
        ssd_scan_tc_cuda(x, dt, A, Bm, Cm, y, state, Q)
        launches_tc += 1
    else:
        ssd_scan_cuda(x, dt, A, Bm, Cm, y, state, Q)
    launches += 1
    return y, state


def _check(x, dt, A, Bm, Cm, chunk):
    """Raise the precise reason the kernel cannot take the inputs."""
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, Bm, Cm are {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; the kernel takes all three float32 or "
                        "all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    if x.dim() != 4 or Bm.dim() != 4 or x.numel() == 0:
        raise ValueError("ssd_scan: x and Bm must be non-empty 4-d tensors")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape[:2] != (B, S)
            or Cm.shape != Bm.shape or H % G != 0):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not fit")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
