"""Dispatching wrapper of the SSD scan: what
``repro_torch.models.ssm.ssd_chunked`` calls.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` computes the chunked Mamba-2 SSD
scan of a whole sequence (``repro.models.ssm.ssd_chunked``; in float32 the
Pallas kernel ``repro.kernels.ssd_scan`` driven by ``ssd_scan_op``).  A
CPU tensor goes to the plain-torch version (:func:`.ref.ssd_scan_ref`); a
CUDA tensor launches the hand-written CUDA kernel (:mod:`.ssd_scan`) on
the current stream, or raises — there is no fallback.  ``launches``
counts kernel launches (never plain-version calls); callers may reset it
to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import DTYPES, smem_fits, ssd_scan_cuda

#: CUDA kernel launches made by :func:`ssd_scan` (a plain integer)
launches = 0

#: largest state width N and head width P the kernel's registers hold
MAX_N, MAX_P = 128, 128


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """x (B,S,H,P), dt (B,S,H) f32, A (H,) f32 negative, Bm/Cm (B,S,G,N)
    with G dividing H -> (y (B,S,H,P) in x's dtype, final state
    (B,H,N,P) f32)."""
    global launches
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    ssd_scan_cuda(x, dt, A, Bm, Cm, y, state, min(chunk, S))
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
    if N > MAX_N or P > MAX_P or not smem_fits(N, P, min(chunk, S)):
        raise ValueError(f"ssd_scan: N {N}, P {P}, chunk {min(chunk, S)} "
                         "exceed the kernel's registers or shared memory")
