"""Dispatching wrapper of blockwise attention: what
``repro_torch.models.attention.blocked_attention`` calls on the card.

``flash_attention(q, k, v, causal=, window=)`` computes the Pallas kernel
``repro.kernels.flash_attention``'s function.  A CPU tensor goes to the
plain-torch version (:func:`.ref.flash_attention_ref`); a CUDA tensor
launches the hand-written CUDA kernel (:mod:`.flash_attention`) on the
current stream, or raises — there is no fallback.  ``launches`` counts
kernel launches (never plain-version calls); callers may reset it to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    DTYPES, flash_attention_cuda, smem_fits)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: CUDA kernel launches made by :func:`flash_attention` (a plain integer)
launches = 0

#: largest value head width the kernel's accumulators hold
MAX_DV = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv) -> (B,S,H,Dv) in q's
    dtype.  H must be a multiple of KV (query head h reads KV head
    h // (H // KV)); ``window > 0`` limits each query to its trailing
    ``window`` positions."""
    global launches
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check(q, k, v)
    B, S, H, _ = q.shape
    out = torch.empty((B, S, H, v.shape[3]), dtype=q.dtype, device=dev)
    flash_attention_cuda(q, k, v, out, causal, window)
    launches += 1
    return out


def _check(q, k, v):
    """Raise the precise reason the kernel cannot take (q, k, v)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes q, k, v all float32 or all "
                            "bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             "4-d tensor")
    B, S, H, Dk = q.shape
    if (k.shape[:2] != (B, S) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != Dk or H % k.shape[2] != 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if q.numel() == 0 or v.numel() == 0:
        raise ValueError("flash_attention: empty input")
    if v.shape[3] > MAX_DV or not smem_fits(Dk, v.shape[3]):
        raise ValueError(f"flash_attention: Dk {Dk}, Dv {v.shape[3]} exceed "
                         "the kernel's shared memory or accumulators")
