"""Dispatching wrapper of the simulator ALU: the eager engine step's ALU
(on the card the fused cycle-step kernel runs the same device function,
``csrc/alu_exec.cuh``, inside its own launch).

``alu_exec(op, a, b)`` computes the 12-way int32 ALU over a flat (or any)
shape.  A CPU tensor goes to the plain-torch version (:mod:`.ref`); a
CUDA tensor launches the hand-written CUDA kernel (:mod:`.alu_exec`) on
the current stream, or raises — there is no fallback.  ``launches``
counts kernel launches (never plain-version calls); callers may reset it
to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.alu_exec.alu_exec import alu_exec_cuda
from repro_torch.kernels.alu_exec.ref import alu_exec_ref

#: CUDA kernel launches made by :func:`alu_exec` (a plain integer)
launches = 0


def alu_exec(op: torch.Tensor, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """op/a/b: int32 tensors of one shape -> int32 results."""
    global launches
    dev = op.device
    if dev.type == "cpu":
        return alu_exec_ref(op, a, b)
    if dev.type != "cuda":
        raise ValueError(f"alu_exec: unsupported device {dev}")
    if not (a.device == dev and b.device == dev
            and op.dtype == a.dtype == b.dtype == torch.int32
            and op.shape == a.shape == b.shape and op.is_contiguous()
            and a.is_contiguous() and b.is_contiguous()):
        _reject(op, a, b)
    out = torch.empty_like(op)
    if op.numel() == 0:
        return out
    alu_exec_cuda(op, a, b, out)
    launches += 1
    return out


def _reject(op, a, b):
    """Raise the precise reason the kernel cannot take (op, a, b)."""
    for name, t in (("op", op), ("a", a), ("b", b)):
        if t.device != op.device:
            raise ValueError(f"alu_exec: {name} on {t.device}, op on "
                             f"{op.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"alu_exec: {name} must be int32, got {t.dtype}")
        if t.shape != op.shape:
            raise ValueError(f"alu_exec: {name} shape {tuple(t.shape)} != "
                             f"op shape {tuple(op.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"alu_exec: {name} must be contiguous")
