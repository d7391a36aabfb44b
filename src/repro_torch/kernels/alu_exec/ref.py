"""Plain-torch version of the simulator ALU (12-way int32 switch).

The counterpart of ``repro.kernels.alu_exec.ref.alu_exec_ref`` and the
CPU path of :func:`repro_torch.kernels.alu_exec.ops.alu_exec`.  Runs on
any device.  Every lane is computed in int64 and wrapped back to int32:

* ``>>`` on ``torch.uint32`` has no CPU kernel, so SLL/SRL/SLTU work on
  the int64 value masked with ``0xFFFFFFFF``;
* ADD/SUB/MUL wrap like int32 hardware through the same mask;
* ``torch.div`` of int32 INT_MIN by -1 traps (SIGFPE) on the CPU; in
  int64 it is 2**31, which wraps back to INT_MIN.
"""
from __future__ import annotations

import torch

N_ALU_OPS = 12
_MASK = 0xFFFFFFFF
_HALF = 1 << 31


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into int32."""
    return (((x + _HALF) & _MASK) - _HALF).to(torch.int32)


def alu_exec_ref(op: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """op/a/b: int32 tensors of one shape -> int32 results.

      0 ADD  1 SUB  2 AND  3 OR  4 XOR  5 SLL  6 SRL  7 SRA
      8 MUL  9 DIV(0 -> -1, trunc)  10 SLT  11 SLTU;  0 for other ops
    """
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    au = a64 & _MASK
    bu = b64 & _MASK
    sh = bu & 31
    q = torch.div(a64, torch.where(b64 == 0, 1, b64), rounding_mode="trunc")
    results = torch.stack([
        a64 + b64,
        a64 - b64,
        a64 & b64,
        a64 | b64,
        a64 ^ b64,
        au << sh,
        au >> sh,
        a64 >> sh,
        a64 * b64,
        torch.where(b64 == 0, -1, q),
        (a64 < b64).to(torch.int64),
        (au < bu).to(torch.int64),
    ])
    in_range = (op >= 0) & (op < N_ALU_OPS)
    sel = torch.where(in_range, op, 0).to(torch.int64).unsqueeze(0)
    out = results.gather(0, sel).squeeze(0)
    return torch.where(in_range, wrap32(out), 0)
