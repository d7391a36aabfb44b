"""Plain version of the SIMT step kernel: K eager SIMT steps, then the
termination predicate.

The counterpart of :func:`repro_torch.kernels.simt_step.ops.simt_step` and
its CPU path: ``k`` calls of :func:`repro_torch.core.simt.make_step_traced`
(on the card, the eager step, whose ALU is the ``alu_exec`` kernel)
followed by :func:`repro_torch.core.engine.make_cond`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import engine, simt
from repro_torch.core.config import DPUConfig


def simt_step_ref(cfg: DPUConfig, st: Dict[str, torch.Tensor],
                  ir: torch.Tensor, k: int,
                  step: Optional[Callable] = None) -> bool:
    """Advance ``st`` (its entries replaced) by ``k`` gated steps of the
    image ``ir`` and return the termination predicate.  ``step``: a step
    built by ``simt.make_step_traced`` for this configuration and device
    (built here if None)."""
    if step is None:
        step = simt.make_step_traced(cfg, st["status"].shape[1],
                                     st["status"].device)
    for _ in range(k):
        st.update(step(ir, st))
    return bool(engine.make_cond(cfg)(st))
