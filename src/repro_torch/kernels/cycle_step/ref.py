"""Plain version of the fused cycle step: K eager engine steps, then the
termination predicate.

The counterpart of :func:`repro_torch.kernels.cycle_step.ops.cycle_step`
and its CPU path: ``k`` calls of
:func:`repro_torch.core.engine.make_step_traced` (on the card, the eager
step, whose ALU is the ``alu_exec`` kernel) followed by
:func:`repro_torch.core.engine.make_cond`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import engine
from repro_torch.core.config import DPUConfig


def cycle_step_ref(cfg: DPUConfig, st: Dict[str, torch.Tensor],
                   ir: torch.Tensor, k: int,
                   step: Optional[Callable] = None) -> bool:
    """Advance ``st`` (updated in place: its entries are replaced) by ``k``
    gated steps of the program image ``ir`` and return the termination
    predicate.  ``step``: a step built by ``make_step_traced`` for this
    configuration and device (built here if None)."""
    if step is None:
        step = engine.make_step_traced(cfg, st["status"].shape[1],
                                       st["status"].device)
    for _ in range(k):
        st.update(step(ir, st))
    return bool(engine.make_cond(cfg)(st))
