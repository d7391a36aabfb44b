"""Plain version of the CRF step kernel: K eager command steps, then the
termination predicate (:func:`repro_torch.core.hbmpim.make_cmd_step`
then :func:`repro_torch.core.engine.make_cond`)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import engine, hbmpim
from repro_torch.core.config import DPUConfig


def crf_step_ref(cfg: DPUConfig, st: Dict[str, torch.Tensor],
                 ir: torch.Tensor, k: int,
                 step: Optional[Callable] = None) -> bool:
    """Advance ``st`` (its entries replaced) by ``k`` gated command steps
    of ``ir`` and return the termination predicate."""
    if step is None:
        step = hbmpim.make_cmd_step(cfg, st["status"].device)
    for _ in range(k):
        st.update(step(ir, st))
    return bool(engine.make_cond(cfg)(st))
