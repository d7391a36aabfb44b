"""Carry inputs across from the JAX package: the port's "weights".

The simulator has no weights; what a run starts from is a configuration,
an assembled program and an initial state.  These helpers turn the JAX
package's objects (duck-typed: nothing of ``repro`` is imported) and
numpy state pytrees into the port's, so that a test can feed one set of
numpy-made inputs to both packages.  :func:`resolve_device` says where
they go.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.core.isa import Binary


def resolve_device(device=None) -> torch.device:
    """The torch device a run goes to: ``None`` means the CUDA card.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and there is no card: the port never falls back to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the simulator on the CPU")
    return dev


def config_from(ref_cfg) -> DPUConfig:
    """The port's :class:`DPUConfig` with every field of ``ref_cfg``."""
    return DPUConfig(**dataclasses.asdict(ref_cfg))


def binary_from(ref_binary) -> Binary:
    """The port's :class:`Binary` holding copies of ``ref_binary``'s
    instruction arrays, length and symbols."""
    arrays = [np.array(x, np.int32) for x in ref_binary.arrays]
    return Binary(*arrays, int(ref_binary.n_instrs),
                  dict(ref_binary.symbols))


def state_to_torch(st_np: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy state pytree -> dict of tensors on ``device`` (dtypes kept:
    int32, bool, float32).  Always copies: the engine updates WRAM/MRAM
    in place and must not write through to the caller's arrays."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device,
                                                            copy=True)
            for k, v in st_np.items()}


def state_to_numpy(st: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """dict of tensors (any device) -> numpy state pytree (copies, so
    later in-place steps do not show through)."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in st.items()}
