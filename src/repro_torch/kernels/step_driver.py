"""What the step kernels' drivers share: a launch's state on the card,
checked once (every leaf's device, dtype, shape and contiguity), advanced
K steps a launch, the predicate read from a device flag.

A subclass names its kernel (``name``), its leaves and their table
(``LEAVES``, :meth:`leaf_table`), the state keys the plain version's
state has (:meth:`state_keys`), its ``Args`` structure, its
configuration (:meth:`configure`), its library and its C launcher
(:meth:`call`), and its launch count (:meth:`count`).  By default a
launch is the SIMT and CRF kernels' scheme: two ordinary kernels (a run
kernel that steps each simulated DPU while it runs, and a tail kernel
that gives the DPUs that stopped early their gated steps and writes the
predicate; ``csrc/simt_step.cu`` and ``csrc/crf_step.cu`` explain it).
The fused cycle step overrides :meth:`scratch` and :meth:`run`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class StepDriver:
    """``launch(k)`` runs k steps in one counted launch on the current
    stream, ``run(k)`` the same uncounted (timing loops), ``predicate()``
    reads the flag the kernel wrote (one host sync)."""

    name = "?"
    LEAVES: tuple = ()

    def __init__(self, cfg, st: Dict[str, torch.Tensor], ir: torch.Tensor,
                 image: Optional[np.ndarray] = None):
        dev = st["status"].device if "status" in st else ir.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel runs on CUDA tensors, "
                             f"got {dev}")
        self._check_state(cfg, st, dev)
        if not (ir.device == dev and ir.dtype == torch.int32
                and ir.dim() == 2 and ir.shape[0] == 6 and ir.shape[1] > 0):
            raise ValueError(f"{self.name}: ir must be a (6, P) int32 tensor "
                             f"on {dev}, got {tuple(ir.shape)} {ir.dtype} on "
                             f"{ir.device}")
        if image is None:
            image = ir.cpu().numpy()
        self.st, self.device = st, dev
        self.image = torch.from_numpy(self.pack(cfg, image)).to(dev)
        self.flag = torch.zeros(1, dtype=torch.int32, device=dev)  # predicate
        args = self.Args()
        for i, name in enumerate(self.LEAVES):
            args.leaf[i] = st[name].data_ptr()
        args.image = self.image.data_ptr()
        args.flag = self.flag.data_ptr()
        self.args = args
        self.scratch(st["status"].shape[0])
        self._k = self.configure(cfg, st, ir.shape[1])
        with torch.cuda.device(dev):    # builds the library at first use
            self.library()

    # ---- what a kernel provides ----
    def state_keys(self, cfg, st) -> set:
        raise NotImplementedError

    def leaf_table(self, cfg, st) -> dict:
        raise NotImplementedError

    def pack(self, cfg, image: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def scratch(self, D: int) -> None:
        """Allocate the kernel's scratch beside the flag and point
        ``self.args`` at it: each DPU's phase-1 steps and the two votes
        (alternate launches use alternate ones)."""
        self.stop = torch.zeros(D, dtype=torch.int32, device=self.device)
        self.vote = torch.zeros(2, dtype=torch.int32, device=self.device)
        self.args.stop = self.stop.data_ptr()
        self.args.vote = self.vote.data_ptr()

    def configure(self, cfg, st, P: int) -> int:
        """Fill ``self.args``' configuration; return the index of K."""
        raise NotImplementedError

    def library(self):
        raise NotImplementedError

    def call(self, stream: int) -> None:
        raise NotImplementedError

    def count(self) -> None:
        """Add one to the kernel's launch count."""
        raise NotImplementedError

    # ---- the driver ----
    def launch(self, k: int) -> None:
        """Advance ``k`` steps in one launch (the kernel stops early once
        no DPU runs), counted."""
        self.run(k)
        self.count()

    def run(self, k: int) -> None:
        """:meth:`launch` without the count."""
        if k < 1:
            raise ValueError(f"{self.name}: k = {k} < 1")
        self.args.c[self._k] = k
        self.call(torch.cuda.current_stream(self.device).cuda_stream)
        self.args.parity ^= 1

    def predicate(self) -> bool:
        """The termination predicate after the last launch (syncs)."""
        return bool(self.flag.item())

    def _check_state(self, cfg, st, dev):
        want = self.state_keys(cfg, st)
        if set(st) != want:
            raise ValueError(
                f"{self.name}: state keys differ from the engine's: missing "
                f"{sorted(want - set(st))}, unexpected {sorted(set(st) - want)}")
        for name, (dtype, shape) in self.leaf_table(cfg, st).items():
            t = st[name]
            if t.device != dev:
                raise ValueError(f"{self.name}: {name} on {t.device}, status "
                                 f"on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"{self.name}: {name} must be {dtype}, got "
                                f"{t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{self.name}: {name} shape "
                                 f"{tuple(t.shape)} != {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {name} must be contiguous")
