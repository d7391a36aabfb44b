"""Pluggable execution backends: the seam between the host runtime and a
simulated PIM microarchitecture (the port of :mod:`repro.core.backend`).

An :class:`ExecBackend` packages everything the compile cache and the
host launch path need to run an architecture:

* :meth:`~ExecBackend.make_state` — initial state as a host-numpy pytree
  (leading DPU axis; must contain ``"status"``, ``"cycle"`` and
  ``"mram"`` so the generic padding/readback/fault machinery works);
* :meth:`~ExecBackend.step_driver` — the per-cycle step and the
  termination predicate, built for one torch device;
* :meth:`~ExecBackend.static_key` — the config part of the compile-cache
  key;
* :meth:`~ExecBackend.pad_lanes` — mask DPU-bucket padding rows so they
  never issue;
* :meth:`~ExecBackend.report` — final state -> :class:`KernelReport`.

Only the UPMEM-style scalar backend is ported.  ``simt``, ``hbmpim`` and
``hbmpim_cmd`` stay in the lazy table: looking one up raises
:class:`NotImplementedError` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core import engine, isa, stats
from repro_torch.core.config import DPUConfig


class ExecBackend:
    """One simulated execution architecture (see module docstring).

    The base class implements the engine-family state layout (per-tasklet
    ``status``/``regs`` arrays); backends with a different layout override
    :meth:`pad_lanes` / :meth:`set_ndpus` / :meth:`finish_all` too."""

    #: registry name; also the first element of every compile-cache key
    name: str = "?"

    # ---- protocol ----------------------------------------------------------
    def validate(self, cfg: DPUConfig, binary, n_threads: int) -> None:
        """Raise if (cfg, binary, n_threads) cannot run on this backend."""

    def make_state(self, cfg: DPUConfig, binary, wram_init, mram_init,
                   n_threads: int):
        """Initial microarchitectural state (host-numpy pytree)."""
        raise NotImplementedError

    def step_driver(self, cfg: DPUConfig, n_threads: int, device) -> Tuple:
        """``(step, cond)``: the ``(ir, state) -> state`` cycle function
        and the termination predicate, for tensors on ``device``."""
        raise NotImplementedError

    def static_key(self, cfg: DPUConfig) -> tuple:
        """Hashable config identity for the compile cache (everything the
        step closes over)."""
        return cfg.static_key()

    def report(self, name: str, cfg: DPUConfig, st, n_threads: int
               ) -> "stats.KernelReport":
        """Aggregate the final state's counters into a KernelReport."""
        return stats.report_from_state(name, cfg, st, n_threads)

    # ---- lane masking (engine-family layout; override if different) --------
    def pad_lanes(self, cfg: DPUConfig, st, logical_d: int) -> None:
        """Mask DPU-bucket padding rows (``logical_d:``) so they never
        issue, and keep kernels seeing the logical system size."""
        st["status"][logical_d:] = engine.DONE
        st["regs"][:, :, isa.R_NDPU] = logical_d

    def set_ndpus(self, st, logical_d: int, ndpus_reg: int) -> None:
        """Override the ``N_DPUS`` register of the live rows (degraded
        remap launches keep the pre-fault logical width)."""
        st["regs"][:logical_d, :, isa.R_NDPU] = int(ndpus_reg)

    def finish_all(self, st) -> None:
        """Mark every lane DONE (prewarm builds without simulating)."""
        st["status"][:] = engine.DONE


class ScalarBackend(ExecBackend):
    """Baseline UPMEM-style MIMD DPU (in-order 14-stage scalar pipeline)."""

    name = "scalar"

    def make_state(self, cfg, binary, wram_init, mram_init, n_threads):
        return engine.make_state_np(cfg, binary, wram_init, mram_init,
                                    n_threads)

    def step_driver(self, cfg, n_threads, device):
        return (engine.make_step_traced(cfg, n_threads, device),
                engine.make_cond(cfg))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ExecBackend] = {}

#: backends imported on first get(); none of these modules is ported yet
_LAZY = {
    "simt": "repro_torch.core.simt",
    "hbmpim": "repro_torch.core.hbmpim",
    "hbmpim_cmd": "repro_torch.core.hbmpim",
}

#: where ROADMAP.md queues the port of each lazy backend
_ROADMAP_ITEM = {
    "simt": "ROADMAP.md, modules still to port: core/simt.py + SimtBackend",
    "hbmpim": "ROADMAP.md, modules still to port: core/hbmpim.py",
    "hbmpim_cmd": "ROADMAP.md, modules still to port: core/hbmpim.py",
}


def register(backend: ExecBackend) -> ExecBackend:
    """Add (or replace) a backend under ``backend.name``."""
    if not backend.name or backend.name == "?":
        raise ValueError("backend must carry a non-empty name")
    _REGISTRY[backend.name] = backend
    return backend


def get(name: str) -> ExecBackend:
    """Look up a registered backend (loading lazy modules on demand)."""
    be = _REGISTRY.get(name)
    if be is None and name in _LAZY:
        import importlib
        try:
            importlib.import_module(_LAZY[name])
        except ModuleNotFoundError as e:
            if e.name != _LAZY[name]:
                raise
            raise NotImplementedError(
                f"execution backend {name!r} is not ported to repro_torch "
                f"yet ({_ROADMAP_ITEM[name]})") from None
        be = _REGISTRY.get(name)
    if be is None:
        raise KeyError(
            f"unknown execution backend {name!r} (registered: "
            f"{', '.join(sorted(set(_REGISTRY) | set(_LAZY)))})")
    return be


def names() -> tuple:
    """Every addressable backend name (registered + lazy)."""
    return tuple(sorted(set(_REGISTRY) | set(_LAZY)))


def resolve_backend(cfg: DPUConfig, backend: Optional[str] = None) -> str:
    """The backend name a launch of ``cfg`` runs on.

    Precedence: an explicit ``backend`` argument, then ``cfg.backend``,
    then the legacy default — ``"simt"`` iff ``cfg.simt_width > 0``,
    else ``"scalar"``."""
    if backend:
        return backend
    if cfg.backend:
        return cfg.backend
    return "simt" if cfg.simt_width > 0 else "scalar"


register(ScalarBackend())
