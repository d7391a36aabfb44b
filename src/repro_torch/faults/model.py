"""Deterministic, seedable fault model for the PIM stack.

Real UPMEM ranks are not perfect machines: production modules ship with
faulty DPUs fused off (Gomez-Luna et al., arXiv:2105.03814, run on
~2,524 of 2,560 DPUs), launches occasionally fault transiently, MRAM is
susceptible to bit errors, and the multi-rank transfer path degrades
non-uniformly under load (arXiv:2110.01709).  This module prices those
failure modes so the pathfinding studies can ask what spare DPUs, ECC,
and retryable launches buy back.

A :class:`FaultPlan` is **pure and stateless**: every query is a
deterministic function of ``(seed, event kind, launch/transfer index,
attempt)``, so the same plan object can be replayed across runs and
across ``mode="inorder"`` / ``mode="async"`` systems and produce
bit-identical fault sequences (kernel launches and transfers execute
eagerly in program order in both modes, so the index streams match).
Mutable fault *state* — which DPUs are currently dead, what happened —
lives on :class:`~repro_torch.core.host.PIMSystem` (``active_mask``,
``fault_log``), not here.

Fault kinds:

* ``permanent`` — a DPU dies at a launch index and stays dead (the
  fused-off-lane model); sampled per DPU per launch at
  ``p_dpu_permanent``, or scheduled exactly with a
  :class:`FaultEvent`.
* ``transient`` — a kernel attempt faults on a subset of DPUs; the
  launch is retryable (the fault is keyed by attempt, so a retry draws
  fresh luck).  Surfaced as :class:`DpuFaultError` when retries are
  exhausted or the caller opted out of degraded execution.
* ``bitflip`` — an MRAM bit flips in the input image of a launch.  With
  no :class:`EccModel` the corruption is silent (the oracle's problem);
  with ECC each flip is corrected (cycles charged), detected but
  uncorrectable (the lane faults transiently — scrubbed on retry), or
  silently miscorrected.
* ``link`` — a host<->DPU transfer is degraded by a bandwidth factor or
  times out entirely; timeouts are retried under the system's
  :class:`~repro_torch.faults.retry.RetryPolicy`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# fault kinds (FaultEvent.kind / FaultReport.kind)
PERMANENT = "permanent"
TRANSIENT = "transient"
BITFLIP = "bitflip"
LINK = "link"

# rng stream codes: one independent SeedSequence stream per fault kind
_PERM, _TRANS, _FLIP, _LINK, _ECC = 1, 2, 3, 4, 5


@dataclass(frozen=True)
class FaultReport:
    """Structured record of one fault occurrence (or refusal).

    Appended to ``PIMSystem.fault_log`` as faults fire; carried by
    :class:`DpuFaultError` when a fault surfaces as an exception instead
    of silently wrong data."""

    kind: str                      # permanent|transient|bitflip|link|...
    label: str = ""                # kernel/transfer label
    launch: int = -1               # launch (or transfer) index
    attempt: int = 0
    dpus: Tuple[int, ...] = ()
    detail: str = ""
    wasted_seconds: float = 0.0    # modeled time lost to this fault

    def __str__(self):
        where = f" dpus={list(self.dpus)}" if self.dpus else ""
        return (f"[{self.kind}] {self.label or '?'}#{self.launch}"
                f" attempt={self.attempt}{where}"
                f"{': ' + self.detail if self.detail else ''}")


class DpuFaultError(RuntimeError):
    """A fault the runtime could not (or was told not to) absorb.

    Carries the :class:`FaultReport` describing what happened — callers
    branch on ``err.report.kind`` instead of parsing messages."""

    def __init__(self, report: FaultReport):
        super().__init__(str(report))
        self.report = report


@dataclass(frozen=True)
class EccModel:
    """MRAM ECC outcome model, priced in DPU cycles.

    Each bit flip independently resolves to one of three outcomes:
    corrected in place (probability ``p_correct``), detected but
    uncorrectable (``p_detect`` — the lane raises a transient fault and
    the retry re-reads clean data), or — the remainder — silently
    miscorrected/undetected (the corruption reaches the kernel)."""

    p_correct: float = 0.99
    p_detect: float = 0.01
    correct_cycles: int = 8        # scrub + writeback per corrected word
    detect_cycles: int = 64        # detection + machine-check signalling

    def __post_init__(self):
        if not (0.0 <= self.p_correct <= 1.0 and 0.0 <= self.p_detect <= 1.0
                and self.p_correct + self.p_detect <= 1.0 + 1e-12):
            raise ValueError("ECC probabilities must be in [0, 1] and "
                             "p_correct + p_detect <= 1")


#: perfect ECC: every flip corrected, cycles still charged
PERFECT_ECC = EccModel(p_correct=1.0, p_detect=0.0)


@dataclass(frozen=True)
class FaultEvent:
    """One explicitly scheduled fault (unit tests, CI smokes, what-ifs).

    ``launch`` indexes kernel launches for DPU faults and bit flips, and
    host transfers for link faults.  ``attempt`` scopes transient/link
    faults to one retry attempt (default 0: the first try fails, the
    retry succeeds)."""

    kind: str
    launch: int
    dpu: int = -1                  # DPU faults / bit flips
    attempt: int = 0               # transient / link / bitflip faults
    word: int = 0                  # bit flips: MRAM word index
    bit: int = 0                   # bit flips: bit position (0..31)
    factor: float = 1.0            # link: bandwidth degradation (>= 1)
    timeout: bool = False          # link: attempt times out entirely

    def __post_init__(self):
        if self.kind not in (PERMANENT, TRANSIENT, BITFLIP, LINK):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.factor < 1.0:
            raise ValueError("link degradation factor must be >= 1")


@dataclass(frozen=True)
class LinkOutcome:
    """Sampled outcome of one transfer attempt."""

    factor: float = 1.0            # effective slowdown (1.0 = healthy)
    timeout: bool = False


def kill_dpu(dpu: int, launch: int = 0) -> FaultEvent:
    """Convenience: a permanent DPU death at ``launch``."""
    return FaultEvent(PERMANENT, launch, dpu=dpu)


@dataclass(frozen=True)
class FaultPlan:
    """Schedules fault events — stochastically by rate, exactly by event.

    Rates are per launch (or per transfer, for links): a plan with
    ``p_dpu_permanent=0.02`` kills each live DPU with 2% probability at
    every kernel launch.  All-zero rates and no events make the plan a
    deterministic no-op whose timelines are bit-exact with a fault-free
    system (the fault layer is pay-for-what-you-use)."""

    seed: int = 0
    p_dpu_permanent: float = 0.0   # per DPU per launch
    p_dpu_transient: float = 0.0   # per DPU per launch attempt
    flips_per_launch: float = 0.0  # expected MRAM bit flips per attempt
    p_link_degrade: float = 0.0    # per transfer attempt
    link_degrade_factor: float = 4.0
    p_link_timeout: float = 0.0    # per transfer attempt
    ecc: Optional[EccModel] = None
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        for p in (self.p_dpu_permanent, self.p_dpu_transient,
                  self.p_link_degrade, self.p_link_timeout):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"fault probability {p} outside [0, 1]")
        if self.flips_per_launch < 0:
            raise ValueError("flips_per_launch must be >= 0")
        if self.link_degrade_factor < 1.0:
            raise ValueError("link_degrade_factor must be >= 1")
        object.__setattr__(self, "events", tuple(self.events))

    # ---- deterministic sampling -------------------------------------------
    def _rng(self, code: int, *key: int) -> np.random.Generator:
        # one Generator per (seed, kind, index, attempt): queries are pure
        # and order-independent, which is what makes same-seed runs
        # bit-identical across inorder/async modes and replays
        return np.random.default_rng([self.seed, code, *map(int, key)])

    def permanent_faults(self, launch: int, n_dpus: int) -> np.ndarray:
        """Bool mask of DPUs that die *during* launch ``launch``."""
        mask = np.zeros(n_dpus, bool)
        if self.p_dpu_permanent > 0.0:
            mask |= (self._rng(_PERM, launch).random(n_dpus)
                     < self.p_dpu_permanent)
        for ev in self.events:
            if (ev.kind == PERMANENT and ev.launch == launch
                    and 0 <= ev.dpu < n_dpus):
                mask[ev.dpu] = True
        return mask

    def transient_faults(self, launch: int, attempt: int,
                         n_dpus: int) -> np.ndarray:
        """Bool mask of DPUs whose kernel attempt faults transiently."""
        mask = np.zeros(n_dpus, bool)
        if self.p_dpu_transient > 0.0:
            mask |= (self._rng(_TRANS, launch, attempt).random(n_dpus)
                     < self.p_dpu_transient)
        for ev in self.events:
            if (ev.kind == TRANSIENT and ev.launch == launch
                    and ev.attempt == attempt and 0 <= ev.dpu < n_dpus):
                mask[ev.dpu] = True
        return mask

    def bitflips(self, launch: int, attempt: int, n_dpus: int,
                 n_words: int) -> List[Tuple[int, int, int]]:
        """``(dpu, word, bit)`` flips hitting this launch attempt's
        MRAM input image."""
        out: List[Tuple[int, int, int]] = []
        if self.flips_per_launch > 0.0 and n_words > 0:
            rng = self._rng(_FLIP, launch, attempt)
            for _ in range(int(rng.poisson(self.flips_per_launch))):
                out.append((int(rng.integers(n_dpus)),
                            int(rng.integers(n_words)),
                            int(rng.integers(32))))
        for ev in self.events:
            if (ev.kind == BITFLIP and ev.launch == launch
                    and ev.attempt == attempt and 0 <= ev.dpu < n_dpus
                    and 0 <= ev.word < n_words):
                out.append((ev.dpu, ev.word, ev.bit & 31))
        return out

    def ecc_outcomes(self, launch: int, attempt: int, n_flips: int
                     ) -> List[str]:
        """Per-flip ECC outcome: ``correct`` | ``detect`` | ``silent``."""
        if self.ecc is None:
            return ["silent"] * n_flips
        u = self._rng(_ECC, launch, attempt).random(n_flips)
        out = []
        for x in u:
            if x < self.ecc.p_correct:
                out.append("correct")
            elif x < self.ecc.p_correct + self.ecc.p_detect:
                out.append("detect")
            else:
                out.append("silent")
        return out

    def link_outcome(self, xfer: int, attempt: int) -> LinkOutcome:
        """Outcome of transfer ``xfer``'s ``attempt``-th try."""
        factor, timeout = 1.0, False
        if self.p_link_degrade > 0.0 or self.p_link_timeout > 0.0:
            # always draw both uniforms so adding one rate never
            # perturbs the other's sample stream
            u = self._rng(_LINK, xfer, attempt).random(2)
            timeout = u[0] < self.p_link_timeout
            if u[1] < self.p_link_degrade:
                factor = self.link_degrade_factor
        for ev in self.events:
            if (ev.kind == LINK and ev.launch == xfer
                    and ev.attempt == attempt):
                factor = max(factor, ev.factor)
                timeout = timeout or ev.timeout
        return LinkOutcome(factor=factor, timeout=timeout)

    @property
    def is_noop(self) -> bool:
        """True when the plan can never produce a fault."""
        return (not self.events
                and self.p_dpu_permanent == 0.0
                and self.p_dpu_transient == 0.0
                and self.flips_per_launch == 0.0
                and self.p_link_degrade == 0.0
                and self.p_link_timeout == 0.0)
