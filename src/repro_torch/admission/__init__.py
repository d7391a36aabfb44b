"""repro_torch.admission — overload robustness for the serving stack.

Four composable mechanisms, all default-off and zero-cost when unused:

* :class:`AdmissionPolicy` / :class:`TokenBucket` — bounded queues and
  per-tenant rate limits turning overload into typed
  :class:`AdmissionRejected` backpressure instead of unbounded queue
  growth;
* :class:`HedgePolicy` — straggler cut-off by speculative re-issue on
  idle ranks, cancel-priced into the timeline's ``shed`` phase;
* :class:`CircuitBreaker` / :class:`RankBreakers` — rolling-fault-rate
  rank quarantine with half-open probe-back-in;
* :class:`ClusterJournal` / :class:`SimulatedCrash` — the JSONL
  write-ahead log behind ``PimCluster(journal=...)`` kill-and-resume.

See ``PimCluster(admission=, shedding=, hedge=, breaker=, journal=)``
and ``ServeEngine(max_queue=)`` for the integration points, and
``benchmarks/overload.py`` for the chaos sweeps that gate them.
"""
from repro_torch.admission.breaker import CircuitBreaker, RankBreakers
from repro_torch.admission.control import (AdmissionPolicy, AdmissionRejected,
                                     TokenBucket)
from repro_torch.admission.hedge import HedgePolicy
from repro_torch.admission.journal import (JOURNAL_VERSION, ClusterJournal,
                                     SimulatedCrash)

__all__ = [
    "AdmissionPolicy", "AdmissionRejected", "TokenBucket", "HedgePolicy",
    "CircuitBreaker", "RankBreakers", "ClusterJournal", "SimulatedCrash",
    "JOURNAL_VERSION",
]
