"""Fault injection, retry/backoff, and graceful degradation.

See ``model`` for the deterministic :class:`FaultPlan`, ``retry`` for
:class:`RetryPolicy`, and ``remap`` for shard remapping onto surviving
DPUs."""
from repro_torch.faults.model import (  # noqa: F401
    BITFLIP,
    LINK,
    PERMANENT,
    PERFECT_ECC,
    TRANSIENT,
    DpuFaultError,
    EccModel,
    FaultEvent,
    FaultPlan,
    FaultReport,
    LinkOutcome,
    kill_dpu,
)
from repro_torch.faults.retry import DEFAULT_POLICY, FAIL_FAST, RetryPolicy  # noqa: F401
