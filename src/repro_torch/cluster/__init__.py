"""repro_torch.cluster — multi-tenant PIM cluster runtime.

Trace-driven admission of mixed tenant jobs (PrIM kernels + LM decode)
onto disjoint rank subsets of one shared :class:`PIMSystem`, with
pluggable fault-aware placement, priority/preemption, and SLO metrics.

    from repro_torch.cluster import (TenantSpec, poisson_stream, PimCluster)

    stream = poisson_stream([TenantSpec("a", rate_hz=200.0)], horizon=0.05)
    report = PimCluster(system, policy="fault_aware").run(stream)
    print(report.table())
"""
from repro_torch.cluster.arrivals import (JOB_KINDS, JobSpec, TenantSpec,
                                    poisson_stream, save_trace,
                                    scale_rates, trace_stream)
from repro_torch.cluster.metrics import (COMPLETED, FAILED, REJECTED, SHED,
                                   ClusterReport, JobOutcome)
from repro_torch.cluster.scheduler import (POLICIES, ClusterLease, JobProfile,
                                     JobStep, PimCluster, measure_profile,
                                     synthetic_profiles, trace_profile,
                                     trace_profiles)

__all__ = [
    "JOB_KINDS", "JobSpec", "TenantSpec", "poisson_stream", "save_trace",
    "scale_rates", "trace_stream", "COMPLETED", "FAILED", "REJECTED",
    "SHED", "ClusterReport", "JobOutcome", "POLICIES", "ClusterLease",
    "JobProfile", "JobStep", "PimCluster", "measure_profile",
    "synthetic_profiles", "trace_profile", "trace_profiles",
]
