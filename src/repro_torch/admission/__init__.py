"""Admission control of the serving stack: typed backpressure
(:class:`AdmissionRejected`) and token buckets, copied from
``repro.admission.control``.  The breaker, hedge and journal modules of
``repro.admission`` are not ported yet (ROADMAP §1)."""
from repro_torch.admission.control import (AdmissionPolicy, AdmissionRejected,
                                           TokenBucket)

__all__ = ["AdmissionPolicy", "AdmissionRejected", "TokenBucket"]
