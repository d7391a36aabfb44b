"""``repro_torch.comm`` — multi-rank interconnect model + inter-DPU collectives.

Architecture map (module -> paper section it models):

* :mod:`repro_torch.comm.topology` — **§II-B / Table I / Fig. 10**: the
  CPU<->DPU channel model. ``RankTopology`` lays out channels x ranks x
  DPUs and schedules bulk transfers: parallel across DPUs within a rank,
  serialized between ranks sharing a channel, overlapped across
  channels, with the measured asymmetric host-write (h2d) vs host-read
  (d2h) bandwidths.
* :mod:`repro_torch.comm.fabric` — **§II-B** (``HostBounceFabric``: the only
  inter-DPU path on today's hardware is DPU -> CPU -> DPU) and the
  **pathfinding case study** (``DirectFabric``: a hypothetical PIM-PIM
  interconnect with configurable per-link bandwidth/latency, and
  ``HierarchicalFabric``: a two-stage intra-rank + cross-rank design
  that exploits rank locality, both of which the paper argues future
  PIM architectures need).  All backends support ``subset(dpus)``
  pricing views for rank-subset collectives.
* :mod:`repro_torch.comm.collectives` — **Fig. 10's inter-kernel exchanges**
  as first-class primitives: broadcast / scatter / gather / reduce /
  allreduce / allgather / alltoall. They move real numpy payloads
  between per-DPU MRAM images and charge modeled time through whichever
  fabric backend the :class:`~repro_torch.core.host.PIMSystem` was built with,
  so identical data moves under either backend — only the time differs.

Entry points: build a ``PIMSystem`` with ``DPUConfig(n_ranks=...,
n_channels=..., fabric="host"|"direct"|"hier")`` and call the
collectives with the system plus a ``(D, mram_words)`` image (pass
``dpus=`` for a rank-subset exchange); see
``examples/pim_comm_pathfind.py`` for the Fig. 10-style sweep.
"""
from repro_torch.comm.collectives import (allgather, allreduce, alltoall, broadcast,
                                    gather, reduce, scatter)
from repro_torch.comm.fabric import (DirectFabric, Fabric, HierarchicalFabric,
                               HostBounceFabric, make_fabric)
from repro_torch.comm.topology import RankTopology, TransferEvent

__all__ = [
    "RankTopology", "TransferEvent",
    "Fabric", "HostBounceFabric", "DirectFabric", "HierarchicalFabric",
    "make_fabric",
    "broadcast", "scatter", "gather", "reduce", "allreduce", "allgather",
    "alltoall",
]
