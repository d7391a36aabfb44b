"""Inter-DPU communication backends.

Each collective has three pluggable time models:

* :class:`HostBounceFabric` — today's UPMEM path (paper §II-B): every
  DPU-to-DPU byte is read back to the CPU over the slow host-read path
  and re-written over the host-write path, scheduled through the
  :class:`~repro_torch.comm.topology.RankTopology` (serialized within a
  channel, overlapped across channels, asymmetric directions).
* :class:`DirectFabric` — the paper's pathfinding hypothesis: a
  PIM-PIM interconnect with one ``link_gbps`` full-duplex link per DPU
  and a per-hop ``latency_s``. Collective times use the standard
  link-bottleneck closed forms (binomial-tree broadcast, ring
  all-reduce / all-gather, pairwise all-to-all); the host is not
  involved at all.
* :class:`HierarchicalFabric` — rank-locality pathfinding: a fast
  intra-rank interconnect plus a slower cross-rank fabric.  Every
  collective decomposes into an intra-rank stage (all ranks in
  parallel, priced as a :class:`DirectFabric` over the largest rank)
  and a cross-rank stage among per-rank leaders (priced as a
  :class:`DirectFabric` over the participating ranks).

All methods return modeled *seconds* for D DPUs; the actual payload
movement happens in :mod:`repro_torch.comm.collectives`, identically for all
backends — only the charged time differs.

Every fabric supports :meth:`Fabric.subset`: a pricing view restricted
to a DPU subset, used by rank-subset collectives (the view prices only
the involved ranks'/links' time, so two collectives on disjoint rank
sets can overlap in the :mod:`repro_torch.sched` scheduler).  Root arguments
are positions *within the member list* (identical to DPU ids for the
default whole-system fabric).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.comm.topology import D2H, H2D, RankTopology


def _members(n_dpus: int, dpus: Optional[Sequence[int]]) -> np.ndarray:
    if dpus is None:
        return np.arange(n_dpus)
    idx = np.asarray(sorted({int(d) for d in dpus}), int)
    if len(idx) == 0:
        raise ValueError("fabric subset needs at least one DPU")
    if idx[0] < 0 or idx[-1] >= n_dpus:
        raise ValueError(f"dpus {idx.tolist()} outside [0, {n_dpus})")
    return idx


class Fabric:
    name = "?"

    # every method takes total/shard *bytes* and returns seconds
    def bounce(self, per_dpu_bytes: float) -> float:
        """Legacy producer->consumer exchange of ``per_dpu_bytes`` each."""
        raise NotImplementedError

    def broadcast(self, n_bytes: float, root: int = 0) -> float:
        raise NotImplementedError

    def scatter(self, shard_bytes: float, root: int = 0) -> float:
        raise NotImplementedError

    def gather(self, shard_bytes: float, root: int = 0) -> float:
        raise NotImplementedError

    def reduce(self, n_bytes: float, root: int = 0) -> float:
        raise NotImplementedError

    def allreduce(self, n_bytes: float) -> float:
        raise NotImplementedError

    def allgather(self, shard_bytes: float) -> float:
        raise NotImplementedError

    def alltoall(self, pair_bytes: float) -> float:
        raise NotImplementedError

    def subset(self, dpus: Sequence[int]) -> "Fabric":
        """Pricing view over a DPU subset (see module docstring)."""
        raise NotImplementedError


class HostBounceFabric(Fabric):
    """DPU -> CPU -> DPU, scheduled on the rank/channel topology.

    Root handling is uniform across collectives: a leg that is redundant
    for the root — its payload already sits where it is needed — is
    excluded from the schedule.  For ``reduce`` that means the root's own
    contribution never crosses the link: the CPU combines the D-1 remote
    contributions and writes one partial back, which the root folds into
    its local value (mirror of ``gather``'s up leg)."""

    name = "host"

    def __init__(self, topology: RankTopology,
                 dpus: Optional[Sequence[int]] = None):
        self.topology = topology
        self.members = _members(topology.n_dpus, dpus)

    @property
    def n_dpus(self) -> int:
        return len(self.members)

    def subset(self, dpus: Sequence[int]) -> "HostBounceFabric":
        return HostBounceFabric(self.topology, dpus)

    def _sched(self, vec, direction) -> float:
        return self.topology.schedule(vec, direction).seconds

    def _vec(self, fill=0.0):
        """Full-topology byte vector with ``fill`` on the members only."""
        v = np.zeros(self.topology.n_dpus, np.float64)
        v[self.members] = fill
        return v

    def bounce(self, per_dpu_bytes: float) -> float:
        return (self._sched(self._vec(per_dpu_bytes), D2H)
                + self._sched(self._vec(per_dpu_bytes), H2D))

    def broadcast(self, n_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        up = self._vec()
        up[self.members[root]] = n_bytes   # host reads the source once
        down = self._vec(n_bytes)
        down[self.members[root]] = 0.0     # root already holds the payload
        return self._sched(up, D2H) + self._sched(down, H2D)

    def scatter(self, shard_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        up = self._vec()
        # serialized host-read of the D-1 remote shards
        up[self.members[root]] = (self.n_dpus - 1) * shard_bytes
        down = self._vec(shard_bytes)
        down[self.members[root]] = 0.0
        return self._sched(up, D2H) + self._sched(down, H2D)

    def gather(self, shard_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        up = self._vec(shard_bytes)
        up[self.members[root]] = 0.0
        down = self._vec()
        down[self.members[root]] = (self.n_dpus - 1) * shard_bytes
        return self._sched(up, D2H) + self._sched(down, H2D)

    def reduce(self, n_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        up = self._vec(n_bytes)
        up[self.members[root]] = 0.0       # root's contribution stays local
        down = self._vec()
        down[self.members[root]] = n_bytes
        return self._sched(up, D2H) + self._sched(down, H2D)

    def allreduce(self, n_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        return (self._sched(self._vec(n_bytes), D2H)
                + self._sched(self._vec(n_bytes), H2D))

    def allgather(self, shard_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        other = (self.n_dpus - 1) * shard_bytes
        return (self._sched(self._vec(shard_bytes), D2H)
                + self._sched(self._vec(other), H2D))

    def alltoall(self, pair_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        other = (self.n_dpus - 1) * pair_bytes
        return (self._sched(self._vec(other), D2H)
                + self._sched(self._vec(other), H2D))


class DirectFabric(Fabric):
    """Hypothetical PIM-PIM fabric: per-DPU link, host never touched."""

    name = "direct"

    def __init__(self, n_dpus: int, link_gbps: float = 1.0,
                 latency_s: float = 1e-7):
        if link_gbps <= 0:
            raise ValueError("link_gbps must be > 0")
        self.n_dpus = n_dpus
        self.bw = link_gbps * 1e9
        self.lat = latency_s

    def subset(self, dpus: Sequence[int]) -> "DirectFabric":
        # per-DPU links: only the subset's own links matter
        return DirectFabric(len(_members(self.n_dpus, dpus)),
                            link_gbps=self.bw / 1e9, latency_s=self.lat)

    def _t(self, link_bytes: float, hops: int) -> float:
        return link_bytes / self.bw + hops * self.lat

    def bounce(self, per_dpu_bytes: float) -> float:
        return self._t(per_dpu_bytes, 1)

    def broadcast(self, n_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        # pipelined binomial tree: each link forwards the full payload once
        return self._t(n_bytes, math.ceil(math.log2(self.n_dpus)))

    def scatter(self, shard_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        return self._t((self.n_dpus - 1) * shard_bytes, 1)  # root link bound

    def gather(self, shard_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        return self._t((self.n_dpus - 1) * shard_bytes, 1)

    def reduce(self, n_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        # ring reduce-scatter, then shards converge on the root's link
        D = self.n_dpus
        return self._t(2 * (D - 1) / D * n_bytes, D)

    def allreduce(self, n_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        D = self.n_dpus
        return self._t(2 * (D - 1) / D * n_bytes, 2 * (D - 1))

    def allgather(self, shard_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        D = self.n_dpus
        return self._t((D - 1) * shard_bytes, D - 1)

    def alltoall(self, pair_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        D = self.n_dpus
        return self._t((D - 1) * pair_bytes, D - 1)


class HierarchicalFabric(Fabric):
    """Two-stage rank-locality fabric (pathfinding: exploit rank locality).

    Decomposes every collective into

    1. an **intra-rank stage**: the members of each rank exchange with
       their rank leader over a fast local interconnect; all ranks
       proceed in parallel, so the stage costs one rank's time — a
       :class:`DirectFabric` over ``P`` (the largest participating
       rank's member count) at ``intra_gbps`` / ``intra_latency_s``;
    2. a **cross-rank stage**: the ``R`` rank leaders exchange over the
       global fabric — a :class:`DirectFabric` over ``R`` at
       ``inter_gbps`` / ``inter_latency_s``.

    With one DPU per rank this degenerates to a pure
    :class:`DirectFabric` over the ranks; with a single rank it
    degenerates to a pure intra-rank :class:`DirectFabric`.
    """

    name = "hier"

    def __init__(self, topology: RankTopology, intra_gbps: float = 8.0,
                 intra_latency_s: float = 5e-8, inter_gbps: float = 1.0,
                 inter_latency_s: float = 1e-7,
                 dpus: Optional[Sequence[int]] = None):
        self.topology = topology
        self.members = _members(topology.n_dpus, dpus)
        self._args = (intra_gbps, intra_latency_s, inter_gbps,
                      inter_latency_s)
        sizes = topology.rank_sizes(self.members)
        #: largest participating rank / number of participating ranks
        self.P = max(sizes)
        self.R = len(sizes)
        self._intra = DirectFabric(self.P, intra_gbps, intra_latency_s)
        self._inter = DirectFabric(self.R, inter_gbps, inter_latency_s)

    @property
    def n_dpus(self) -> int:
        return len(self.members)

    def subset(self, dpus: Sequence[int]) -> "HierarchicalFabric":
        return HierarchicalFabric(self.topology, *self._args, dpus=dpus)

    def bounce(self, per_dpu_bytes: float) -> float:
        return (self._intra.bounce(per_dpu_bytes)
                + self._inter.bounce(per_dpu_bytes))

    def broadcast(self, n_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        # root's leader fans out across ranks, then every rank fans in
        return (self._inter.broadcast(n_bytes)
                + self._intra.broadcast(n_bytes))

    def scatter(self, shard_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        # root leader ships P shards per remote rank, leaders deal locally
        return (self._inter.scatter(self.P * shard_bytes)
                + self._intra.scatter(shard_bytes))

    def gather(self, shard_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        return (self._intra.gather(shard_bytes)
                + self._inter.gather(self.P * shard_bytes))

    def reduce(self, n_bytes: float, root: int = 0) -> float:
        if self.n_dpus == 1:
            return 0.0
        return self._intra.reduce(n_bytes) + self._inter.reduce(n_bytes)

    def allreduce(self, n_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        # local reduce to leaders, leader all-reduce, local broadcast
        return (self._intra.reduce(n_bytes)
                + self._inter.allreduce(n_bytes)
                + self._intra.broadcast(n_bytes))

    def allgather(self, shard_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        return (self._intra.gather(shard_bytes)
                + self._inter.allgather(self.P * shard_bytes)
                + self._intra.broadcast(self.n_dpus * shard_bytes))

    def alltoall(self, pair_bytes: float) -> float:
        if self.n_dpus == 1:
            return 0.0
        t = self._intra.alltoall(pair_bytes)     # within-rank exchange
        if self.R > 1:
            # leaders aggregate members' cross-rank traffic, exchange
            # P*P*pair per leader pair, then deal back out
            cross = (self.n_dpus - self.P) * pair_bytes
            t += (self._intra.gather(cross)
                  + self._inter.alltoall(self.P * self.P * pair_bytes)
                  + self._intra.scatter(cross))
        return t


def make_fabric(cfg, topology: RankTopology) -> Fabric:
    """Build the fabric selected by ``cfg.fabric``."""
    if cfg.fabric == "host":
        return HostBounceFabric(topology)
    if cfg.fabric == "direct":
        return DirectFabric(topology.n_dpus, link_gbps=cfg.pim_link_gbps,
                            latency_s=cfg.pim_link_latency_us * 1e-6)
    if cfg.fabric == "hier":
        return HierarchicalFabric(
            topology,
            intra_gbps=cfg.intra_rank_gbps,
            intra_latency_s=cfg.intra_rank_latency_us * 1e-6,
            inter_gbps=cfg.pim_link_gbps,
            inter_latency_s=cfg.pim_link_latency_us * 1e-6)
    raise ValueError(
        f"unknown fabric {cfg.fabric!r} (want 'host'|'direct'|'hier')")
