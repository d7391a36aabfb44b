"""Host-side interconnect topology: channels x ranks x DPUs.

Models the CPU<->DPU transfer path the paper measures in §II-B and that
Gomez-Luna et al. (arXiv:2105.03814) characterize on real hardware:

* transfers to distinct DPUs **within one rank** proceed in parallel, so a
  rank's transfer time is ``max-per-DPU-bytes / per-DPU-bandwidth``;
* ranks that share a memory **channel serialize** — the host's AVX copy
  loop drives one rank at a time per channel;
* distinct **channels overlap** — the host threads across channels;
* the path is **asymmetric**: host-write (h2d) runs at ~0.3 GB/s per DPU
  while host-read (d2h) runs at ~0.06 GB/s per DPU (paper Table I).

Each scheduled transfer also reports its **per-rank link share**
(``rank_busy``): the seconds during which rank *r*'s slice of its memory
channel is tied up by this transfer.  The :mod:`repro_torch.sched` scheduler
turns those shares into ``chan<c>:rank<r>`` resources, so operations on
*disjoint* rank sets can overlap even on one physical channel while
operations touching the *same* rank still serialize.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np

H2D = "h2d"
D2H = "d2h"


@dataclass(frozen=True)
class TransferEvent:
    """One scheduled host<->DPU transfer."""

    direction: str              # "h2d" | "d2h"
    seconds: float              # elapsed time (max over channels)
    total_bytes: float          # bytes moved across all DPUs
    channel_busy: Tuple[float, ...]  # per-channel busy seconds
    #: per-rank link share: rank r's channel is tied up this long by the
    #: transfer (0 for ranks that move no bytes).  A rank's share equals
    #: its whole channel's busy time — within one event the channel
    #: serializes over its ranks, so any rank it touches is unavailable
    #: until the channel drains.
    rank_busy: Tuple[float, ...] = ()


@dataclass(frozen=True)
class RankTopology:
    """``n_dpus`` DPUs split contiguously across ``n_ranks`` ranks; ranks
    are assigned round-robin to ``n_channels`` memory channels."""

    n_dpus: int
    n_ranks: int = 1
    n_channels: int = 1
    h2d_gbps_per_dpu: float = 0.296
    d2h_gbps_per_dpu: float = 0.063

    def __post_init__(self):
        if self.n_dpus < 1 or self.n_ranks < 1 or self.n_channels < 1:
            raise ValueError("topology sizes must be >= 1")
        if self.n_dpus % self.n_ranks:
            # an uneven ceil split would leave trailing ranks empty and
            # quietly simulate a different topology than configured
            raise ValueError(f"n_ranks={self.n_ranks} must divide "
                             f"n_dpus={self.n_dpus}")

    @classmethod
    def from_config(cls, cfg) -> "RankTopology":
        return cls(n_dpus=cfg.n_dpus,
                   n_ranks=cfg.n_ranks,
                   n_channels=cfg.n_channels,
                   h2d_gbps_per_dpu=cfg.h2d_gbps_per_dpu,
                   d2h_gbps_per_dpu=cfg.d2h_gbps_per_dpu)

    # ---- placement ---------------------------------------------------------
    @property
    def dpus_per_rank(self) -> int:
        return self.n_dpus // self.n_ranks  # exact; enforced in __post_init__

    def rank_of(self, dpu: int) -> int:
        return dpu // self.dpus_per_rank

    def channel_of_rank(self, rank: int) -> int:
        return rank % self.n_channels

    def dpu_slice(self, rank: int) -> slice:
        per = self.dpus_per_rank
        return slice(rank * per, (rank + 1) * per)

    def ranks_on_channel(self, channel: int):
        return [r for r in range(self.n_ranks)
                if self.channel_of_rank(r) == channel]

    def ranks_of(self, dpus: Sequence[int]) -> Tuple[int, ...]:
        """Sorted ranks containing any DPU of ``dpus`` (subset launches
        and rank-subset collectives hold only these ranks' resources)."""
        for d in dpus:
            if not 0 <= int(d) < self.n_dpus:
                raise ValueError(f"dpu {d} outside [0, {self.n_dpus})")
        return tuple(sorted({self.rank_of(int(d)) for d in dpus}))

    def rank_sizes(self, dpus: Sequence[int]) -> Tuple[int, ...]:
        """Members of ``dpus`` per participating rank (sorted by rank) —
        the hierarchical fabric prices its intra-rank stage on these."""
        counts = {}
        for d in dpus:
            counts[self.rank_of(int(d))] = counts.get(
                self.rank_of(int(d)), 0) + 1
        return tuple(counts[r] for r in sorted(counts))

    # ---- scheduling --------------------------------------------------------
    def _bw(self, direction: str) -> float:
        """Per-DPU bandwidth (bytes/s) for one direction."""
        if direction == H2D:
            return self.h2d_gbps_per_dpu * 1e9
        if direction == D2H:
            return self.d2h_gbps_per_dpu * 1e9
        raise ValueError(f"unknown direction {direction!r}")

    def schedule(self, per_dpu_bytes: Union[float, Sequence[float]],
                 direction: str) -> TransferEvent:
        """Schedule one bulk transfer; returns the modeled event.

        ``per_dpu_bytes`` is either a scalar (every DPU moves that many
        bytes) or a (n_dpus,) vector. Rank time = max bytes in the rank /
        per-DPU bw; channel busy = sum of its ranks (serialized); elapsed
        = max over channels (overlapped).  ``rank_busy[r]`` is rank r's
        channel busy time when the rank moves bytes, else 0.
        """
        vec = np.broadcast_to(np.asarray(per_dpu_bytes, np.float64),
                              (self.n_dpus,))
        bw = self._bw(direction)
        busy = [0.0] * self.n_channels
        per_rank = [0.0] * self.n_ranks
        for r in range(self.n_ranks):
            chunk = vec[self.dpu_slice(r)]
            per_rank[r] = float(chunk.max()) / bw
            busy[self.channel_of_rank(r)] += per_rank[r]
        rank_busy = tuple(
            busy[self.channel_of_rank(r)] if per_rank[r] > 0.0 else 0.0
            for r in range(self.n_ranks))
        return TransferEvent(direction=direction,
                             seconds=max(busy),
                             total_bytes=float(vec.sum()),
                             channel_busy=tuple(busy),
                             rank_busy=rank_busy)
