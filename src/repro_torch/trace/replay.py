"""Trace replay: re-price a recorded command stream under another config.

:func:`replay` rebuilds the recorded commands — transfers re-priced
through the replay config's :class:`~repro_torch.comm.topology.RankTopology`,
collectives through its fabric, kernels rescaled by clock ratio — and
re-resolves the overlapped schedule with the list scheduler.  No DPU
cycles are simulated, so a replay costs microseconds-per-command where
the live run cost engine time: that is the ≥10x speedup the CI smoke
gate pins, and what makes ``benchmarks/pathfind_arch.py``'s
fabric/topology sweeps cheap.

Replaying under the *unchanged* config is bit-exact vs. the live
``Timeline``: every pricing function is deterministic, JSONL floats
round-trip exactly, and commands are rebuilt in the recorded global
submission order (identical summation order)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from repro_torch.comm.fabric import make_fabric
from repro_torch.comm.topology import RankTopology
from repro_torch.core.config import DPUConfig
from repro_torch.core.host import Timeline
from repro_torch.sched import queue as sq
from repro_torch.sched import scheduler as ssched
from repro_torch.trace.record import TRACE_VERSION, load


@dataclass
class ReplayResult:
    """One replayed trace: the re-priced timeline + overlapped schedule."""

    timeline: Timeline
    schedule: Optional["ssched.Schedule"]
    cfg: DPUConfig
    n_commands: int

    @property
    def end_to_end(self) -> float:
        return self.timeline.end_to_end


def _chan_resources(topo: RankTopology, ev) -> Dict[str, float]:
    # mirrors PIMSystem._chan_resources (per-rank link shares)
    return {f"chan{topo.channel_of_rank(r)}:rank{r}": busy
            for r, busy in enumerate(ev.rank_busy) if busy > 0.0}


def _fabric_resources(topo: RankTopology, fabric_name: str, seconds: float,
                      ranks) -> Dict[str, float]:
    # mirrors PIMSystem._fabric_resources
    rr = range(topo.n_ranks) if ranks is None else ranks
    if fabric_name in ("direct", "hier"):
        return {f"fabric:rank{r}": seconds for r in rr}
    return {f"chan{topo.channel_of_rank(r)}:rank{r}": seconds for r in rr}


def replay(trace: Union[str, List[Dict]],
           cfg: Optional[DPUConfig] = None) -> ReplayResult:
    """Re-price ``trace`` (a JSONL path or a loaded record list) under
    ``cfg`` (default: the recorded config — the bit-exact case).

    Build what-if configs from the recorded one::

        base = repro_torch.trace.replay(path)            # bit-exact re-run
        what = base.cfg.replace(fabric="direct")
        fast = repro_torch.trace.replay(path, cfg=what)  # re-priced sweep point
    """
    records = load(trace) if isinstance(trace, (str, bytes)) else list(trace)
    if not records or records[0].get("type") != "header":
        raise ValueError("trace must start with a header record")
    header = records[0]
    if header.get("version") != TRACE_VERSION:
        raise ValueError(f"unsupported trace version {header.get('version')}")
    if cfg is None:
        cfg = DPUConfig(**header["cfg"])
    topo = RankTopology.from_config(cfg)
    fabric = make_fabric(cfg, topo)

    timeline = Timeline()
    queues: Dict[str, sq.CommandQueue] = {}
    events: Dict[int, sq.Event] = {}
    schedule = None
    seq = 0
    for rec in records[1:]:
        if rec["type"] == "sync":
            schedule = ssched.schedule(list(queues.values()),
                                       contention=cfg.channel_contention)
            timeline.elapsed = schedule.makespan
            continue
        if rec["type"] != "cmd":
            raise ValueError(f"unknown trace record type {rec['type']!r}")
        seconds = rec["seconds"]
        nbytes = rec["nbytes"]
        resources = rec["resources"]
        meta = rec.get("meta")
        if meta is not None:
            price = meta["price"]
            if price == "xfer":
                ev = topo.schedule(meta["bytes"], meta["dir"])
                seconds, nbytes = ev.seconds, ev.total_bytes
                resources = _chan_resources(topo, ev)
            elif price == "collective":
                dpus = meta["dpus"]
                fab = fabric if dpus is None else fabric.subset(dpus)
                ranks = None if dpus is None else topo.ranks_of(dpus)
                seconds = getattr(fab, meta["method"])(*meta["args"])
                resources = _fabric_resources(topo, fabric.name, seconds,
                                              ranks)
            elif price == "kernel":
                if meta["freq_mhz"] != cfg.freq_mhz:
                    seconds = seconds * (meta["freq_mhz"] / cfg.freq_mhz)
                ranks = meta["ranks"]
                rr = range(topo.n_ranks) if ranks is None else ranks
                resources = {f"rank{r}": seconds for r in rr}
            else:
                raise ValueError(f"unknown pricing spec {price!r}")
        cmd = sq.Command(
            kind=rec["kind"], label=rec["label"], seconds=seconds,
            seq=seq, queue=rec["queue"], phase=rec["phase"], nbytes=nbytes,
            resources=resources, wasted=rec["wasted"],
            attempt=rec["attempt"],
            waits=tuple(events[e] for e in rec["waits"]))
        seq += 1
        if "eid" in rec:
            ev = sq.Event(label=rec["label"])
            ev.recorder = cmd
            events[rec["eid"]] = ev
        queues.setdefault(rec["queue"], sq.CommandQueue(rec["queue"]))
        queues[rec["queue"]].submit(cmd)
        if rec["phase"] is not None:
            timeline.add(rec["phase"], seconds, rec["label"], nbytes)
    return ReplayResult(timeline=timeline, schedule=schedule, cfg=cfg,
                        n_commands=seq)
