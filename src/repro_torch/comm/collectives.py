"""Byte-accurate inter-DPU collectives over per-DPU MRAM images.

Every primitive physically moves numpy payloads between the rows of a
``(D, mram_words)`` int32 image (row d = DPU d's bank) *and* charges the
modeled transfer time of the system's fabric backend to the timeline's
``inter_dpu`` phase. Host-bounce, direct-fabric and hierarchical
backends move the same bytes — only the charged seconds differ — so
workload outputs are backend-independent by construction.

Offsets and counts are in 32-bit words, matching the engine's MRAM view.

Every primitive accepts ``dpus=``: an explicit DPU subset.  Only those
rows participate (``root`` must be one of them and still names an
absolute DPU id), the time is priced on the fabric's subset view, and
the queued COLLECTIVE command holds only the participating ranks' link
shares — so two collectives on disjoint rank sets overlap in an async
schedule instead of serializing on whole-channel resources.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

OPS: Dict[str, Callable] = {
    "sum": np.add,
    "max": np.maximum,
    "min": np.minimum,
    "or": np.bitwise_or,
    "and": np.bitwise_and,
}


def _charge(system, kind: str, seconds: float, nbytes: float, ranks=None,
            price=None):
    # routes through the repro_torch.sched command queue (COLLECTIVE command on
    # the current stream) and the timeline's inter_dpu phase; ``price``
    # records the fabric call that produced ``seconds`` so a trace
    # replay can re-price the exchange under a different fabric/topology
    system.collective(kind, seconds, nbytes, ranks=ranks, price=price)


def _price(idx, method: str, *args) -> dict:
    """Re-pricing spec: replay calls ``fabric[.subset(idx)].method(*args)``."""
    return {"method": method,
            "args": [int(a) if isinstance(a, (int, np.integer)) else float(a)
                     for a in args],
            "dpus": None if idx is None else [int(d) for d in idx]}


def _check_root_alive(system, root: int, kind: str):
    # a rooted collective through a faulted root would silently source or
    # sink garbage; surface it as a typed fault instead
    mask = getattr(system, "active_mask", None)
    if mask is not None and 0 <= root < len(mask) and not mask[root]:
        from repro_torch.faults.model import DpuFaultError, FaultReport
        raise DpuFaultError(FaultReport(
            kind="dead_root", label=kind, dpus=(int(root),),
            detail=f"{kind} rooted at faulted DPU {root}"))


def _check_region(mram, off: int, n: int):
    # numpy slicing would silently truncate; fail loudly instead so a
    # miscomputed offset can't move less data than the charged time claims
    if off < 0 or n < 0 or off + n > mram.shape[1]:
        raise ValueError(f"region [{off}, {off + n}) outside image of "
                         f"{mram.shape[1]} words")


def _reduce_rows(mram, off: int, n: int, op: str) -> np.ndarray:
    try:
        ufunc = OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r} (want {sorted(OPS)})")
    return ufunc.reduce(mram[:, off:off + n], axis=0)


def _normalize(mram, dpus: Optional[Sequence[int]]):
    """Sorted, deduplicated, bounds-checked subset index (None = all)."""
    if dpus is None:
        return None
    idx = np.asarray(sorted({int(d) for d in dpus}), int)
    if len(idx) == 0:
        raise ValueError("dpus subset must not be empty")
    if idx[0] < 0 or idx[-1] >= mram.shape[0]:
        raise ValueError(f"dpus {idx.tolist()} outside image of "
                         f"{mram.shape[0]} rows")
    return idx


def _view(system, mram, idx, words: int, *roots: int):
    """Working view for an optional subset ``idx``.

    Returns ``(view, fabric, ranks, mapped_roots)``: the first ``words``
    columns of the participating rows (the image itself when ``idx`` is
    None — a copy otherwise, sized to the touched region, committed back
    by :func:`_commit`), the fabric pricing view, the participating
    ranks (None = all), and each ``root`` mapped to its position within
    the subset."""
    if idx is None:
        return mram, system.fabric, None, roots
    if words > mram.shape[1]:
        raise ValueError(f"region [0, {words}) outside image of "
                         f"{mram.shape[1]} words")
    mapped = []
    for r in roots:
        pos = int(np.searchsorted(idx, r))
        if pos >= len(idx) or idx[pos] != r:
            raise ValueError(f"root {r} is not in dpus {idx.tolist()}")
        mapped.append(pos)
    return (mram[idx][:, :max(words, 0)], system.fabric.subset(idx),
            system.topology.ranks_of(idx), tuple(mapped))


def _commit(mram, idx, view):
    if idx is not None:
        for i, d in enumerate(idx):
            mram[d, :view.shape[1]] = view[i]


def broadcast(system, mram: np.ndarray, off: int, n: int, root: int = 0,
              dpus: Optional[Sequence[int]] = None):
    """Replicate ``n`` words at ``off`` from DPU ``root`` to all DPUs."""
    _check_root_alive(system, root, "broadcast")
    idx = _normalize(mram, dpus)
    view, fab, ranks, (r,) = _view(system, mram, idx, off + n, root)
    _check_region(view, off, n)
    D = view.shape[0]
    view[:, off:off + n] = view[r, off:off + n]
    if D > 1:
        _charge(system, "broadcast",
                fab.broadcast(4.0 * n, r), 4.0 * n * (D - 1), ranks,
                price=_price(idx, "broadcast", 4.0 * n, r))
    _commit(mram, idx, view)


def scatter(system, mram: np.ndarray, src_off: int, dst_off: int,
            n_per_dpu: int, root: int = 0,
            dpus: Optional[Sequence[int]] = None):
    """Split ``D * n_per_dpu`` words at ``src_off`` on ``root`` into
    per-DPU shards of ``n_per_dpu`` words at ``dst_off``."""
    _check_root_alive(system, root, "scatter")
    idx = _normalize(mram, dpus)
    D = mram.shape[0] if idx is None else len(idx)
    view, fab, ranks, (r,) = _view(
        system, mram, idx,
        max(src_off + D * n_per_dpu, dst_off + n_per_dpu), root)
    _check_region(view, src_off, D * n_per_dpu)
    _check_region(view, dst_off, n_per_dpu)
    src = view[r, src_off:src_off + D * n_per_dpu].copy()
    for d in range(D):
        view[d, dst_off:dst_off + n_per_dpu] = \
            src[d * n_per_dpu:(d + 1) * n_per_dpu]
    if D > 1:
        _charge(system, "scatter",
                fab.scatter(4.0 * n_per_dpu, r),
                4.0 * n_per_dpu * (D - 1), ranks,
                price=_price(idx, "scatter", 4.0 * n_per_dpu, r))
    _commit(mram, idx, view)


def gather(system, mram: np.ndarray, src_off: int, dst_off: int,
           n_per_dpu: int, root: int = 0,
           dpus: Optional[Sequence[int]] = None):
    """Concatenate each DPU's ``n_per_dpu``-word shard at ``src_off``
    into ``D * n_per_dpu`` words at ``dst_off`` on ``root``."""
    _check_root_alive(system, root, "gather")
    idx = _normalize(mram, dpus)
    D = mram.shape[0] if idx is None else len(idx)
    view, fab, ranks, (r,) = _view(
        system, mram, idx,
        max(src_off + n_per_dpu, dst_off + D * n_per_dpu), root)
    _check_region(view, src_off, n_per_dpu)
    _check_region(view, dst_off, D * n_per_dpu)
    shards = view[:, src_off:src_off + n_per_dpu].copy()
    view[r, dst_off:dst_off + D * n_per_dpu] = shards.reshape(-1)
    if D > 1:
        _charge(system, "gather",
                fab.gather(4.0 * n_per_dpu, r),
                4.0 * n_per_dpu * (D - 1), ranks,
                price=_price(idx, "gather", 4.0 * n_per_dpu, r))
    _commit(mram, idx, view)


def reduce(system, mram: np.ndarray, off: int, n: int, op: str = "sum",
           root: int = 0, dpus: Optional[Sequence[int]] = None):
    """Combine ``n`` words at ``off`` across DPUs onto ``root``."""
    _check_root_alive(system, root, "reduce")
    idx = _normalize(mram, dpus)
    view, fab, ranks, (r,) = _view(system, mram, idx, off + n, root)
    _check_region(view, off, n)
    D = view.shape[0]
    view[r, off:off + n] = _reduce_rows(view, off, n, op)
    if D > 1:
        # D-1 remote contributions cross the link; root's stays local
        _charge(system, "reduce",
                fab.reduce(4.0 * n, r), 4.0 * n * (D - 1), ranks,
                price=_price(idx, "reduce", 4.0 * n, r))
    _commit(mram, idx, view)


def allreduce(system, mram: np.ndarray, off: int, n: int, op: str = "sum",
              dpus: Optional[Sequence[int]] = None):
    """Combine ``n`` words at ``off`` across DPUs; all DPUs get the result."""
    idx = _normalize(mram, dpus)
    view, fab, ranks, _ = _view(system, mram, idx, off + n)
    _check_region(view, off, n)
    D = view.shape[0]
    view[:, off:off + n] = _reduce_rows(view, off, n, op)[None, :]
    if D > 1:
        # nbytes counts one direction's payload, like every other primitive
        _charge(system, "allreduce",
                fab.allreduce(4.0 * n), 4.0 * n * D, ranks,
                price=_price(idx, "allreduce", 4.0 * n))
    _commit(mram, idx, view)


def allgather(system, mram: np.ndarray, src_off: int, dst_off: int,
              n_per_dpu: int, dpus: Optional[Sequence[int]] = None):
    """Every DPU ends with the concatenation of all shards at ``dst_off``."""
    idx = _normalize(mram, dpus)
    D = mram.shape[0] if idx is None else len(idx)
    view, fab, ranks, _ = _view(
        system, mram, idx,
        max(src_off + n_per_dpu, dst_off + D * n_per_dpu))
    _check_region(view, src_off, n_per_dpu)
    _check_region(view, dst_off, D * n_per_dpu)
    flat = view[:, src_off:src_off + n_per_dpu].copy().reshape(-1)
    view[:, dst_off:dst_off + D * n_per_dpu] = flat[None, :]
    if D > 1:
        _charge(system, "allgather",
                fab.allgather(4.0 * n_per_dpu),
                4.0 * n_per_dpu * D * (D - 1), ranks,
                price=_price(idx, "allgather", 4.0 * n_per_dpu))
    _commit(mram, idx, view)


def alltoall(system, mram: np.ndarray, src_off: int, dst_off: int,
             n_per_pair: int, dpus: Optional[Sequence[int]] = None):
    """Transpose: DPU d's j-th ``n_per_pair``-word block goes to DPU j's
    d-th block (src and dst regions are ``D * n_per_pair`` words)."""
    idx = _normalize(mram, dpus)
    D = mram.shape[0] if idx is None else len(idx)
    view, fab, ranks, _ = _view(
        system, mram, idx, max(src_off, dst_off) + D * n_per_pair)
    _check_region(view, src_off, D * n_per_pair)
    _check_region(view, dst_off, D * n_per_pair)
    blocks = view[:, src_off:src_off + D * n_per_pair].copy()
    blocks = blocks.reshape(D, D, n_per_pair).transpose(1, 0, 2)
    view[:, dst_off:dst_off + D * n_per_pair] = blocks.reshape(D, -1)
    if D > 1:
        _charge(system, "alltoall",
                fab.alltoall(4.0 * n_per_pair),
                4.0 * n_per_pair * D * (D - 1), ranks,
                price=_price(idx, "alltoall", 4.0 * n_per_pair))
    _commit(mram, idx, view)
