"""What one cell costs, counted on the meta device: the numbers
``launch/dryrun.py`` prices.

The reference reads XLA's ``cost_analysis`` and ``memory_analysis`` of a
compiled program.  The port has no compiler between it and the card, so
:func:`count` runs the cell's function itself on meta tensors (shapes
alone: nothing is allocated or computed) under one dispatch mode,
:class:`Counter`:

* **FLOPs** — the formulas of ``torch.utils.flop_counter.FlopCounterMode``
  (its registry, read per op: the mode itself tries to decompose every op
  it meets, which costs the sweep most of its time; the two agree on every
  family's cells, ``tests/test_torch_dryrun.py``): the matmul-class ops
  (mm, bmm, addmm, baddbmm, convolutions), forward and backward, and the
  ops that stand for the card's kernels on meta
  (``kernels/flash_attention/ops.py``, ``kernels/ssd_scan/ops.py``):
  flash, two products per visible (query, key) pair and head, five in its
  backward (:func:`flash_flops`); the SSD scan, its chunks' causal pairs
  and (N, P) state products (:func:`ssd_flops`); both the same counts as
  ``chip_smoke.py``'s bounds.  Elementwise work is not counted, where XLA
  counts it: on the smoke configurations the port's count is a stated
  band below XLA's (``tests/test_torch_dryrun_xla.py``).
* **bytes** — every op but views and bare
  allocations reads each tensor operand and writes each result once; the
  sum of their bytes (XLA's ``bytes accessed`` counts each HLO op alike).
* **temp** — live bytes: each result's storage from the op
  that made it until no tensor holds it (a storage weak reference, so
  what autograd saves for the backward counts), the peak of their sum
  over the run.  Storages of the arguments are not temp.  ``temp_top``
  names the largest term of that peak: the live storages of one dtype and
  shape that hold the most bytes (taken at each new peak 1% above the
  last one taken).

``args`` and ``out`` are the bytes of the distinct storages of the
arguments and of the results.

On a mesh (the dry-run's fake group, ``launch/mesh.py``) the function is
the sharded program of one rank, and every count is that rank's: its
blocks' bytes, its FLOPs, and the collectives it issued (``coll``: by
kind and group, the bytes of each result on this rank, as
``parallel/collectives.py`` records them; the collectives themselves do
not pass through the dispatch mode).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, shape_wrapper

# register the ops that stand for the kernels on meta
from repro_torch.kernels.flash_attention import ops as _flash_ops  # noqa: F401
from repro_torch.kernels.ssd_scan import ops as _ssd_ops  # noqa: F401
from repro_torch.parallel import collectives as coll

aten = torch.ops.aten

#: ops that allocate without reading or writing anything
_ALLOCATIONS = {aten.empty.memory_format, aten.empty_strided.default,
                aten.empty_like.default, aten.new_empty.default,
                aten.new_empty_strided.default}


def visible_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs one head of an attention over ``s``
    positions computes: all of them, the causal ones, or those within the
    trailing ``window``."""
    if window > 0:
        w = min(window, s)
        return w * (w + 1) // 2 + (s - w) * w
    return s * (s + 1) // 2 if causal else s * s


def flash_flops(q, k, v, causal, window, *, out_shape=None, **_) -> int:
    """FLOPs of one flash-attention forward: 2 (Dk + Dv) per visible pair
    and head."""
    B, S, H, Dk = q
    return 2 * B * H * visible_pairs(S, causal, window) * (Dk + v[3])


def flash_bwd_flops(q, k, v, o, do, causal, window, *, out_shape=None,
                    **_) -> int:
    """FLOPs of one flash-attention backward: S, dP, dV, dQ and dK, 2 (3
    Dk + 2 Dv) per visible pair and head."""
    B, S, H, Dk = q
    return 2 * B * H * visible_pairs(S, causal, window) * (3 * Dk + 2 * v[3])


def _ssd_chunks(s: int, chunk: int):
    """(rows, causal pairs) of each chunk over ``s`` positions (a ragged
    last one)."""
    q = min(chunk, s)
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    return [(r, visible_pairs(r, True, 0)) for r in rows]


def ssd_flops(x, dt, A, Bm, Cm, chunk, *, out_shape=None, **_) -> int:
    """FLOPs of one SSD scan: per chunk of r rows, C.B over its r(r+1)/2
    causal pairs once per group, the weighted x over them for every head,
    and the inter-chunk and state products, 2 r N P each."""
    B, S, H, P = x
    G, N = Bm[2], Bm[3]
    return sum(2 * B * (G * pairs * N + H * (pairs * P + 2 * r * N * P))
               for r, pairs in _ssd_chunks(S, chunk))


def ssd_bwd_flops(x, dt, A, Bm, Cm, dy, chunk, *, out_shape=None,
                  **_) -> int:
    """FLOPs of one SSD backward: per chunk of r rows, C.B over the causal
    pairs once per group, then for every head dy.x, dx, dB and dC over
    them and five (N, P) products a row."""
    B, S, H, P = x
    G, N = Bm[2], Bm[3]
    return sum(2 * B * (G * pairs * N + H * (pairs * (2 * P + 2 * N)
                                             + 5 * r * N * P))
               for r, pairs in _ssd_chunks(S, chunk))


#: op -> FLOPs from its inputs' shapes, of the ops that stand for the
#: card's kernels on meta
KERNEL_FLOPS = {
    torch.ops.repro_torch.flash_attention_meta: flash_flops,
    torch.ops.repro_torch.flash_attention_bwd_meta: flash_bwd_flops,
    torch.ops.repro_torch.ssd_scan_meta: ssd_flops,
    torch.ops.repro_torch.ssd_scan_bwd_meta: ssd_bwd_flops,
}


def _tensors(tree) -> list:
    """The tensors in ``tree``: dicts, lists and tuples walked, a
    module's parameters and buffers."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``
    (:func:`_tensors`)."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


#: op -> its FLOPs: FlopCounterMode's formulas and the kernel ops'
FORMULAS = {**flop_registry,
            **{op: shape_wrapper(f) for op, f in KERNEL_FLOPS.items()}}


class Counter(TorchDispatchMode):
    """Counts ``flops`` (:data:`FORMULAS`), ``bytes`` (operands and results
    of every op that moves data) and the peak ``peak`` of live result
    storages (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.peak = 0
        self.top = ()            # (dtype and shape, how many, bytes)
        self._top_at = 0
        self._live = {}          # storage address -> (weak ref, bytes, key)
        self._bound = 0          # their bytes, some perhaps freed

    def _sweep(self) -> int:
        gone = [k for k, (w, _, _) in self._live.items() if w.expired()]
        for k in gone:
            self._bound -= self._live.pop(k)[1]
        return self._bound

    def _take_top(self):
        groups = {}
        for _, n, key in self._live.values():
            c, b = groups.get(key, (0, 0))
            groups[key] = (c + 1, b + n)
        key = max(groups, key=lambda k: groups[k][1])
        self.top = (key, *groups[key])
        self._top_at = self.peak

    def _hold(self, t: torch.Tensor, inputs: set):
        st = t.untyped_storage()
        key = st._cdata
        held = self._live.get(key)
        if held is not None and not held[0].expired():
            return
        if held is not None:                 # an address reused
            self._bound -= self._live.pop(key)[1]
        if key in inputs:                    # a view or in-place result
            return
        n = st.nbytes()
        self._live[key] = (StorageWeakRef(st), n,
                           f"{str(t.dtype).replace('torch.', '')} "
                           f"{tuple(t.shape)}")
        self._bound += n
        if self._bound > self.peak:
            self.peak = max(self.peak, self._sweep())
            if self.peak > 1.01 * self._top_at:
                self._take_top()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = FORMULAS.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not func.is_view and func not in _ALLOCATIONS:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._hold(t, keys)
        return out


@dataclass
class Counts:
    """What :func:`count` counted: FLOPs, bytes accessed, the bytes of the
    arguments, the results and the peak of the temporaries, the
    collectives' result bytes by (kind, the group's global ranks), and the
    temporaries' largest term at their peak (``Counter.top``)."""

    flops: float
    bytes: float
    args: float
    out: float
    temp: float
    coll: Dict[Tuple[str, Tuple[int, ...]], float] = field(
        default_factory=dict)
    temp_top: tuple = ()

    def scaled(self, other: "Counts", s: float) -> "Counts":
        """``self + (other - self) * s``, field by field (``coll`` key by
        key): the reference's extrapolation in depth from two
        reduced-depth points (``temp_top``: ``other``'s)."""
        keys = set(self.coll) | set(other.coll)
        coll_s = {k: self.coll.get(k, 0.0)
                  + (other.coll.get(k, 0.0) - self.coll.get(k, 0.0)) * s
                  for k in keys}
        return Counts(*(a + (b - a) * s for a, b in zip(
            (self.flops, self.bytes, self.args, self.out, self.temp),
            (other.flops, other.bytes, other.args, other.out, other.temp))),
            coll_s, other.temp_top)

    def coll_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (kind, _), b in self.coll.items():
            out[kind] = out.get(kind, 0.0) + b
        return out


def count(fn, *args: Any) -> Counts:
    """Run ``fn(*args)`` (meta tensors) under the :class:`Counter`."""
    args_bytes = tree_bytes(args)
    before = dict(coll.BY_GROUP)
    with Counter() as c:
        out = fn(*args)
    issued = {k: float(b - before.get(k, 0))
              for k, b in coll.BY_GROUP.items() if b != before.get(k, 0)}
    return Counts(float(c.flops), float(c.bytes), float(args_bytes),
                  float(tree_bytes(out)), float(c.peak), issued, c.top)
