"""Roofline terms of a counted cell.

Per (arch x shape x mesh):
    compute    = FLOPs             / (chips x peak FLOP/s)
    memory     = bytes accessed    / (chips x HBM bytes/s)
    collective = collective bytes  / (chips x link bytes/s)

The counterpart of ``repro.launch.roofline``, for the port: the same
report, ``model_flops``, ``model_bytes_decode`` and HLO collective parser,
with the hardware a field of :class:`RooflineReport`.  Its default,
:data:`TPU_V5E`, holds the reference's constants (``PEAK_FLOPS``,
``HBM_BW``, ``LINK_BW``), so ``to_row()`` gives the reference's numbers
for the same inputs; the port's dry-run (``launch/dryrun.py``) prices its
counts with :data:`H100` instead, and the collectives of a mesh row on
:data:`H100_FLEET`, each group by the slowest link it crosses
(:meth:`Fleet.seconds`, the report's ``coll_seconds``).  The reference's
``analyze`` reads an XLA compiled object; the port has none (its counts
come from ``launch/cost.py``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Tuple


@dataclass(frozen=True)
class Hardware:
    """A chip's peak rates: dense bf16 FLOP/s, HBM bytes/s, and one link's
    bytes/s."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# The reference's v5e-class hardware constants (``repro/launch/roofline.py``
# :20-23), kept under their names for parity: examples/
# torch_pim_offload_planner.py prints the reference's TPU estimate with
# them.  They are a TPU's, never the port's.
PEAK_FLOPS = 197e12       # bf16 FLOP/s per chip
HBM_BW = 819e9            # bytes/s per chip
LINK_BW = 50e9            # bytes/s per link (ICI)
TPU_V5E = Hardware("TPU v5e (the reference's constants)", PEAK_FLOPS,
                   HBM_BW, LINK_BW)

# NVIDIA H100 SXM data sheet, dense rates without sparsity at the full
# 700 W: 989 TFLOP/s bf16 tensor-core, 3.35 TB/s HBM3, NVLink 4 at 900
# GB/s a card both ways together (450 GB/s each way, the rate a send
# sees).
H100 = Hardware("NVIDIA H100 SXM (data sheet)", 989e12, 3.35e12, 450e9)


@dataclass(frozen=True)
class Fleet:
    """A fleet of cards: ``per_node`` to a node joined by ``node_bw``
    (bytes/s each way a card), the nodes by ``fabric_bw`` (bytes/s each
    way a card).  Ranks are laid out row-major over the mesh (rank r on
    node r // per_node), so a group is priced by the slowest link it
    crosses."""

    name: str
    per_node: int
    node_bw: float
    fabric_bw: float

    def link_bw(self, members: Iterable[int]) -> float:
        nodes = {m // self.per_node for m in members}
        return self.node_bw if len(nodes) <= 1 else self.fabric_bw

    def seconds(self, by_group: Mapping[Tuple[str, Tuple[int, ...]], float]
                ) -> float:
        """The collectives' time: each group's result bytes over its
        slowest link, summed."""
        return sum(b / self.link_bw(m) for (_, m), b in by_group.items())


# HGX H100 data sheets: 8 cards to a node on NVLink 4 (450 GB/s each way a
# card, as H100.link_bw); nodes on NDR InfiniBand, one 400 Gb/s link a
# card (50 GB/s each way).
H100_FLEET = Fleet("HGX H100 nodes of 8 (NVLink 4, 450 GB/s each way a "
                   "card) on NDR InfiniBand (400 Gb/s a card: 50 GB/s)",
                   8, 450e9, 50e9)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Sum bytes over every tensor literal in an HLO type string
    (handles tuples '(bf16[8,128], f32[4])')."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective-kind result bytes (per device) from optimized HLO.
    The port has no HLO (its mesh rows count the collectives its ranks
    issue, ``launch/cost.py``): this is the reference's parser, kept with
    its test cases so that the module stays the reference's copy."""
    out = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        s = line.strip()
        # result lines look like: '%x = bf16[...] all-reduce(...)' or
        # '%t = (f32[..], f32[..]) all-gather(..)'
        m = re.search(r"=\s*(\([^)]*\)|\S+)\s+(\S+?)\(", s)
        if not m:
            continue
        op = m.group(2).rstrip(".0123456789")  # all-reduce.123 -> all-reduce
        # fused variants like all-reduce-start
        for kind in _COLLECTIVES:
            if op == kind or op.startswith(kind + "-start"):
                out[kind] += _shape_bytes(m.group(1))
                break
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    model_flops: float
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    bytes_temp: float = 0.0
    kind: str = "train"
    model_bytes: float = 0.0  # useful traffic (decode: params + cache)
    notes: str = ""
    hw: Hardware = field(default=TPU_V5E)
    #: the collectives' seconds when priced by group (``Fleet.seconds``);
    #: None: ``coll_bytes_per_device`` over ``hw.link_bw``
    coll_seconds: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        if self.coll_seconds is not None:
            return self.coll_seconds
        return self.coll_bytes_per_device / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — remat/redundancy waste
        gauge."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful work / achievable step time on the binding resource.

        train/prefill: useful MODEL_FLOPS time vs the dominant term.
        decode: bandwidth-bound by definition — useful bytes (params read
        once + KV/state read once) vs the counted memory traffic."""
        t_bound = max(self.compute_s, self.memory_s, self.collective_s)
        if not t_bound:
            return 0.0
        if self.kind == "decode" and self.model_bytes:
            return (self.model_bytes / (self.chips * self.hw.hbm_bw)) \
                / t_bound
        t_use = self.model_flops / (self.chips * self.hw.peak_flops)
        return t_use / t_bound

    def to_row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "bottleneck": self.bottleneck,
            "model_gflops": round(self.model_flops / 1e9, 1),
            "useful_ratio": round(self.useful_ratio, 3),
            "roofline_fraction": round(self.roofline_fraction, 3),
            "coll": {k: v for k, v in self.coll_breakdown.items() if v},
            "notes": self.notes,
        }


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D train / 2*N*D forward (N_active for MoE)."""
    n = cfg.param_count(active_only=(cfg.family == "moe"))
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def model_bytes_decode(cfg, shape) -> float:
    """Useful decode traffic: active params once (bf16 compute reads) +
    KV cache / recurrent state once."""
    n = cfg.param_count(active_only=(cfg.family == "moe"))
    params = 2.0 * n
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        state = cfg.n_layers * B * cfg.n_ssm_heads * cfg.ssm_state \
            * cfg.ssm_headdim * 4.0
    elif cfg.family == "hybrid":
        ng = cfg.n_layers // 3
        W = cfg.lru_width or cfg.d_model
        state = (cfg.n_layers - ng) * B * W * 4.0 \
            + ng * B * min(cfg.window, S) * cfg.n_kv_heads * cfg.d_head * 4.0
    elif cfg.use_mla:
        state = cfg.n_layers * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0
    else:
        L = cfg.n_dec_layers or cfg.n_layers
        state = L * B * S * 2 * cfg.n_kv_heads * cfg.d_head * 2.0
    return params + state
