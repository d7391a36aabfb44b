"""Derived metrics from engine counters (the paper's Figs. 5–10 quantities)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.core.config import DPUConfig
from repro_torch.core.isa import CLASS_NAMES


@dataclass
class KernelReport:
    """Per-kernel simulation report, aggregated over DPUs."""

    name: str
    n_dpus: int
    n_threads: int
    cycles: int                      # max over DPUs (kernel latency)
    issued: int                      # total instructions executed
    active_cycles: int
    idle_mem: int
    idle_rev: int
    idle_rf: int
    cls_counts: Dict[str, int]
    hist: np.ndarray                 # (T+1,) issuable-thread histogram (sum)
    ts: np.ndarray                   # (D, L) TLP time series
    dma_rd_bytes: float
    dma_wr_bytes: float
    row_hit: int
    row_miss: int
    tlb_hit: int
    tlb_miss: int
    dc_hit: int
    dc_miss: int
    acq_retry: int
    freq_mhz: int
    mram_bw_bytes_per_cycle: float
    extra: Dict[str, float] = field(default_factory=dict)

    # ---- paper metrics -----------------------------------------------------
    @property
    def kernel_seconds(self) -> float:
        return self.cycles / (self.freq_mhz * 1e6)

    @property
    def ipc(self) -> float:
        """Issued instructions per DPU-cycle (max 1 for baseline scalar DPU)."""
        total = self.cycles * self.n_dpus
        return self.issued / max(total, 1)

    @property
    def compute_util(self) -> float:
        """Fraction of peak issue throughput (Fig. 5 left axis)."""
        return self.ipc

    @property
    def mram_read_bw_util(self) -> float:
        """Fraction of per-DPU MRAM read bandwidth used (Fig. 5 right axis)."""
        peak = self.mram_bw_bytes_per_cycle * self.cycles * self.n_dpus
        return self.dma_rd_bytes / max(peak, 1e-9)

    @property
    def mram_write_bw_util(self) -> float:
        """Fraction of MRAM *write* bandwidth used — ``dma_wr_bytes``
        over the same per-DPU peak as the read side (the paper's DMA
        engine shares one MRAM port both ways), so the writeback half of
        streaming kernels is visible next to their read half."""
        peak = self.mram_bw_bytes_per_cycle * self.cycles * self.n_dpus
        return self.dma_wr_bytes / max(peak, 1e-9)

    @property
    def breakdown(self) -> Dict[str, float]:
        """Active / idle(mem) / idle(revolver) / idle(RF) fractions (Fig. 6)."""
        tot = max(self.active_cycles + self.idle_mem + self.idle_rev
                  + self.idle_rf, 1)
        return {
            "active": self.active_cycles / tot,
            "idle_memory": self.idle_mem / tot,
            "idle_revolver": self.idle_rev / tot,
            "idle_rf": self.idle_rf / tot,
        }

    @property
    def instr_mix(self) -> Dict[str, float]:
        tot = max(sum(self.cls_counts.values()), 1)
        return {k: v / tot for k, v in self.cls_counts.items()}

    @property
    def avg_issuable(self) -> float:
        w = np.arange(len(self.hist))
        return float((self.hist * w).sum() / max(self.hist.sum(), 1))

    def to_row(self) -> Dict[str, float]:
        r = {
            "name": self.name, "n_dpus": self.n_dpus,
            "n_threads": self.n_threads, "cycles": self.cycles,
            "issued": self.issued, "ipc": round(self.ipc, 4),
            "mram_rd_util": round(self.mram_read_bw_util, 4),
            "mram_wr_util": round(self.mram_write_bw_util, 4),
            "avg_issuable": round(self.avg_issuable, 3),
            "acq_retry": self.acq_retry,
        }
        r.update({f"frac_{k}": round(v, 4) for k, v in self.breakdown.items()})
        r.update({f"mix_{k}": round(v, 4) for k, v in self.instr_mix.items()})
        r.update(self.extra)
        return r


def report_from_state(name: str, cfg: DPUConfig, st, n_threads: int
                      ) -> KernelReport:
    cls = {CLASS_NAMES[i]: int(st["c_cls"][:, i].sum()) for i in range(6)}
    return KernelReport(
        name=name,
        n_dpus=int(st["status"].shape[0]),
        n_threads=n_threads,
        cycles=int(st["cycle"].max()),
        issued=int(st["c_issued"].sum()),
        active_cycles=int(st["c_active"].sum()),
        idle_mem=int(st["c_idle_mem"].sum()),
        idle_rev=int(st["c_idle_rev"].sum()),
        idle_rf=int(st["c_idle_rf"].sum()),
        cls_counts=cls,
        hist=np.asarray(st["c_hist"]).sum(0),
        ts=np.asarray(st["ts_buf"]),
        dma_rd_bytes=float(st["c_dma_rd_bytes"].sum()),
        dma_wr_bytes=float(st["c_dma_wr_bytes"].sum()),
        row_hit=int(st["c_row_hit"].sum()),
        row_miss=int(st["c_row_miss"].sum()),
        tlb_hit=int(st["c_tlb_hit"].sum()),
        tlb_miss=int(st["c_tlb_miss"].sum()),
        dc_hit=int(st["c_dc_hit"].sum()),
        dc_miss=int(st["c_dc_miss"].sum()),
        acq_retry=int(st["c_acq_retry"].sum()),
        freq_mhz=cfg.freq_mhz,
        mram_bw_bytes_per_cycle=cfg.effective_mram_bw,
    )
