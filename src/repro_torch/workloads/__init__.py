"""PrIM-style workload registry (paper Table II + the SSORT
distributed sample sort, the alltoall pathfinding workload)."""
from repro_torch.workloads.gemv_stream import GEMVS
from repro_torch.workloads.graph import BFS, NW
from repro_torch.workloads.histo import HST_L, HST_S
from repro_torch.workloads.linalg import GEMV, MLP, SpMV, TRNS
from repro_torch.workloads.search import BS, TS
from repro_torch.workloads.sort import SSORT
from repro_torch.workloads.streaming import RED, SCAN_RSS, SCAN_SSA, SEL, UNI, VA

ALL = {
    w.name: w for w in (
        BFS(), BS(), GEMV(), GEMVS(), HST_L(), HST_S(), MLP(), NW(), RED(),
        SCAN_RSS(), SCAN_SSA(), SEL(), SpMV(), SSORT(), TRNS(), TS(),
        UNI(), VA(),
    )
}

#: workloads with a direct-addressing (cache-centric) variant for case #4
CACHEABLE = ("VA", "RED", "BS", "GEMV", "UNI", "SEL")


def get(name: str):
    return ALL[name]
