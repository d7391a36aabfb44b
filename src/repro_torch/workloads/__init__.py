"""PrIM-style workload registry of the torch port.

Only the streaming family (paper Table II: VA, RED, SCAN-SSA, SCAN-RSS,
SEL, UNI) is ported so far; :func:`get` names the module still to port
for every other workload of ``repro.workloads``."""
from repro_torch.workloads.streaming import RED, SCAN_RSS, SCAN_SSA, SEL, UNI, VA

ALL = {
    w.name: w for w in (
        RED(), SCAN_RSS(), SCAN_SSA(), SEL(), UNI(), VA(),
    )
}

#: workloads with a direct-addressing (cache-centric) variant for case #4
CACHEABLE = ("VA", "RED", "BS", "GEMV", "UNI", "SEL")

#: workload -> module of the JAX package it still waits for
NOT_PORTED = {
    "BFS": "graph", "NW": "graph", "HST-S": "histo", "HST-L": "histo",
    "GEMV": "linalg", "MLP": "linalg", "SpMV": "linalg", "TRNS": "linalg",
    "BS": "search", "TS": "search", "SSORT": "sort", "GEMVS": "gemv_stream",
}


def get(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"workload {name!r} lives in workloads/{NOT_PORTED[name]}.py, "
            "which is not ported yet (ROADMAP.md, modules still to port)")
    return ALL[name]
