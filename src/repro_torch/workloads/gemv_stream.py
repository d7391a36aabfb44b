"""GEMVS — streaming GEMV/MAC, the first workload native to *both*
simulated PIM architectures.

On the UPMEM-style MIMD targets (``scalar``/``simt``) it is the
row-striped streaming GEMV kernel: each tasklet DMAs one matrix row at a
time and reduces it against the staged ``x`` vector (the PrIM access
pattern the SIMT coalescer exploits).

On the HBM-PIM targets (``backend="hbmpim"`` / ``"hbmpim_cmd"``) it
switches to the *native* all-bank command path: the matrix is laid out
column-major in ``hbm_lanes``-wide bank rows, ``x`` is broadcast through
the SRF eight scalars at a time, and each chunk issues an unrolled
``MAC bank(acc) <- bank(A_col), srf(x_k)`` CRF stream through
:func:`repro_torch.core.hbmpim.launch_commands` — the real part's
vector-scalar MAC discipline (CRF has no address registers, so the
column sweep is unrolled into commands; programs are split to respect
``hbm_crf_slots``).

Same ``Workload.run`` API, same numpy oracle, on either architecture —
the pathfinding comparison ``benchmarks/pathfind_arch.py`` is built on
exactly this property.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import backend as backends
from repro_torch.core.host import merge_reports
from repro_torch.workloads.linalg import GEMV, GEMV_C


class GEMVS(GEMV):
    """y = A @ x, streamed; MIMD row-striping or all-bank MAC chunks."""

    name = "GEMVS"
    default_n = 2_048  # rows

    def _run(self, system, n_threads, scale=1.0, seed=0, cache_mode=False):
        if backends.resolve_backend(system.cfg) in ("hbmpim", "hbmpim_cmd"):
            return self._run_allbank(system, scale, seed)
        return super()._run(system, n_threads, scale, seed, cache_mode)

    # ---- native all-bank path ----------------------------------------------
    def _run_allbank(self, system, scale: float, seed: int):
        from repro_torch.core import hbmpim

        cfg = system.cfg
        D, W, C = cfg.n_dpus, cfg.hbm_lanes, GEMV_C
        R = self.n_elems(scale)
        if R % W:
            raise ValueError(
                f"GEMVS all-bank needs rows % hbm_lanes == 0 "
                f"(R={R}, hbm_lanes={W})")
        G = R // W                      # output groups (one bank row each)
        acc_base = C * G                # accumulator rows follow the matrix
        if (acc_base + G) * W > cfg.mram_words:
            raise ValueError(
                f"GEMVS all-bank image needs {(acc_base + G) * W} words "
                f"(mram_words={cfg.mram_words}); lower --scale")
        rng = np.random.default_rng(seed)
        A = rng.integers(-64, 64, (D, R, C)).astype(np.int32)
        x = rng.integers(-64, 64, (D, C)).astype(np.int32)

        # bank row k*G+g holds column k of output group g: A[d, g*W+l, k]
        mram = np.zeros((D, cfg.mram_words), np.int32)
        mram[:, :C * G * W] = np.transpose(
            A.reshape(D, G, W, C), (0, 3, 1, 2)).reshape(D, -1)
        system.h2d(4.0 * R * C)

        # 8 SRF slots per chunk; split the group sweep to fit the CRF
        gpl = max(1, (cfg.hbm_crf_slots - 1) // 8)
        st, reps = None, []
        for c in range(C // 8):
            system.h2d(32.0, label="gemvs:x")
            for g0 in range(0, G, gpl):
                p = hbmpim.CrfProgram()
                for i in range(8):
                    for g in range(g0, min(g0 + gpl, G)):
                        p.mac(hbmpim.bank(acc_base + g),
                              hbmpim.bank((c * 8 + i) * G + g),
                              hbmpim.srf(i))
                p.exit_()
                st, rep = hbmpim.launch_commands(
                    system, f"GEMVS[x{c * 8}:{c * 8 + 8}]", p, mram,
                    x[:, c * 8:(c + 1) * 8])
                mram = st["mram"]       # thread accumulators forward
                reps.append(rep)

        y = np.asarray(mram[:, acc_base * W:(acc_base + G) * W]).reshape(D, R)
        want = np.einsum("drc,dc->dr", A, x).astype(np.int32)
        if not np.array_equal(y, want):
            raise AssertionError("GEMVS: all-bank output mismatch vs oracle")
        system.d2h(4.0 * R)
        return st, merge_reports(self.name, reps)
