"""Search workloads: BS (binary search) and TS (time-series motif search)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.asm import CACHE_DATA_BASE, N_TASKLETS, Program, Reg, TID, ZERO
from repro_torch.workloads.base import BLK, HostData, Workload
from repro_torch.workloads.streaming import _min_imm, _mk_mram

TS_M = 16  # time-series query length


class BS(Workload):
    """Binary search: lower_bound of each query in a sorted MRAM array.

    Pointer-chasing access pattern — one 8-byte DMA per probe — the
    memory-latency-bound outlier of the suite (paper Figs. 5/6)."""

    name = "BS"
    default_n = 8_192  # sorted elements; queries = n/16

    def build(self, nt, cache_mode=False):
        p = Program("BS", nt, cache_mode)
        n, src, qoff, dst, nq = p.regs("n", "src", "q", "dst", "nq")
        p.load_arg(n, 0)
        p.load_arg(src, 1)
        p.load_arg(qoff, 2)
        p.load_arg(dst, 3)
        p.load_arg(nq, 4)
        qbuf = p.walloc("qbuf", nt * 64)
        # my query range
        qpt, q0 = p.regs("qpt", "q0")
        p.div(qpt, nq, N_TASKLETS)
        p.mul(q0, TID, qpt)
        p.free(nq)
        wq = p.reg("wq")
        p.mul(wq, TID, 64)
        p.add(wq, wq, qbuf)
        qi, qend = p.regs("qi", "qend")
        p.mv(qi, q0)
        p.add(qend, q0, qpt)
        p.free(qpt, q0)
        key, lo, hi, mid, addr, v = p.regs("key", "lo", "hi", "mid", "addr", "v")
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(qi, qend, fin)
        # load the query
        p.sll(addr, qi, 2)
        p.add(addr, addr, qoff)
        if cache_mode:
            p.lw(key, addr)
        else:
            p.ldma(wq, addr, 4)
            p.lw(key, wq)
        p.li(lo, 0)
        p.mv(hi, n)
        lt, le = p.newlabel("bs"), p.newlabel("bsend")
        p.label(lt)
        p.bge(lo, hi, le)
        p.add(mid, lo, hi)
        p.srl(mid, mid, 1)
        p.sll(addr, mid, 2)
        p.add(addr, addr, src)
        if cache_mode:
            p.lw(v, addr)
        else:
            # scratchpad staging must guess a useful fetch size statically;
            # binary search touches one element -> overfetch (paper §V-D,
            # Fig. 16a: 5.1x extra read traffic vs on-demand caching)
            p.ldma(wq, addr, 64)
            p.lw(v, wq)
        nlt = p.newlabel("ge")
        p.bge(v, key, nlt)
        p.add(lo, mid, 1)
        p.jump(lt)
        p.label(nlt)
        p.mv(hi, mid)
        p.jump(lt)
        p.label(le)
        # store result index
        p.sll(addr, qi, 2)
        p.add(addr, addr, dst)
        if cache_mode:
            p.sw(addr, 0, lo)
        else:
            p.sw(wq, 0, lo)
            p.sdma(wq, addr, 4)
        p.add(qi, qi, 1)
        p.jump(top)
        p.label(fin)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        nq = max(n // 16 // 48, 1) * 48
        rng = np.random.default_rng(seed)
        A = np.sort(rng.integers(0, 1 << 20, (D, n)).astype(np.int32), axis=1)
        Q = rng.integers(0, 1 << 20, (D, nq)).astype(np.int32)
        img, (oa, oq, oo) = _mk_mram(cfg, [A, Q, np.zeros_like(Q)])
        base = CACHE_DATA_BASE if cache_mode else 0
        args = np.tile(np.array([n, base + oa, base + oq, base + oo, nq],
                                np.int32), (D, 1))
        want = np.stack([np.searchsorted(A[d], Q[d], "left")
                         for d in range(D)]).astype(np.int32)

        def check(mem):
            w = base // 4
            return np.array_equal(mem[:, w + oo // 4: w + oo // 4 + nq], want)

        return HostData(args, img, h2d_bytes=4 * (n + nq), d2h_bytes=4 * nq,
                        check=check)


class TS(Workload):
    """Time-series motif search: minimum squared distance of a length-16
    query against every subsequence — MUL-dense, compute-bound."""

    name = "TS"
    default_n = 4_096

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program("TS", nt)
        n, src, qoff, dst = p.regs("n", "src", "q", "dst")
        p.load_arg(n, 0)
        p.load_arg(src, 1)
        p.load_arg(qoff, 2)
        p.load_arg(dst, 3)
        # per-tasklet slice (cnt subsequences starting in my range)
        qbuf = p.walloc("query", TS_M * 4)
        sbuf = p.walloc("series", nt * 2048)
        cnt, s0 = p.regs("cnt", "s0")
        p.div(cnt, n, N_TASKLETS)
        p.mul(s0, TID, cnt)
        p.free(n)
        ws = p.reg("ws")
        p.mul(ws, TID, 2048)
        p.add(ws, ws, sbuf)
        # tasklet 0 loads the query; all wait
        sk = p.newlabel("q0")
        p.bne(TID, ZERO, sk)
        qa = p.reg("qa")
        p.li(qa, qbuf)
        p.ldma(qa, qoff, TS_M * 4)
        p.free(qa)
        p.label(sk)
        p.free(qoff)
        p.barrier()
        # process my slice in chunks that fit the 2 KB staging buffer
        CHUNK = 448  # subsequences per chunk; (CHUNK + M) * 4 <= 2048
        best, besti = p.regs("best", "besti")
        p.li(best, 0x7FFFFFFF)
        p.li(besti, -1)
        c0, nsub, ma, nb = p.regs("c0", "nsub", "ma", "nb")
        p.li(c0, 0)
        ctop, cend = p.newlabel("chunk"), p.newlabel("chunkend")
        p.label(ctop)
        p.bge(c0, cnt, cend)
        p.sub(nsub, cnt, c0)
        _min_imm(p, nsub, CHUNK)
        p.add(ma, s0, c0)
        p.sll(ma, ma, 2)
        p.add(ma, ma, src)
        p.add(nb, nsub, TS_M)
        p.sll(nb, nb, 2)
        p.ldma(ws, ma, nb)
        i, j, pa, pq, acc, va, vq = p.regs("i", "j", "pa", "pq",
                                           "acc", "va", "vq")
        with p.for_range(i, 0, nsub):
            p.li(acc, 0)
            p.sll(pa, i, 2)
            p.add(pa, pa, ws)
            p.li(pq, qbuf)
            with p.for_range(j, 0, TS_M):
                p.lw(va, pa)
                p.lw(vq, pq)
                p.sub(va, va, vq)
                p.mul(va, va, va)
                p.add(acc, acc, va)
                p.add(pa, pa, 4)
                p.add(pq, pq, 4)
            ge = p.newlabel("ge")
            p.bge(acc, best, ge)
            p.mv(best, acc)
            p.add(besti, s0, c0)
            p.add(besti, besti, i)
            p.label(ge)
        p.free(i, j, pa, pq, acc, va, vq)
        p.add(c0, c0, CHUNK)
        p.jump(ctop)
        p.label(cend)
        # write (best, besti) for this tasklet
        out = p.reg("out")
        p.sll(out, TID, 3)
        p.add(out, out, dst)
        p.sw(ws, 0, best)
        p.sw(ws, 4, besti)
        p.sdma(ws, out, 8)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        A = rng.integers(-64, 64, (D, n + TS_M)).astype(np.int32)
        Q = rng.integers(-64, 64, (D, TS_M)).astype(np.int32)
        out = np.zeros((D, 2 * 24), np.int32)
        img, (oa, oq, oo) = _mk_mram(cfg, [A, Q, out])
        args = np.tile(np.array([n, oa, oq, oo], np.int32), (D, 1))
        holder = {}

        def check(mem):
            nt = holder.get("nt", 16)
            cnt = n // nt
            for d in range(D):
                # global best from per-tasklet results must match oracle
                dists = np.array([
                    ((A[d, i:i + TS_M].astype(np.int64)
                      - Q[d].astype(np.int64)) ** 2).sum()
                    for i in range(n)])
                per = mem[d, oo // 4: oo // 4 + 2 * nt].reshape(nt, 2)
                got = per[:, 0].min()
                if got != dists.min():
                    return False
                # the winning tasklet's index must be a true argmin position
                w = per[per[:, 0].argmin(), 1]
                if dists[w] != dists.min():
                    return False
            return True

        hd = HostData(args, img, h2d_bytes=4 * (n + TS_M), d2h_bytes=8 * 24,
                      check=check)
        hd.extra = holder
        return hd

    def _run(self, system, n_threads, scale=1.0, seed=0, cache_mode=False):
        hd = self.host_data(system.cfg, scale, seed)
        hd.extra["nt"] = n_threads
        prog = self.build(n_threads, cache_mode=cache_mode)
        binary = prog.binary(system.cfg.iram_instrs)
        system.h2d(hd.h2d_bytes)
        st, rep = system.launch(self.name, binary, hd.args, hd.mram,
                                n_threads=n_threads)
        system.d2h(hd.d2h_bytes)
        if not hd.check(np.asarray(st["mram"])):
            raise AssertionError(f"{self.name}: output mismatch vs oracle")
        return st, rep
