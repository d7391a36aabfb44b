"""Histogram workloads: HST-S (private per-tasklet) and HST-L (shared, mutex).

After the kernel, the per-DPU histograms are merged into one global
histogram on DPU 0 through a ``repro_torch.comm`` sum-reduce — the inter-DPU
exchange that real PrIM histograms do on the host (paper §II-B)."""
from __future__ import annotations

import numpy as np

from repro_torch.comm import collectives
from repro_torch.core.asm import N_TASKLETS, Program, Reg, TID, ZERO
from repro_torch.workloads.base import BLK, HostData, Workload
from repro_torch.workloads.streaming import _min_imm, _mk_mram, _slice_regs

N_BINS = 256
SHIFT = 12  # values in [0, 2^20) -> bin = v >> 12


class _HistBase(Workload):
    default_n = 16_384
    large = False
    sync_heavy = True

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program(self.name, nt)
        n, src, dst = p.regs("n", "src", "dst")
        p.load_arg(n, 0)
        p.load_arg(src, 1)
        p.load_arg(dst, 2)
        if self.large:
            hist = p.walloc("hist", N_BINS * 4)  # shared, mutex-protected
        else:
            hist = p.walloc("hist", nt * N_BINS * 4)  # private per tasklet
        res = p.walloc("res", N_BINS * 4)
        bufs = p.walloc("bufs", nt * BLK)
        npt, off = _slice_regs(p, n)
        p.add(src, src, off)
        total = p.reg("total")
        p.sll(total, npt, 2)
        p.free(n, npt, off)

        hbase = p.reg("hbase")
        if self.large:
            p.li(hbase, hist)
        else:
            p.mul(hbase, TID, N_BINS * 4)
            p.add(hbase, hbase, hist)
            # zero my private bins
            i, pt = p.regs("i", "pt")
            with p.for_range(i, 0, N_BINS):
                p.sll(pt, i, 2)
                p.add(pt, pt, hbase)
                p.sw(pt, 0, ZERO)
            p.free(i, pt)
        wa = p.reg("wa")
        p.mul(wa, TID, BLK)
        p.add(wa, wa, bufs)
        if self.large:
            p.barrier()  # hist zeroed by initial WRAM state; rendezvous anyway

        done_b, nb = p.regs("done", "nb")
        p.li(done_b, 0)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(done_b, total, fin)
        p.sub(nb, total, done_b)
        _min_imm(p, nb, BLK)
        p.ldma(wa, src, nb)
        pa, end, v, binr = p.regs("pa", "end", "v", "bin")
        p.mv(pa, wa)
        p.add(end, pa, nb)
        itop, idone = p.newlabel(), p.newlabel()
        p.label(itop)
        p.bge(pa, end, idone)
        p.lw(v, pa)
        p.srl(binr, v, SHIFT)
        p.and_(binr, binr, N_BINS - 1)
        p.sll(binr, binr, 2)
        p.add(binr, binr, hbase)
        if self.large:
            mx = p.reg("mx")
            p.srl(mx, binr, 2)
            p.and_(mx, mx, 31)  # 32 mutexes across the bin space
            # acquire uses an immediate id; emulate variable id via 32-way
            # dispatch would bloat IRAM — use a single-region lock group of 8
            p.and_(mx, mx, 7)
            tab = p.newlabel("acq_done")
            for m in range(8):
                nxt = p.newlabel(f"m{m}")
                p.bne(mx, m, nxt)
                p.acquire(m)
                p.lw(v, binr)
                p.add(v, v, 1)
                p.sw(binr, 0, v)
                p.release(m)
                p.jump(tab)
                p.label(nxt)
            p.label(tab)
            p.free(mx)
        else:
            p.lw(v, binr)
            p.add(v, v, 1)
            p.sw(binr, 0, v)
        p.add(pa, pa, 4)
        p.jump(itop)
        p.label(idone)
        p.free(pa, end, v, binr)
        p.add(src, src, nb)
        p.add(done_b, done_b, nb)
        p.jump(top)
        p.label(fin)
        p.free(done_b, nb, wa)
        p.barrier()

        # merge + writeback
        if self.large:
            sk = p.newlabel("only0")
            p.bne(TID, ZERO, sk)
            pt = p.reg("pt")
            p.li(pt, hist)
            for blk in range(0, N_BINS * 4, BLK):
                sz = min(BLK, N_BINS * 4 - blk)
                p.sdma(pt, dst, sz)
                p.add(pt, pt, sz)
                p.add(dst, dst, sz)
            p.free(pt)
            p.label(sk)
        else:
            # each tasklet merges a bin range across private histograms
            bpt = N_BINS // nt if nt <= N_BINS else 1
            b0, b1, b, acc, t, pt = p.regs("b0", "b1", "b", "acc", "t", "pt")
            p.li(b1, bpt)
            p.mul(b0, TID, b1)
            p.add(b1, b0, b1)
            last = p.newlabel("notlast")
            p.bne(TID, nt - 1, last)
            p.li(b1, N_BINS)
            p.label(last)
            with p.for_range(b, b0, b1):
                p.li(acc, 0)
                with p.for_range(t, 0, nt):
                    p.mul(pt, t, N_BINS * 4)
                    p.add(pt, pt, hist)
                    tmp = p.reg("tmp")
                    p.sll(tmp, b, 2)
                    p.add(pt, pt, tmp)
                    v2 = p.reg("v2")
                    p.lw(v2, pt)
                    p.add(acc, acc, v2)
                    p.free(tmp, v2)
                p.sll(pt, b, 2)
                p.add(pt, pt, res)
                p.sw(pt, 0, acc)
            p.free(b0, b1, b, acc, t, pt)
            p.barrier()
            sk = p.newlabel("only0")
            p.bne(TID, ZERO, sk)
            pt = p.reg("pt")
            p.li(pt, res)
            for blk in range(0, N_BINS * 4, BLK):
                sz = min(BLK, N_BINS * 4 - blk)
                p.sdma(pt, dst, sz)
                p.add(pt, pt, sz)
                p.add(dst, dst, sz)
            p.free(pt)
            p.label(sk)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        A = rng.integers(0, 1 << 20, (D, n)).astype(np.int32)
        img, (oa, oo) = _mk_mram(cfg, [A, np.zeros((D, N_BINS), np.int32)])
        args = np.tile(np.array([n, oa, oo], np.int32), (D, 1))
        want = np.stack([np.bincount((A[d] >> SHIFT) & (N_BINS - 1),
                                     minlength=N_BINS) for d in range(D)])

        def check(mem):
            return np.array_equal(mem[:, oo // 4: oo // 4 + N_BINS],
                                  want.astype(np.int32))

        return HostData(args, img, h2d_bytes=4 * n, d2h_bytes=4 * N_BINS,
                        check=check,
                        extra={"hist_off": oo // 4,
                               "want_merged": want.sum(0).astype(np.int32)})

    def readback(self, system, hd, mem):
        # Merge the per-DPU histograms onto DPU 0 through the comm fabric,
        # modeled on a host-side shadow of the banks (engine state is
        # read-only once returned). The charged time is the full collective
        # — including the write-back leg that lands the merged result in
        # DPU 0's MRAM — so host-bounce and direct fabrics satisfy the
        # same contract; a host that only wanted the histogram on the CPU
        # could skip that leg, but then the comparison would be unfair to
        # the direct fabric.
        off = hd.extra["hist_off"]
        hist = np.array(mem[:, off:off + N_BINS])  # writable shadow
        # under faults, root the merge at the first surviving DPU (DPU 0
        # may be dead; a dead root would raise a typed DpuFaultError)
        root = 0
        if (getattr(system, "faults", None) is not None
                and not system.active_mask[0]):
            alive = system.active_dpus
            if not alive:
                raise AssertionError(f"{self.name}: no surviving DPU "
                                     "to merge the histogram on")
            root = alive[0]
        collectives.reduce(system, hist, 0, N_BINS, op="sum", root=root)
        if not np.array_equal(hist[root], hd.extra["want_merged"]):
            raise AssertionError(f"{self.name}: merged histogram mismatch")
        # the host reads back only the merged histogram, from the root
        final = np.zeros(system.cfg.n_dpus)
        final[root] = 4.0 * N_BINS
        system.d2h(final)


class HST_S(_HistBase):
    name = "HST-S"
    large = False


class HST_L(_HistBase):
    name = "HST-L"
    large = True
