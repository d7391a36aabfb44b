"""Streaming PrIM workloads: VA, RED, SCAN-SSA, SCAN-RSS, SEL, UNI."""
from __future__ import annotations

import numpy as np

from repro_torch.core.asm import CACHE_DATA_BASE, N_TASKLETS, Program, Reg, TID, ZERO
from repro_torch.workloads.base import BLK, HostData, Workload


def _min_imm(p: Program, rd: Reg, imm: int):
    """rd = min(rd, imm)."""
    skip = p.newlabel("min")
    at = p.reg("mintmp")
    p.li(at, imm)
    p.blt(rd, at, skip)
    p.mv(rd, at)
    p.label(skip)
    p.free(at)


def _slice_regs(p: Program, n: Reg):
    """-> (npt, byte_off) for this tasklet (n divisible by NT)."""
    npt, off = p.regs("npt", "off")
    p.div(npt, n, N_TASKLETS)
    p.mul(off, TID, npt)
    p.sll(off, off, 2)
    return npt, off


def _mk_mram(cfg, arrays):
    """Pack arrays (list of (D, n) int32) back-to-back; return image+offsets."""
    D = arrays[0].shape[0]
    img = np.zeros((D, cfg.mram_words), np.int32)
    offs = []
    cur = 0
    for a in arrays:
        offs.append(cur * 4)
        img[:, cur:cur + a.shape[1]] = a
        cur += (a.shape[1] + 1) // 2 * 2
    assert cur <= cfg.mram_words, "mram too small for workload"
    return img, offs


class VA(Workload):
    """Element-wise vector addition (the paper's Fig. 2 running example)."""

    name = "VA"
    default_n = 16_384

    def build(self, nt, cache_mode=False):
        p = Program("VA", nt, cache_mode)
        n, a, b, c = p.regs("n", "a", "b", "c")
        p.load_arg(n, 0)
        p.load_arg(a, 1)
        p.load_arg(b, 2)
        p.load_arg(c, 3)
        npt, off = _slice_regs(p, n)
        p.add(a, a, off)
        p.add(b, b, off)
        p.add(c, c, off)
        total = p.reg("total")
        p.sll(total, npt, 2)
        p.free(n, npt, off)
        if cache_mode:
            # direct addressing: C[i] = A[i] + B[i] over the cached space
            end, va, vb = p.regs("end", "va", "vb")
            p.add(end, a, total)
            top, done = p.newlabel(), p.newlabel()
            p.label(top)
            p.bge(a, end, done)
            p.lw(va, a)
            p.lw(vb, b)
            p.add(va, va, vb)
            p.sw(c, 0, va)
            p.add(a, a, 4)
            p.add(b, b, 4)
            p.add(c, c, 4)
            p.jump(top)
            p.label(done)
            p.stop()
            return p
        bufs = p.walloc("bufs", nt * 3 * BLK)
        wa = p.reg("wa")
        p.mul(wa, TID, 3 * BLK)
        p.add(wa, wa, bufs)
        wb, wc = p.regs("wb", "wc")
        p.add(wb, wa, BLK)
        p.add(wc, wa, 2 * BLK)
        done_b, nb = p.regs("done", "nb")
        p.li(done_b, 0)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(done_b, total, fin)
        p.sub(nb, total, done_b)
        _min_imm(p, nb, BLK)
        p.ldma(wa, a, nb)
        p.ldma(wb, b, nb)
        pa, pb, pc, end, va, vb = p.regs("pa", "pb", "pc", "end", "va", "vb")
        p.mv(pa, wa)
        p.mv(pb, wb)
        p.mv(pc, wc)
        p.add(end, pa, nb)
        itop, idone = p.newlabel(), p.newlabel()
        p.label(itop)
        p.bge(pa, end, idone)
        p.lw(va, pa)
        p.lw(vb, pb)
        p.add(va, va, vb)
        p.sw(pc, 0, va)
        p.add(pa, pa, 4)
        p.add(pb, pb, 4)
        p.add(pc, pc, 4)
        p.jump(itop)
        p.label(idone)
        p.free(pa, pb, pc, end, va, vb)
        p.sdma(wc, c, nb)
        p.add(a, a, nb)
        p.add(b, b, nb)
        p.add(c, c, nb)
        p.add(done_b, done_b, nb)
        p.jump(top)
        p.label(fin)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        A = rng.integers(-1000, 1000, (D, n)).astype(np.int32)
        B = rng.integers(-1000, 1000, (D, n)).astype(np.int32)
        img, (oa, ob, oc) = _mk_mram(cfg, [A, B, np.zeros_like(A)])
        base = CACHE_DATA_BASE if cache_mode else 0
        args = np.tile(np.array([n, base + oa, base + ob, base + oc],
                                np.int32), (D, 1))

        def check(mem):
            w = base // 4
            return np.array_equal(mem[:, w + oc // 4: w + oc // 4 + n], A + B)

        return HostData(args, img, h2d_bytes=8 * n, d2h_bytes=4 * n,
                        check=check)


class RED(Workload):
    """Parallel reduction (sum)."""

    name = "RED"
    default_n = 16_384

    def build(self, nt, cache_mode=False):
        p = Program("RED", nt, cache_mode)
        n, a, out = p.regs("n", "a", "out")
        p.load_arg(n, 0)
        p.load_arg(a, 1)
        p.load_arg(out, 2)
        partials = p.walloc("partials", nt * 4)
        npt, off = _slice_regs(p, n)
        p.add(a, a, off)
        total, acc = p.regs("total", "acc")
        p.sll(total, npt, 2)
        p.li(acc, 0)
        p.free(n, npt, off)
        if cache_mode:
            end, v = p.regs("end", "v")
            p.add(end, a, total)
            top, done = p.newlabel(), p.newlabel()
            p.label(top)
            p.bge(a, end, done)
            p.lw(v, a)
            p.add(acc, acc, v)
            p.add(a, a, 4)
            p.jump(top)
            p.label(done)
            p.free(end, v)
        else:
            bufs = p.walloc("bufs", nt * BLK)
            wa = p.reg("wa")
            p.mul(wa, TID, BLK)
            p.add(wa, wa, bufs)
            done_b, nb = p.regs("done", "nb")
            p.li(done_b, 0)
            top, fin = p.newlabel(), p.newlabel()
            p.label(top)
            p.bge(done_b, total, fin)
            p.sub(nb, total, done_b)
            _min_imm(p, nb, BLK)
            p.ldma(wa, a, nb)
            pa, end, v = p.regs("pa", "end", "v")
            p.mv(pa, wa)
            p.add(end, pa, nb)
            itop, idone = p.newlabel(), p.newlabel()
            p.label(itop)
            p.bge(pa, end, idone)
            p.lw(v, pa)
            p.add(acc, acc, v)
            p.add(pa, pa, 4)
            p.jump(itop)
            p.label(idone)
            p.free(pa, end, v)
            p.add(a, a, nb)
            p.add(done_b, done_b, nb)
            p.jump(top)
            p.label(fin)
            p.free(done_b, nb, wa)
        # partials[tid] = acc
        pt = p.reg("pt")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.sw(pt, 0, acc)
        p.barrier()
        # tasklet 0 reduces
        fin2 = p.newlabel("skip0")
        p.bne(TID, ZERO, fin2)
        i, v = p.regs("i", "v")
        p.li(acc, 0)
        with p.for_range(i, 0, N_TASKLETS):
            p.sll(pt, i, 2)
            p.add(pt, pt, partials)
            p.lw(v, pt)
            p.add(acc, acc, v)
        res = p.walloc("res", 8)
        p.li(pt, res)
        p.sw(pt, 0, acc)
        if cache_mode:
            p.sw(out, 0, acc)
        else:
            p.sdma(pt, out, 4)
        p.label(fin2)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        A = rng.integers(-1000, 1000, (D, n)).astype(np.int32)
        img, (oa, oo) = _mk_mram(cfg, [A, np.zeros((D, 2), np.int32)])
        base = CACHE_DATA_BASE if cache_mode else 0
        args = np.tile(np.array([n, base + oa, base + oo], np.int32), (D, 1))
        want = A.sum(1, dtype=np.int32)

        def check(mem):
            return np.array_equal(mem[:, base // 4 + oo // 4], want)

        return HostData(args, img, h2d_bytes=4 * n, d2h_bytes=4, check=check)


class _ScanBase(Workload):
    """Shared machinery for SCAN-SSA / SCAN-RSS (phase-structured)."""

    default_n = 16_384
    rss = False

    def build(self, nt, cache_mode=False):
        assert not cache_mode, "scan runs in scratchpad mode only"
        p = Program(self.name, nt)
        n, src, dst, gbase = p.regs("n", "src", "dst", "gbase")
        p.load_arg(n, 0)
        p.load_arg(src, 1)
        p.load_arg(dst, 2)
        p.load_arg(gbase, 3)
        partials = p.walloc("partials", nt * 4)
        bufs = p.walloc("bufs", nt * 2 * BLK)
        npt, off = _slice_regs(p, n)
        p.add(src, src, off)
        p.add(dst, dst, off)
        total = p.reg("total")
        p.sll(total, npt, 2)
        p.free(n, npt, off)
        wa = p.reg("wa")
        p.mul(wa, TID, 2 * BLK)
        p.add(wa, wa, bufs)
        wo = p.reg("wo")
        p.add(wo, wa, BLK)

        # ---- pass 1: local scan (SSA writes scanned slice; RSS reduces) ----
        acc, done_b, nb = p.regs("acc", "done", "nb")
        p.li(acc, 0)
        p.li(done_b, 0)
        msrc, mdst = p.regs("msrc", "mdst")
        p.mv(msrc, src)
        p.mv(mdst, dst)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(done_b, total, fin)
        p.sub(nb, total, done_b)
        _min_imm(p, nb, BLK)
        p.ldma(wa, msrc, nb)
        pa, po, end, v = p.regs("pa", "po", "end", "v")
        p.mv(pa, wa)
        p.mv(po, wo)
        p.add(end, pa, nb)
        itop, idone = p.newlabel(), p.newlabel()
        p.label(itop)
        p.bge(pa, end, idone)
        p.lw(v, pa)
        p.add(acc, acc, v)
        if not self.rss:
            p.sw(po, 0, acc)
        p.add(pa, pa, 4)
        p.add(po, po, 4)
        p.jump(itop)
        p.label(idone)
        p.free(pa, po, end, v)
        if not self.rss:
            p.sdma(wo, mdst, nb)
        p.add(msrc, msrc, nb)
        p.add(mdst, mdst, nb)
        p.add(done_b, done_b, nb)
        p.jump(top)
        p.label(fin)
        pt = p.reg("pt")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.sw(pt, 0, acc)
        p.barrier()

        # ---- tasklet 0: exclusive scan of partials ----
        sk = p.newlabel("skip0")
        p.bne(TID, ZERO, sk)
        i, v, run = p.regs("i", "v", "run")
        p.li(run, 0)
        with p.for_range(i, 0, nt):
            p.sll(pt, i, 2)
            p.add(pt, pt, partials)
            p.lw(v, pt)
            p.sw(pt, 0, run)
            p.add(run, run, v)
        p.free(i, v, run)
        p.label(sk)
        p.barrier()

        # ---- pass 2: add base (+ global base); RSS rescans from source ----
        base = p.reg("base")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.lw(base, pt)
        p.add(base, base, gbase)
        p.li(done_b, 0)
        p.mv(msrc, src)
        p.mv(mdst, dst)
        if self.rss:
            p.mv(acc, base)
        top2, fin2 = p.newlabel(), p.newlabel()
        p.label(top2)
        p.bge(done_b, total, fin2)
        p.sub(nb, total, done_b)
        _min_imm(p, nb, BLK)
        rdsrc = msrc if self.rss else mdst
        p.ldma(wa, rdsrc, nb)
        pa, po, end, v = p.regs("pa", "po", "end", "v")
        p.mv(pa, wa)
        p.mv(po, wo)
        p.add(end, pa, nb)
        itop2, idone2 = p.newlabel(), p.newlabel()
        p.label(itop2)
        p.bge(pa, end, idone2)
        p.lw(v, pa)
        if self.rss:
            p.add(acc, acc, v)
            p.sw(po, 0, acc)
        else:
            p.add(v, v, base)
            p.sw(po, 0, v)
        p.add(pa, pa, 4)
        p.add(po, po, 4)
        p.jump(itop2)
        p.label(idone2)
        p.free(pa, po, end, v)
        p.sdma(wo, mdst, nb)
        p.add(msrc, msrc, nb)
        p.add(mdst, mdst, nb)
        p.add(done_b, done_b, nb)
        p.jump(top2)
        p.label(fin2)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        A = rng.integers(-100, 100, (D, n)).astype(np.int32)
        img, (oa, oo) = _mk_mram(cfg, [A, np.zeros_like(A)])
        args = np.tile(np.array([n, oa, oo, 0], np.int32), (D, 1))
        # global (cross-DPU) scan: DPU d's base = sum of previous DPUs
        bases = np.concatenate([[0], A.sum(1).cumsum()[:-1]]).astype(np.int32)
        args[:, 3] = bases
        want = A.reshape(-1).cumsum().astype(np.int32).reshape(D, n)

        def check(mem):
            return np.array_equal(mem[:, oo // 4: oo // 4 + n], want)

        return HostData(args, img, h2d_bytes=4 * n, d2h_bytes=4 * n,
                        check=check)

    def _run(self, system, n_threads, scale=1.0, seed=0, cache_mode=False):
        # inter-DPU bases bounce through the host (counted as inter-DPU traffic)
        if system.cfg.n_dpus > 1:
            system.inter_dpu(8.0)
        return super()._run(system, n_threads, scale, seed, cache_mode)


class SCAN_SSA(_ScanBase):
    name = "SCAN-SSA"
    rss = False


class SCAN_RSS(_ScanBase):
    name = "SCAN-RSS"
    rss = True


class _CompactBase(Workload):
    """Shared machinery for SEL / UNI (two-pass stream compaction)."""

    default_n = 16_384
    unique = False

    def _emit_keep(self, p, v, prev, keep):
        """keep = predicate(v, prev)."""
        if self.unique:
            t = p.reg("t")
            p.xor(t, v, prev)
            p.sltu(keep, ZERO, t)  # keep = (v != prev)
            p.free(t)
        else:
            p.and_(keep, v, 1)
            p.xor(keep, keep, 1)  # keep = (v & 1) == 0

    def _build_cache(self, nt):
        """Direct-addressing variant (case #4): two passes of sequential
        loads with per-element compacted stores — no staging orchestration,
        locality is left to the on-demand D$."""
        p = Program(self.name, nt, cache_mode=True)
        n, src, dst, cnt_off = p.regs("n", "src", "dst", "cnt")
        p.load_arg(n, 0)
        p.load_arg(src, 1)
        p.load_arg(dst, 2)
        p.load_arg(cnt_off, 3)
        partials = p.walloc("partials", nt * 4)
        npt, off = _slice_regs(p, n)
        msrc = p.reg("msrc")
        p.add(msrc, src, off)
        total = p.reg("total")
        p.sll(total, npt, 2)
        p.free(n, npt)
        prev = p.reg("prev")
        if self.unique:
            hp = p.newlabel("hp")
            nz = p.newlabel("tid0")
            p.beq(off, ZERO, nz)
            p.lw(prev, msrc, -4)
            p.jump(hp)
            p.label(nz)
            p.lw(prev, msrc)
            p.xor(prev, prev, -1)
            p.label(hp)
        p.free(off)
        cnt, cur, end, v, keep = p.regs("cnt", "cur", "end", "v", "keep")
        p.li(cnt, 0)
        p.mv(cur, msrc)
        p.add(end, cur, total)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(cur, end, fin)
        p.lw(v, cur)
        self._emit_keep(p, v, prev, keep)
        p.add(cnt, cnt, keep)
        if self.unique:
            p.mv(prev, v)
        p.add(cur, cur, 4)
        p.jump(top)
        p.label(fin)
        pt = p.reg("pt")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.sw(pt, 0, cnt)
        p.barrier()
        sk = p.newlabel("skip0")
        p.bne(TID, ZERO, sk)
        i, run = p.regs("i", "run")
        p.li(run, 0)
        with p.for_range(i, 0, nt):
            p.sll(pt, i, 2)
            p.add(pt, pt, partials)
            p.lw(v, pt)
            p.sw(pt, 0, run)
            p.add(run, run, v)
        p.sw(cnt_off, 0, run)
        p.free(i, run)
        p.label(sk)
        p.barrier()
        mdst = p.reg("mdst")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.lw(mdst, pt)
        p.sll(mdst, mdst, 2)
        p.add(mdst, mdst, dst)
        if self.unique:
            t0 = p.newlabel("t0b")
            donep = p.newlabel("donep")
            p.beq(msrc, src, t0)
            p.lw(prev, msrc, -4)
            p.jump(donep)
            p.label(t0)
            p.lw(prev, msrc)
            p.xor(prev, prev, -1)
            p.label(donep)
        p.mv(cur, msrc)
        top2, fin2 = p.newlabel(), p.newlabel()
        p.label(top2)
        p.bge(cur, end, fin2)
        p.lw(v, cur)
        self._emit_keep(p, v, prev, keep)
        nk = p.newlabel("nk")
        p.beq(keep, ZERO, nk)
        p.sw(mdst, 0, v)
        p.add(mdst, mdst, 4)
        p.label(nk)
        if self.unique:
            p.mv(prev, v)
        p.add(cur, cur, 4)
        p.jump(top2)
        p.label(fin2)
        p.stop()
        return p

    def build(self, nt, cache_mode=False):
        if cache_mode:
            return self._build_cache(nt)
        p = Program(self.name, nt)
        n, src, dst, cnt_off = p.regs("n", "src", "dst", "cnt")
        p.load_arg(n, 0)
        p.load_arg(src, 1)
        p.load_arg(dst, 2)
        p.load_arg(cnt_off, 3)
        partials = p.walloc("partials", nt * 4)
        bufs = p.walloc("bufs", nt * 2 * BLK)
        npt, off = _slice_regs(p, n)
        msrc = p.reg("msrc")
        p.add(msrc, src, off)
        total = p.reg("total")
        p.sll(total, npt, 2)
        p.free(n, npt)
        wa = p.reg("wa")
        p.mul(wa, TID, 2 * BLK)
        p.add(wa, wa, bufs)
        wo = p.reg("wo")
        p.add(wo, wa, BLK)

        # previous element (for UNI): A[start-1], sentinel for tid 0
        prev = p.reg("prev")
        if self.unique:
            nz = p.newlabel("tid0")
            haveprev = p.newlabel("hp")
            p.beq(off, ZERO, nz)
            pm = p.reg("pm")
            p.sub(pm, msrc, 4)
            p.ldma(wo, pm, 4)  # borrow wo as scratch
            p.lw(prev, wo)
            p.free(pm)
            p.jump(haveprev)
            p.label(nz)
            p.ldma(wo, msrc, 4)
            p.lw(prev, wo)
            p.xor(prev, prev, -1)  # != first element => first is kept
            p.label(haveprev)
        p.free(off)

        # ---- pass 1: count keepers ----
        cnt, done_b, nb = p.regs("acc", "done", "nb")
        p.li(cnt, 0)
        p.li(done_b, 0)
        cur = p.reg("cur")
        p.mv(cur, msrc)
        pv1 = p.reg("pv1")
        p.mv(pv1, prev) if self.unique else p.li(pv1, 0)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(done_b, total, fin)
        p.sub(nb, total, done_b)
        _min_imm(p, nb, BLK)
        p.ldma(wa, cur, nb)
        pa, end, v, keep = p.regs("pa", "end", "v", "keep")
        p.mv(pa, wa)
        p.add(end, pa, nb)
        itop, idone = p.newlabel(), p.newlabel()
        p.label(itop)
        p.bge(pa, end, idone)
        p.lw(v, pa)
        self._emit_keep(p, v, pv1, keep)
        p.add(cnt, cnt, keep)
        if self.unique:
            p.mv(pv1, v)
        p.add(pa, pa, 4)
        p.jump(itop)
        p.label(idone)
        p.free(pa, end, v, keep)
        p.add(cur, cur, nb)
        p.add(done_b, done_b, nb)
        p.jump(top)
        p.label(fin)
        pt = p.reg("pt")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.sw(pt, 0, cnt)
        p.barrier()

        # ---- tasklet 0: exclusive scan of counts; store total ----
        sk = p.newlabel("skip0")
        p.bne(TID, ZERO, sk)
        i, v, run = p.regs("i", "v", "run")
        p.li(run, 0)
        with p.for_range(i, 0, nt):
            p.sll(pt, i, 2)
            p.add(pt, pt, partials)
            p.lw(v, pt)
            p.sw(pt, 0, run)
            p.add(run, run, v)
        cw = p.walloc("cntw", 8)
        p.li(v, cw)
        p.sw(v, 0, run)
        p.sdma(v, cnt_off, 4)
        p.free(i, v, run)
        p.label(sk)
        p.barrier()
        p.free(cnt, cnt_off)

        # ---- pass 2: compact into dst + offset ----
        mdst = p.reg("mdst")
        p.sll(pt, TID, 2)
        p.add(pt, pt, partials)
        p.lw(mdst, pt)
        p.sll(mdst, mdst, 2)
        p.add(mdst, mdst, dst)
        p.free(dst, pt)
        filled = p.reg("filled")
        p.li(filled, 0)
        p.li(done_b, 0)
        p.mv(cur, msrc)
        p.mv(pv1, prev) if self.unique else p.li(pv1, 0)
        p.free(prev)
        top2, fin2 = p.newlabel(), p.newlabel()
        p.label(top2)
        p.bge(done_b, total, fin2)
        p.sub(nb, total, done_b)
        _min_imm(p, nb, BLK)
        p.ldma(wa, cur, nb)
        pa, end, v, keep, po = p.regs("pa", "end", "v", "keep", "po")
        p.mv(pa, wa)
        p.add(end, pa, nb)
        itop2, idone2 = p.newlabel(), p.newlabel()
        p.label(itop2)
        p.bge(pa, end, idone2)
        p.lw(v, pa)
        self._emit_keep(p, v, pv1, keep)
        nk = p.newlabel("nk")
        p.beq(keep, ZERO, nk)
        p.add(po, wo, filled)
        p.sw(po, 0, v)
        p.add(filled, filled, 4)
        p.label(nk)
        if self.unique:
            p.mv(pv1, v)
        p.add(pa, pa, 4)
        # flush staging buffer when full
        nfl = p.newlabel("nfl")
        p.blt(filled, BLK, nfl)
        p.sdma(wo, mdst, BLK)
        p.add(mdst, mdst, BLK)
        p.li(filled, 0)
        p.label(nfl)
        p.jump(itop2)
        p.label(idone2)
        p.free(pa, end, v, keep, po)
        p.add(cur, cur, nb)
        p.add(done_b, done_b, nb)
        p.jump(top2)
        p.label(fin2)
        fl = p.newlabel("lastflush")
        p.beq(filled, ZERO, fl)
        p.sdma(wo, mdst, filled)
        p.label(fl)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        if self.unique:
            # runs of duplicates
            A = np.repeat(rng.integers(0, 1 << 20, (D, n // 4)), 4, axis=1)
            A = A[:, :n].astype(np.int32)
        else:
            A = rng.integers(0, 1 << 20, (D, n)).astype(np.int32)
        img, (oa, oo, oc) = _mk_mram(
            cfg, [A, np.zeros_like(A), np.zeros((D, 2), np.int32)])
        base = CACHE_DATA_BASE if cache_mode else 0
        args = np.tile(np.array([n, base + oa, base + oo, base + oc],
                                np.int32), (D, 1))
        nt_holder = {}

        def oracle_row(row, nt):
            outs = []
            npt = n // nt
            for t in range(nt):
                s = row[t * npt:(t + 1) * npt]
                if self.unique:
                    prev = row[t * npt - 1] if t else None
                    keep = np.ones(npt, bool)
                    keep[1:] = s[1:] != s[:-1]
                    keep[0] = (s[0] != prev) if prev is not None else True
                    outs.append(s[keep])
                else:
                    outs.append(s[s % 2 == 0])
            return np.concatenate(outs)

        def check(mem):
            nt = nt_holder.get("nt", 16)
            w = base // 4
            for d in range(D):
                want = oracle_row(np.asarray(A[d]), nt)
                got = mem[d, w + oo // 4: w + oo // 4 + len(want)]
                if not np.array_equal(got, want):
                    return False
                if mem[d, w + oc // 4] != len(want):
                    return False
            return True

        hd = HostData(args, img, h2d_bytes=4 * n, d2h_bytes=2 * n, check=check)
        hd.extra = nt_holder
        return hd

    def _run(self, system, n_threads, scale=1.0, seed=0, cache_mode=False):
        hd = self.host_data(system.cfg, scale, seed, cache_mode=cache_mode)
        hd.extra["nt"] = n_threads
        prog = self.build(n_threads, cache_mode=cache_mode)
        binary = prog.binary(system.cfg.iram_instrs)
        system.h2d(hd.h2d_bytes)
        if cache_mode:
            mram = np.zeros((system.cfg.n_dpus, 2), np.int32)
            st, rep = system.launch(self.name, binary, hd.args, mram,
                                    n_threads=n_threads, wram_extra=hd.mram)
            mem = np.asarray(st["wram"])
        else:
            st, rep = system.launch(self.name, binary, hd.args, hd.mram,
                                    n_threads=n_threads)
            mem = np.asarray(st["mram"])
        system.d2h(hd.d2h_bytes)
        if not hd.check(mem):
            raise AssertionError(f"{self.name}: output mismatch vs oracle")
        return st, rep


class SEL(_CompactBase):
    name = "SEL"
    unique = False


class UNI(_CompactBase):
    name = "UNI"
    unique = True
