"""Linear-algebra workloads: GEMV, TRNS, MLP, SpMV."""
from __future__ import annotations

import numpy as np

from repro_torch.core.asm import CACHE_DATA_BASE, N_TASKLETS, Program, Reg, TID, ZERO
from repro_torch.workloads.base import BLK, HostData, Workload
from repro_torch.workloads.streaming import _min_imm, _mk_mram

GEMV_C = 64    # matrix columns (paper Table II: 2K x 64)
TRNS_T = 16    # transpose tile
MLP_W = 128    # MLP layer width (neurons; paper uses 256 — scaled for CI)
SPMV_C = 1024  # SpMV matrix columns (x fits WRAM)


class GEMV(Workload):
    """y = A @ x; rows striped over tasklets; one row DMA per dot product.

    Under SIMT (case study #1) consecutive tasklets process consecutive
    rows, so lane DMAs fall into neighbouring DRAM rows — the access
    pattern the memory address coalescer exploits (Fig. 11)."""

    name = "GEMV"
    default_n = 2_048  # rows

    def build(self, nt, cache_mode=False):
        p = Program("GEMV", nt, cache_mode)
        R, src, xoff, yoff = p.regs("R", "A", "x", "y")
        p.load_arg(R, 0)
        p.load_arg(src, 1)
        p.load_arg(xoff, 2)
        p.load_arg(yoff, 3)
        xbuf = p.walloc("xbuf", GEMV_C * 4)
        rbuf = p.walloc("rbuf", nt * GEMV_C * 4)
        ybuf = p.walloc("ybuf", nt * 8)
        if not cache_mode:
            # stage x once (tasklet 0); cache mode reads x in place
            sk = p.newlabel("x0")
            p.bne(TID, ZERO, sk)
            t = p.reg("t")
            p.li(t, xbuf)
            p.ldma(t, xoff, GEMV_C * 4)
            p.free(t)
            p.label(sk)
            p.barrier()
        wr, wy = p.regs("wr", "wy")
        p.mul(wr, TID, GEMV_C * 4)
        p.add(wr, wr, rbuf)
        p.mul(wy, TID, 8)
        p.add(wy, wy, ybuf)
        # rows are striped: tasklet t handles rows t, t+NT, t+2NT ...
        r, ma, acc, pa, px, va, vx, j = p.regs(
            "r", "ma", "acc", "pa", "px", "va", "vx", "j")
        p.mv(r, TID)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(r, R, fin)
        p.mul(ma, r, GEMV_C * 4)
        p.add(ma, ma, src)
        if cache_mode:
            p.mv(pa, ma)
        else:
            p.ldma(wr, ma, GEMV_C * 4)
            p.mv(pa, wr)
        p.li(acc, 0)
        if cache_mode:
            p.mv(px, xoff)
        else:
            p.li(px, xbuf)
        with p.for_range(j, 0, GEMV_C):
            p.lw(va, pa)
            p.lw(vx, px)
            p.mul(va, va, vx)
            p.add(acc, acc, va)
            p.add(pa, pa, 4)
            p.add(px, px, 4)
        p.sll(ma, r, 2)
        p.add(ma, ma, yoff)
        if cache_mode:
            p.sw(ma, 0, acc)
        else:
            p.sw(wy, 0, acc)
            p.sdma(wy, ma, 4)
        p.add(r, r, N_TASKLETS)
        p.jump(top)
        p.label(fin)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        R = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        A = rng.integers(-64, 64, (D, R, GEMV_C)).astype(np.int32)
        x = rng.integers(-64, 64, (D, GEMV_C)).astype(np.int32)
        img, (oa, ox, oy) = _mk_mram(
            cfg, [A.reshape(D, -1), x, np.zeros((D, R), np.int32)])
        base = CACHE_DATA_BASE if cache_mode else 0
        args = np.tile(np.array([R, base + oa, base + ox, base + oy],
                                np.int32), (D, 1))
        want = np.einsum("drc,dc->dr", A, x).astype(np.int32)

        def check(mem):
            w = base // 4
            return np.array_equal(mem[:, w + oy // 4: w + oy // 4 + R], want)

        return HostData(args, img, h2d_bytes=4 * (R * GEMV_C + GEMV_C),
                        d2h_bytes=4 * R, check=check)

    def host_data_cache(self, cfg, scale, seed):
        return self.host_data(cfg, scale, seed, cache_mode=True)


class TRNS(Workload):
    """Tiled matrix transpose with a mutex-protected dynamic work queue —
    DMA- and synchronization-heavy (paper Fig. 9)."""

    name = "TRNS"
    default_n = 16_384  # elements (= R*C with R = C = sqrt)
    sync_heavy = True

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program("TRNS", nt)
        Rr, Cc, src, dst = p.regs("R", "C", "src", "dst")
        p.load_arg(Rr, 0)
        p.load_arg(Cc, 1)
        p.load_arg(src, 2)
        p.load_arg(dst, 3)
        queue = p.walloc("queue", 8)
        tbuf = p.walloc("tbuf", nt * TRNS_T * TRNS_T * 4)
        obuf = p.walloc("obuf", nt * TRNS_T * 4)
        ntiles, tpr = p.regs("ntiles", "tpr")
        p.div(tpr, Cc, TRNS_T)          # tiles per row
        p.div(ntiles, Rr, TRNS_T)
        p.mul(ntiles, ntiles, tpr)
        wt, wo = p.regs("wt", "wo")
        p.mul(wt, TID, TRNS_T * TRNS_T * 4)
        p.add(wt, wt, tbuf)
        p.mul(wo, TID, TRNS_T * 4)
        p.add(wo, wo, obuf)
        tile, ti, tj, ma, i, v = p.regs("tile", "ti", "tj", "ma", "i", "v")
        qa = p.reg("qa")
        p.li(qa, queue)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        # pop the work queue
        p.acquire(0)
        p.lw(tile, qa)
        p.add(v, tile, 1)
        p.sw(qa, 0, v)
        p.release(0)
        p.bge(tile, ntiles, fin)
        p.div(ti, tile, tpr)
        p.mul(tj, ti, tpr)
        p.sub(tj, tile, tj)
        # load TRNS_T rows of the tile
        rowb = p.reg("rowb")
        with p.for_range(i, 0, TRNS_T):
            p.mul(ma, ti, TRNS_T)
            p.add(ma, ma, i)
            p.mul(ma, ma, Cc)
            p.mul(v, tj, TRNS_T)
            p.add(ma, ma, v)
            p.sll(ma, ma, 2)
            p.add(ma, ma, src)
            p.mul(rowb, i, TRNS_T * 4)
            p.add(rowb, rowb, wt)
            p.ldma(rowb, ma, TRNS_T * 4)
        # emit transposed columns
        j2, pc = p.regs("j2", "pc")
        with p.for_range(i, 0, TRNS_T):
            # gather column i into the output row buffer
            with p.for_range(j2, 0, TRNS_T):
                p.mul(pc, j2, TRNS_T * 4)
                p.add(pc, pc, wt)
                p.sll(v, i, 2)
                p.add(pc, pc, v)
                p.lw(v, pc)
                p.mul(pc, j2, 4)
                p.add(pc, pc, wo)
                p.sw(pc, 0, v)
            # out[(tj*T+i)*R + ti*T ...]
            p.mul(ma, tj, TRNS_T)
            p.add(ma, ma, i)
            p.mul(ma, ma, Rr)
            p.mul(v, ti, TRNS_T)
            p.add(ma, ma, v)
            p.sll(ma, ma, 2)
            p.add(ma, ma, dst)
            p.sdma(wo, ma, TRNS_T * 4)
        p.free(j2, pc, rowb)
        p.jump(top)
        p.label(fin)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = self.n_elems(scale)
        side = max(int(np.sqrt(n)) // TRNS_T, 1) * TRNS_T
        rng = np.random.default_rng(seed)
        A = rng.integers(-1000, 1000, (D, side, side)).astype(np.int32)
        img, (oa, oo) = _mk_mram(
            cfg, [A.reshape(D, -1), np.zeros((D, side * side), np.int32)])
        args = np.tile(np.array([side, side, oa, oo], np.int32), (D, 1))
        want = A.transpose(0, 2, 1).reshape(D, -1)

        def check(mem):
            return np.array_equal(mem[:, oo // 4: oo // 4 + side * side], want)

        return HostData(args, img, h2d_bytes=4 * side * side,
                        d2h_bytes=4 * side * side, check=check)


class MLP(Workload):
    """3-layer integer MLP (GEMV + ReLU per layer, barrier between layers)."""

    name = "MLP"
    default_n = MLP_W
    n_layers = 3

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program("MLP", nt)
        n, woff, xoff, yoff = p.regs("n", "w", "x", "y")
        p.load_arg(n, 0)
        p.load_arg(woff, 1)
        p.load_arg(xoff, 2)
        p.load_arg(yoff, 3)
        xbuf = p.walloc("xbuf", MLP_W * 4)
        ybuf = p.walloc("ybuf", MLP_W * 4)
        rbuf = p.walloc("rbuf", nt * MLP_W * 4)
        # tasklet 0 stages the input activations
        sk = p.newlabel("x0")
        p.bne(TID, ZERO, sk)
        t = p.reg("t")
        p.li(t, xbuf)
        p.ldma(t, xoff, MLP_W * 4)
        p.free(t)
        p.label(sk)
        p.free(xoff)
        wr = p.reg("wr")
        p.mul(wr, TID, MLP_W * 4)
        p.add(wr, wr, rbuf)
        layer, xb, yb = p.regs("layer", "xb", "yb")
        p.li(xb, xbuf)
        p.li(yb, ybuf)
        r, ma, acc, pa, px, va, vx, j, tswap = p.regs(
            "r", "ma", "acc", "pa", "px", "va", "vx", "j", "tswap")
        with p.for_range(layer, 0, self.n_layers):
            p.barrier()  # x buffer ready
            p.mv(r, TID)
            ltop, lfin = p.newlabel("lrow"), p.newlabel("lrowend")
            p.label(ltop)
            p.bge(r, n, lfin)
            p.mul(ma, r, MLP_W * 4)
            p.add(ma, ma, woff)
            p.ldma(wr, ma, MLP_W * 4)
            p.li(acc, 0)
            p.mv(pa, wr)
            p.mv(px, xb)
            with p.for_range(j, 0, MLP_W):
                p.lw(va, pa)
                p.lw(vx, px)
                p.mul(va, va, vx)
                p.add(acc, acc, va)
                p.add(pa, pa, 4)
                p.add(px, px, 4)
            p.sra(acc, acc, 8)  # integer rescale
            relu = p.newlabel("relu")
            p.bge(acc, ZERO, relu)
            p.li(acc, 0)
            p.label(relu)
            p.sll(ma, r, 2)
            p.add(ma, ma, yb)
            p.sw(ma, 0, acc)
            p.add(r, r, N_TASKLETS)
            p.jump(ltop)
            p.label(lfin)
            p.barrier()  # layer done
            # advance weights; swap x/y buffers
            p.li(tswap, MLP_W * MLP_W * 4)
            p.add(woff, woff, tswap)
            p.mv(tswap, xb)
            p.mv(xb, yb)
            p.mv(yb, tswap)
        # tasklet 0 writes the final activations (in xb after the swap)
        sk2 = p.newlabel("out0")
        p.bne(TID, ZERO, sk2)
        p.sdma(xb, yoff, MLP_W * 4)
        p.label(sk2)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        n = MLP_W
        rng = np.random.default_rng(seed)
        W = rng.integers(-8, 8, (D, self.n_layers, n, n)).astype(np.int32)
        x = rng.integers(-8, 8, (D, n)).astype(np.int32)
        img, (ow, ox, oy) = _mk_mram(
            cfg, [W.reshape(D, -1), x, np.zeros((D, n), np.int32)])
        args = np.tile(np.array([n, ow, ox, oy], np.int32), (D, 1))

        def fwd(d):
            a = x[d].astype(np.int64)
            for l in range(self.n_layers):
                a = (W[d, l].astype(np.int64) @ a) >> 8
                a = np.maximum(a, 0)
            return a.astype(np.int32)

        want = np.stack([fwd(d) for d in range(D)])

        def check(mem):
            return np.array_equal(mem[:, oy // 4: oy // 4 + n], want)

        return HostData(args, img, h2d_bytes=4 * (self.n_layers * n * n + n),
                        d2h_bytes=4 * n, check=check)


class SpMV(Workload):
    """CSR sparse matrix-vector multiply; irregular row lengths."""

    name = "SpMV"
    default_n = 2_048  # rows; ~16 nnz/row

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        BLK2 = BLK // 2  # cols in the first half, vals in the second
        p = Program("SpMV", nt)
        R, optr, ocol, oval = p.regs("R", "optr", "ocol", "oval")
        p.load_arg(R, 0)
        p.load_arg(optr, 1)
        p.load_arg(ocol, 2)
        p.load_arg(oval, 3)
        xbuf = p.walloc("xbuf", SPMV_C * 4)
        pbuf = p.walloc("pbuf", nt * 8)
        cvbuf = p.walloc("cvbuf", nt * BLK)
        oy = p.reg("oy")
        p.load_arg(oy, 5)
        sk = p.newlabel("x0")
        p.bne(TID, ZERO, sk)
        t, ox = p.regs("t", "ox")
        p.load_arg(ox, 4)
        p.li(t, xbuf)
        for off in range(0, SPMV_C * 4, BLK):
            p.ldma(t, ox, min(BLK, SPMV_C * 4 - off))
            p.add(t, t, BLK)
            p.add(ox, ox, BLK)
        p.free(t, ox)
        p.label(sk)
        p.barrier()
        wp, wc = p.regs("wp", "wc")
        p.mul(wp, TID, 8)
        p.add(wp, wp, pbuf)
        p.mul(wc, TID, BLK)
        p.add(wc, wc, cvbuf)
        r, ma, s, e, acc, nb, vv, col, pc2 = p.regs(
            "r", "ma", "s", "e", "acc", "nb", "vv", "col", "pc2")
        p.mv(r, TID)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(r, R, fin)
        p.sll(ma, r, 2)
        p.add(ma, ma, optr)
        p.ldma(wp, ma, 8)  # rowptr[r], rowptr[r+1]
        p.lw(s, wp)
        p.lw(e, wp, 4)
        p.li(acc, 0)
        seg, sfin = p.newlabel("seg"), p.newlabel("segend")
        p.label(seg)
        p.bge(s, e, sfin)
        p.sub(nb, e, s)
        p.sll(nb, nb, 2)
        _min_imm(p, nb, BLK2)
        p.sll(ma, s, 2)
        p.add(ma, ma, ocol)
        p.ldma(wc, ma, nb)            # column indices -> first half
        p.sub(ma, ma, ocol)
        p.add(ma, ma, oval)
        p.add(pc2, wc, BLK2)
        p.ldma(pc2, ma, nb)           # values -> second half
        kend = p.reg("kend")
        p.add(kend, pc2, nb)
        ktop, kdone = p.newlabel("k"), p.newlabel("kend")
        p.label(ktop)
        p.bge(pc2, kend, kdone)
        p.lw(col, pc2, -BLK2)         # column index (first half)
        p.sll(col, col, 2)
        p.add(col, col, xbuf)
        p.lw(col, col)                # x[col]
        p.lw(vv, pc2)                 # value (second half)
        p.mul(vv, vv, col)
        p.add(acc, acc, vv)
        p.add(pc2, pc2, 4)
        p.jump(ktop)
        p.label(kdone)
        p.free(kend)
        p.srl(nb, nb, 2)
        p.add(s, s, nb)
        p.jump(seg)
        p.label(sfin)
        p.sll(ma, r, 2)
        p.add(ma, ma, oy)
        p.sw(wp, 0, acc)              # reuse the rowptr staging word
        p.sdma(wp, ma, 4)
        p.add(r, r, N_TASKLETS)
        p.jump(top)
        p.label(fin)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        D = cfg.n_dpus
        R = self.n_elems(scale)
        rng = np.random.default_rng(seed)
        # irregular rows: nnz/row in [0, 32)
        nnz_row = rng.integers(0, 32, (D, R))
        rowptr = np.zeros((D, R + 1), np.int64)
        rowptr[:, 1:] = nnz_row.cumsum(1)
        nnz_max = int(rowptr[:, -1].max())
        col = np.zeros((D, nnz_max), np.int32)
        val = np.zeros((D, nnz_max), np.int32)
        for d in range(D):
            m = int(rowptr[d, -1])
            col[d, :m] = rng.integers(0, SPMV_C, m)
            val[d, :m] = rng.integers(-16, 16, m)
        x = rng.integers(-16, 16, (D, SPMV_C)).astype(np.int32)
        img, (op_, oc, ov, ox, oy) = _mk_mram(
            cfg, [rowptr.astype(np.int32), col, val, x,
                  np.zeros((D, R), np.int32)])
        args = np.tile(np.array([R, op_, oc, ov, ox, oy], np.int32), (D, 1))
        want = np.zeros((D, R), np.int32)
        for d in range(D):
            for r in range(R):
                s, e = rowptr[d, r], rowptr[d, r + 1]
                want[d, r] = (val[d, s:e].astype(np.int64)
                              * x[d, col[d, s:e]].astype(np.int64)).sum()

        def check(mem):
            return np.array_equal(mem[:, oy // 4: oy // 4 + R], want)

        return HostData(args, img,
                        h2d_bytes=4 * (R + 1 + 2 * nnz_max + SPMV_C),
                        d2h_bytes=4 * R, check=check)
