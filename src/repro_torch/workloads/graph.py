"""Graph / DP workloads: BFS (multi-kernel, host-bounced frontiers) and
NW (Needleman-Wunsch wavefront DP).

Both exercise the paper's inter-DPU communication path: per-iteration
shared state (BFS frontiers / NW block boundaries) crosses DPUs between
kernel launches (§II-B, Fig. 10's sub-linear scalers). BFS routes its
frontier/dist merge through ``repro_torch.comm`` allreduce collectives, and NW
exchanges its tile boundaries through gather/scatter collectives, so both
are host-bounced or direct-fabric depending on the system's configured
backend and get per-event phase attribution."""
from __future__ import annotations

import numpy as np

from repro_torch.comm import collectives
from repro_torch.core.asm import N_TASKLETS, Program, Reg, TID, ZERO
from repro_torch.core.host import PIMSystem, merge_reports
from repro_torch.workloads.base import BLK, HostData, Workload
from repro_torch.workloads.streaming import _min_imm, _mk_mram

NW_T = 16  # NW DP tile


class BFS(Workload):
    """Level-synchronous BFS.  Vertices are partitioned across DPUs; each
    kernel expands one level; the host ORs next-frontiers and merges dist
    arrays across DPUs between kernels."""

    name = "BFS"
    default_n = 1_536  # vertices (degree ~8)

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program("BFS", nt)
        V, level, optr, oadj = p.regs("V", "level", "optr", "oadj")
        p.load_arg(V, 0)
        p.load_arg(level, 1)
        p.load_arg(optr, 2)
        p.load_arg(oadj, 3)
        # WRAM-resident state for this level (staged by tasklet 0)
        # dist | cur | next: V words each
        dist_w = p.walloc("dist", 2048 * 4)
        cur_w = p.walloc("cur", 2048 * 4)
        nxt_w = p.walloc("next", 2048 * 4)
        pbuf = p.walloc("pbuf", nt * 8)
        abuf = p.walloc("abuf", nt * BLK)
        odist, ocur, onxt, v0, v1 = p.regs("odist", "ocur", "onxt", "v0", "v1")
        p.load_arg(odist, 4)
        p.load_arg(ocur, 5)
        p.load_arg(onxt, 6)
        p.load_arg(v0, 7)   # my DPU's owned vertex range
        p.load_arg(v1, 8)

        # ---- tasklet 0 stages dist/cur and zeroes next ----
        sk = p.newlabel("stage")
        p.bne(TID, ZERO, sk)
        t, ma, nb, vb = p.regs("t", "ma", "nb", "vb")
        p.sll(vb, V, 2)
        for wb, off in ((dist_w, odist), (cur_w, ocur)):
            p.li(t, wb)
            p.mv(ma, off)
            done_l, top_l = p.newlabel("se"), p.newlabel("st")
            p.li(nb, 0)
            p.label(top_l)
            p.bge(nb, vb, done_l)
            p.ldma(t, ma, BLK)
            p.add(t, t, BLK)
            p.add(ma, ma, BLK)
            p.add(nb, nb, BLK)
            p.jump(top_l)
            p.label(done_l)
        p.li(t, nxt_w)
        z, zend = p.regs("z", "zend")
        p.li(z, nxt_w)
        p.add(zend, z, vb)
        ztop, zdone = p.newlabel("z"), p.newlabel("zend")
        p.label(ztop)
        p.bge(z, zend, zdone)
        p.sw(z, 0, ZERO)
        p.add(z, z, 4)
        p.jump(ztop)
        p.label(zdone)
        p.free(t, ma, nb, vb, z, zend)
        p.label(sk)
        p.free(ocur)  # only the staging section needs it
        p.barrier()

        # ---- expand my vertices ----
        wa, wp = p.regs("wa", "wp")
        p.mul(wa, TID, BLK)
        p.add(wa, wa, abuf)
        p.mul(wp, TID, 8)
        p.add(wp, wp, pbuf)
        # vertices striped over tasklets within [v0, v1)
        v, addr, s, e, nb2, u, pa = p.regs("v", "addr", "s", "e", "nb2", "u",
                                           "pa")
        p.add(v, v0, TID)
        p.free(v0)
        vtop, vfin = p.newlabel("v"), p.newlabel("vend")
        p.label(vtop)
        p.bge(v, v1, vfin)
        # on frontier?
        p.sll(addr, v, 2)
        p.add(addr, addr, cur_w)
        p.lw(u, addr)
        skipv = p.newlabel("skipv")
        p.beq(u, ZERO, skipv)
        # adjacency range
        p.sll(addr, v, 2)
        p.add(addr, addr, optr)
        p.ldma(wp, addr, 8)
        p.lw(s, wp)
        p.lw(e, wp, 4)
        seg, segend = p.newlabel("seg"), p.newlabel("segend")
        p.label(seg)
        p.bge(s, e, segend)
        p.sub(nb2, e, s)
        p.sll(nb2, nb2, 2)
        _min_imm(p, nb2, BLK)
        p.sll(addr, s, 2)
        p.add(addr, addr, oadj)
        p.ldma(wa, addr, nb2)
        p.mv(pa, wa)
        kend = p.reg("kend")
        p.add(kend, pa, nb2)
        ktop, kdone = p.newlabel("k"), p.newlabel("kend")
        p.label(ktop)
        p.bge(pa, kend, kdone)
        p.lw(u, pa)
        # if dist[u] < 0: dist[u] = level; next[u] = 1   (benign races)
        p.sll(addr, u, 2)
        p.add(addr, addr, dist_w)
        p.lw(u, addr)
        seen = p.newlabel("seen")
        p.bge(u, ZERO, seen)
        p.sw(addr, 0, level)
        p.add(addr, addr, nxt_w - dist_w)
        p.li(u, 1)
        p.sw(addr, 0, u)
        p.label(seen)
        p.add(pa, pa, 4)
        p.jump(ktop)
        p.label(kdone)
        p.free(kend)
        p.srl(nb2, nb2, 2)
        p.add(s, s, nb2)
        p.jump(seg)
        p.label(segend)
        p.label(skipv)
        p.add(v, v, N_TASKLETS)
        p.jump(vtop)
        p.label(vfin)
        p.free(wa, wp, v, addr, s, e, nb2, u, pa, optr, oadj, level, v1)
        p.barrier()

        # ---- tasklet 0 writes dist & next back ----
        sk2 = p.newlabel("wb")
        p.bne(TID, ZERO, sk2)
        t, ma, nb, vb = p.regs("t", "ma", "nb", "vb")
        p.sll(vb, V, 2)
        for wb, off in ((dist_w, odist), (nxt_w, onxt)):
            p.li(t, wb)
            p.mv(ma, off)
            done_l, top_l = p.newlabel("we"), p.newlabel("wt")
            p.li(nb, 0)
            p.label(top_l)
            p.bge(nb, vb, done_l)
            p.sdma(t, ma, BLK)
            p.add(t, t, BLK)
            p.add(ma, ma, BLK)
            p.add(nb, nb, BLK)
            p.jump(top_l)
            p.label(done_l)
        p.label(sk2)
        p.stop()
        return p

    def make_graph(self, scale, seed):
        V = min(self.n_elems(scale), 2048)
        rng = np.random.default_rng(seed)
        deg = rng.integers(2, 14, V)
        rowptr = np.zeros(V + 1, np.int64)
        rowptr[1:] = deg.cumsum()
        adj = rng.integers(0, V, int(rowptr[-1])).astype(np.int32)
        return V, rowptr.astype(np.int32), adj

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        raise NotImplementedError("BFS is multi-kernel; use run()")

    def _run(self, system: PIMSystem, n_threads: int, scale=1.0, seed=0,
             cache_mode=False):
        cfg = system.cfg
        D = cfg.n_dpus
        V, rowptr, adj = self.make_graph(scale, seed)
        # vertex ownership ranges per DPU
        vpd = V // D
        ranges = [(d * vpd, V if d == D - 1 else (d + 1) * vpd)
                  for d in range(D)]
        dist = np.full(V, -1, np.int32)
        dist[0] = 0
        cur = np.zeros(V, np.int32)
        cur[0] = 1
        prog = self.build(n_threads)
        binary = prog.binary(cfg.iram_instrs)
        pad = (V + 255) // 256 * 256  # DMA staging works in 1 KB blocks
        base = np.zeros((D, cfg.mram_words), np.int32)
        op, oa = 0, (V + 2 + 1) // 2 * 2 * 4
        od = oa + ((len(adj) + 255) // 256 * 256) * 4
        oc = od + pad * 4
        on = oc + pad * 4
        assert (on + pad * 4) // 4 <= cfg.mram_words
        for d in range(D):
            base[d, :V + 1] = rowptr
            base[d, oa // 4: oa // 4 + len(adj)] = adj
        system.h2d(4 * (V + 1 + len(adj)))
        reps = []
        level = 1
        while True:
            mram = base.copy()
            for d in range(D):
                mram[d, od // 4: od // 4 + V] = dist
                mram[d, oc // 4: oc // 4 + V] = cur
            args = np.zeros((D, 9), np.int32)
            for d in range(D):
                args[d] = [pad, level, op, oa, od, oc, on, *ranges[d]]
            st, rep = self.recover_launch(system, "BFS", binary, args, mram,
                                          n_threads=n_threads)
            reps.append(rep)
            out = np.asarray(st["mram"])
            # inter-DPU merge through the comm fabric: every DPU ends up
            # with the merged dist (max; unvisited = -1, visited wins) and
            # the union of next-frontiers (bitwise or); only the dist|next
            # slices are exchanged, not the whole bank image
            sl = np.concatenate([out[:, od // 4: od // 4 + V],
                                 out[:, on // 4: on // 4 + V]], axis=1)
            collectives.allreduce(system, sl, 0, V, op="max")
            collectives.allreduce(system, sl, V, V, op="or")
            dist = sl[0, :V].copy()
            cur = (sl[0, V:] != 0).astype(np.int32)
            if cur.sum() == 0 or level > V:
                break
            level += 1
        # oracle BFS
        want = np.full(V, -1, np.int64)
        want[0] = 0
        frontier = [0]
        lv = 0
        while frontier:
            lv += 1
            nxt = []
            for v in frontier:
                for u in adj[rowptr[v]:rowptr[v + 1]]:
                    if want[u] < 0:
                        want[u] = lv
                        nxt.append(int(u))
            frontier = nxt
        if not np.array_equal(dist.astype(np.int64), want):
            raise AssertionError("BFS: dist mismatch vs oracle")
        rep = merge_reports("BFS", reps)
        system.d2h(4 * V)
        return st, rep


class NW(Workload):
    """Needleman-Wunsch DP: anti-diagonal wavefront of 16x16 tiles.
    The host launches one kernel per tile-diagonal; tile boundaries cross
    DPUs through the host (communication grows with DPU count — the paper's
    sub-linear scaling case)."""

    name = "NW"
    default_n = 256  # sequence length

    MATCH, MISMATCH, GAP = 1, -1, -1

    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program("NW", nt)
        # register budget is tight: oa/ob are re-read from the WRAM arg area
        # per tile instead of pinned in registers.
        n, diag, oh = p.regs("n", "diag", "oh")
        p.load_arg(n, 0)    # sequence length
        p.load_arg(diag, 1)  # tile diagonal index
        p.load_arg(oh, 2)   # DP matrix (n+1)^2
        b0, bcnt = p.regs("b0", "bcnt")
        p.load_arg(b0, 5)   # first tile (on this diagonal) owned by this DPU
        p.load_arg(bcnt, 6)  # number of tiles owned
        tile_buf = p.walloc("tile", nt * (NW_T + 1) * (NW_T + 1) * 4)
        seq_buf = p.walloc("seq", nt * 2 * NW_T * 4)
        row1 = p.reg("row1")
        p.add(row1, n, 1)   # DP row stride (words)
        p.free(n)

        wt, sb = p.regs("wt", "sb")
        p.mul(wt, TID, (NW_T + 1) * (NW_T + 1) * 4)
        p.add(wt, wt, tile_buf)
        p.mul(sb, TID, 2 * NW_T * 4)
        p.add(sb, sb, seq_buf)
        p.add(sb, sb, NW_T * 4)  # b segment; a segment sits at sb - T*4

        k, bi, bj, t2, i, j, r0c0 = p.regs("k", "bi", "bj", "t2", "i", "j",
                                           "r0c0")
        p.mv(k, TID)
        top, fin = p.newlabel(), p.newlabel()
        p.label(top)
        p.bge(k, bcnt, fin)
        p.add(bi, b0, k)     # tile row index
        p.sub(bj, diag, bi)  # tile col index
        # --- stage boundary: row above the tile (T+1 words incl corner) ---
        p.mul(t2, bi, NW_T)
        p.mul(t2, t2, row1)
        p.mul(r0c0, bj, NW_T)
        p.add(t2, t2, r0c0)
        p.sll(t2, t2, 2)
        p.add(t2, t2, oh)           # &H[bi*T][bj*T]
        p.ldma(wt, t2, (NW_T + 1) * 4)  # row 0 of the tile frame
        # left column: one word per row (strided DMA, T transfers)
        with p.for_range(i, 0, NW_T):
            p.sll(r0c0, row1, 2)
            p.add(t2, t2, r0c0)     # next DP row
            p.mul(r0c0, i, (NW_T + 1) * 4)
            p.add(r0c0, r0c0, wt)
            p.add(r0c0, r0c0, (NW_T + 1) * 4)  # row i+1, col 0 of frame
            p.ldma(r0c0, t2, 4)
        # --- stage sequence segments (oa/ob read from the arg area) ---
        p.load_arg(t2, 3)
        p.mul(r0c0, bi, NW_T * 4)
        p.add(t2, t2, r0c0)
        p.sub(r0c0, sb, NW_T * 4)
        p.ldma(r0c0, t2, NW_T * 4)  # a segment
        p.load_arg(t2, 4)
        p.mul(r0c0, bj, NW_T * 4)
        p.add(t2, t2, r0c0)
        p.ldma(sb, t2, NW_T * 4)    # b segment
        # --- compute the TxT tile (t2/r0c0 double as scratch temps) ---
        va, vb, h, d0 = p.regs("va", "vb", "h", "d0")
        with p.for_range(i, 0, NW_T):
            p.sll(va, i, 2)
            p.add(va, va, sb)
            p.lw(va, va, -(NW_T * 4))  # a[bi*T + i]
            with p.for_range(j, 0, NW_T):
                p.sll(vb, j, 2)
                p.add(vb, vb, sb)
                p.lw(vb, vb)        # b[bj*T + j]
                p.add(h, i, 1)
                p.mul(h, h, (NW_T + 1) * 4)
                p.add(h, h, wt)
                p.sll(d0, j, 2)
                p.add(h, h, d0)     # &frame[i+1][j] (left neighbour)
                p.lw(d0, h, -((NW_T + 1) * 4))      # diag
                p.sub(vb, va, vb)
                eq = p.newlabel("eq")
                neq = p.newlabel("neq")
                p.beq(vb, ZERO, eq)
                p.add(d0, d0, self.MISMATCH)
                p.jump(neq)
                p.label(eq)
                p.add(d0, d0, self.MATCH)
                p.label(neq)
                p.lw(r0c0, h, -((NW_T + 1) * 4) + 4)  # up
                p.add(r0c0, r0c0, self.GAP)
                le = p.newlabel("le")
                p.bge(d0, r0c0, le)
                p.mv(d0, r0c0)
                p.label(le)
                p.lw(r0c0, h, 0)                      # left
                p.add(r0c0, r0c0, self.GAP)
                le2 = p.newlabel("le2")
                p.bge(d0, r0c0, le2)
                p.mv(d0, r0c0)
                p.label(le2)
                p.sw(h, 4, d0)                      # frame[i+1][j+1]
        # --- write tile rows back (T rows of T words, skipping the frame) ---
        with p.for_range(i, 0, NW_T):
            p.add(h, i, 1)
            p.mul(h, h, (NW_T + 1) * 4)
            p.add(h, h, wt)
            p.add(h, h, 4)
            # mram: &H[bi*T+1+i][bj*T+1]
            p.mul(r0c0, bi, NW_T)
            p.add(r0c0, r0c0, 1)
            p.add(r0c0, r0c0, i)
            p.mul(r0c0, r0c0, row1)
            p.mul(d0, bj, NW_T)
            p.add(r0c0, r0c0, d0)
            p.add(r0c0, r0c0, 1)
            p.sll(r0c0, r0c0, 2)
            p.add(r0c0, r0c0, oh)
            p.sdma(h, r0c0, NW_T * 4)
        p.free(va, vb, h, d0)
        p.add(k, k, N_TASKLETS)
        p.jump(top)
        p.label(fin)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        raise NotImplementedError("NW is multi-kernel; use run()")

    def _run(self, system: PIMSystem, n_threads: int, scale=1.0, seed=0,
             cache_mode=False):
        cfg = system.cfg
        D = cfg.n_dpus
        n = max(int(self.default_n * scale) // NW_T, 2) * NW_T
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 4, n).astype(np.int32)
        b = rng.integers(0, 4, n).astype(np.int32)
        row1 = n + 1
        H = np.zeros((row1, row1), np.int32)
        H[0, :] = np.arange(row1) * self.GAP
        H[:, 0] = np.arange(row1) * self.GAP
        prog = self.build(n_threads)
        binary = prog.binary(cfg.iram_instrs)
        oh, oa_, ob = 0, row1 * row1 * 4, row1 * row1 * 4 + n * 4
        oa_ = (oa_ + 7) // 8 * 8
        ob = oa_ + ((n * 4 + 7) // 8 * 8)
        assert (ob + n * 4) // 4 <= cfg.mram_words
        nb_tiles = n // NW_T
        system.h2d(4 * (2 * n + row1 * row1))
        reps = []
        prev_tiles, prev_per = [], 0  # producers of the last diagonal
        for diag in range(2 * nb_tiles - 1):
            tiles = [(bi, diag - bi) for bi in range(nb_tiles)
                     if 0 <= diag - bi < nb_tiles]
            # distribute contiguous chunks of the diagonal across DPUs
            per = (len(tiles) + D - 1) // D
            mram = np.zeros((D, cfg.mram_words), np.int32)
            args = np.zeros((D, 7), np.int32)
            for d in range(D):
                mram[d, oh // 4: oh // 4 + row1 * row1] = H.reshape(-1)
                mram[d, oa_ // 4: oa_ // 4 + n] = a
                mram[d, ob // 4: ob // 4 + n] = b
                mine = tiles[d * per:(d + 1) * per]
                args[d] = [n, diag, oh, oa_, ob,
                           mine[0][0] if mine else 0, len(mine)]
            if D > 1 and prev_tiles:
                # Boundary exchange through repro_torch.comm instead of the old
                # flat worst-case bounce, so the bytes get per-event
                # gather/scatter attribution and ride the configured
                # fabric.  Up leg: every DPU uploads the tile edges it
                # PRODUCED on the previous diagonal (bottom row + right
                # column per tile).  Down leg: the host scatters each
                # consumer the halo its current tiles NEED (top row +
                # left column), in consumer order — DPU d receives its
                # neighbours' edges, not its own shard back.
                pwords = prev_per * 2 * NW_T
                up = np.zeros((D, (D + 1) * pwords), np.int32)
                for d in range(D):
                    for idx, (bi, bj) in \
                            enumerate(prev_tiles[d * prev_per:
                                                 (d + 1) * prev_per]):
                        o = idx * 2 * NW_T
                        up[d, o:o + NW_T] = \
                            H[(bi + 1) * NW_T,
                              bj * NW_T + 1:bj * NW_T + 1 + NW_T]
                        up[d, o + NW_T:o + 2 * NW_T] = \
                            H[bi * NW_T + 1:(bi + 1) * NW_T + 1,
                              (bj + 1) * NW_T]
                collectives.gather(system, up, 0, pwords, pwords, root=0)
                bwords = per * 2 * NW_T
                down = np.zeros((D, (D + 1) * bwords), np.int32)
                halo = np.zeros((D, bwords), np.int32)
                for d in range(D):
                    for idx, (bi, bj) in \
                            enumerate(tiles[d * per:(d + 1) * per]):
                        o = idx * 2 * NW_T
                        halo[d, o:o + NW_T] = \
                            H[bi * NW_T, bj * NW_T + 1:bj * NW_T + 1 + NW_T]
                        halo[d, o + NW_T:o + 2 * NW_T] = \
                            H[bi * NW_T + 1:(bi + 1) * NW_T + 1, bj * NW_T]
                down[0, bwords:] = halo.reshape(-1)  # consumer-ordered
                collectives.scatter(system, down, bwords, 0, bwords, root=0)
                assert np.array_equal(down[:, :bwords], halo), \
                    "NW halo scatter delivered the wrong boundary words"
            prev_tiles, prev_per = tiles, per
            st, rep = system.launch("NW", binary, args, mram,
                                    n_threads=n_threads)
            reps.append(rep)
            out = np.asarray(st["mram"])
            for d in range(D):
                mine = tiles[d * per:(d + 1) * per]
                Hd = out[d, oh // 4: oh // 4 + row1 * row1].reshape(row1, row1)
                for (bi, bj) in mine:
                    H[bi * NW_T + 1:(bi + 1) * NW_T + 1,
                      bj * NW_T + 1:(bj + 1) * NW_T + 1] = \
                        Hd[bi * NW_T + 1:(bi + 1) * NW_T + 1,
                           bj * NW_T + 1:(bj + 1) * NW_T + 1]
        system.d2h(4 * row1 * row1)
        # numpy oracle
        want = np.zeros((row1, row1), np.int64)
        want[0, :] = np.arange(row1) * self.GAP
        want[:, 0] = np.arange(row1) * self.GAP
        for i in range(1, row1):
            sub = np.where(a[i - 1] == b, self.MATCH, self.MISMATCH)
            for j in range(1, row1):
                want[i, j] = max(want[i - 1, j - 1] + sub[j - 1],
                                 want[i - 1, j] + self.GAP,
                                 want[i, j - 1] + self.GAP)
        if not np.array_equal(H.astype(np.int64), want):
            raise AssertionError("NW: DP matrix mismatch vs oracle")
        rep = merge_reports("NW", reps)
        return st, rep
