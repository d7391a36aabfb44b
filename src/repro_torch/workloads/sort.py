"""SSORT: distributed sample sort — the alltoall workload.

The classic alltoall-bound distributed sort (the ROADMAP's open item for
an alltoall-based workload, exercising the exchange pattern the paper's
pathfinding study says future PIM interconnects must serve):

1. **SSORT-L kernel** — each DPU sorts its local keys: every tasklet
   insertion-sorts its contiguous WRAM slice, then tasklet 0 k-way
   merges the per-tasklet runs and streams the sorted array back to
   MRAM through a staging buffer.
2. **Splitters** — every DPU contributes ``SAMPLES`` evenly spaced keys
   from its sorted run; the samples are *gathered* to DPU 0 through the
   configured fabric, D-1 splitters are picked from the sample
   distribution, and *broadcast* back (both charged collectives).
3. **alltoall exchange** — each DPU's sorted run splits into D
   contiguous splitter-bounded buckets (bucket j goes to DPU j); the
   per-pair bucket counts and the padded bucket blocks both move
   through :func:`repro_torch.comm.collectives.alltoall` — this is the
   communication phase that dominates at scale.
4. **SSORT-M kernel** — each DPU packs its D received (already sorted)
   blocks into WRAM in parallel across tasklets and tasklet 0 k-way
   merges them into the final run.

The result — DPU d holds the d-th contiguous slice of the globally
sorted key sequence — is checked against a ``np.sort`` oracle on every
run, identically for host-bounce / direct / hierarchical fabrics (the
collectives move the same bytes; only the charged time differs).
"""
from __future__ import annotations

import numpy as np

from repro_torch.comm import collectives
from repro_torch.core.asm import N_DPUS, N_TASKLETS, Program, Reg, TID, ZERO
from repro_torch.core.host import PIMSystem, merge_reports
from repro_torch.workloads.base import BLK, Workload
from repro_torch.workloads.streaming import _min_imm

#: max words per DPU the local-sort kernel stages into WRAM
SORT_MAX_N = 4096
#: max packed received words the merge kernel stages into WRAM
MERGE_MAX_WORDS = 6144
#: max DPUs (the merge kernel's count/cursor arrays are sized for this)
MAX_D = 32
#: splitter samples contributed per DPU
SAMPLES = 8


def _emit_stage_loop(p: Program, dst: Reg, src: Reg, rem: Reg, nb: Reg,
                     load: bool):
    """Move ``rem`` bytes between WRAM ``dst``/MRAM ``src`` in BLK chunks
    (``load``: MRAM->WRAM ldma, else sdma); clobbers all four registers."""
    top, fin = p.newlabel("cp"), p.newlabel("cpend")
    p.label(top)
    p.bge(ZERO, rem, fin)
    p.mv(nb, rem)
    _min_imm(p, nb, BLK)
    if load:
        p.ldma(dst, src, nb)
    else:
        p.sdma(dst, src, nb)
    p.add(dst, dst, nb)
    p.add(src, src, nb)
    p.sub(rem, rem, nb)
    p.jump(top)
    p.label(fin)


def _emit_kway_merge(p: Program, *, total: Reg, k_stop, heads: int,
                     ends: int, ob: int, out_reg: Reg, t: Reg, hp: Reg):
    """Tasklet-0 k-way merge: pop the global min across the ``k_stop``
    run cursors at WRAM ``heads``/``ends`` exactly ``total`` times,
    streaming the output through the ``ob`` buffer to MRAM ``out_reg``.
    Exhausted runs (head == end) are skipped; empty runs are fine."""
    mo, filled = p.regs("mo", "filled")
    p.mv(mo, out_reg)
    p.li(filled, 0)
    c, bestslot, bestv, h, e, x = p.regs("c", "bs", "bv", "h", "e", "x")
    with p.for_range(c, 0, total):
        p.li(bestslot, 0)  # 0 = "no candidate yet" (walloc addrs are > 0)
        with p.for_range(t, 0, k_stop):
            p.sll(hp, t, 2)
            p.add(hp, hp, heads)
            p.lw(h, hp)
            p.lw(e, hp, ends - heads)
            skip = p.newlabel("mk")
            p.bge(h, e, skip)          # run exhausted
            p.lw(x, h)
            have = p.newlabel("hv")
            p.bne(bestslot, ZERO, have)
            p.mv(bestslot, hp)
            p.mv(bestv, x)
            p.jump(skip)
            p.label(have)
            p.bge(x, bestv, skip)
            p.mv(bestslot, hp)
            p.mv(bestv, x)
            p.label(skip)
        p.add(h, filled, ob)
        p.sw(h, 0, bestv)
        p.add(filled, filled, 4)
        p.lw(h, bestslot)              # advance the winning cursor
        p.add(h, h, 4)
        p.sw(bestslot, 0, h)
        nf = p.newlabel("nf")
        p.blt(filled, BLK, nf)
        p.li(h, ob)
        p.sdma(h, mo, BLK)
        p.add(mo, mo, BLK)
        p.li(filled, 0)
        p.label(nf)
    lf = p.newlabel("lf")
    p.beq(filled, ZERO, lf)
    p.li(h, ob)
    p.sdma(h, mo, filled)
    p.label(lf)
    p.free(mo, filled, c, bestslot, bestv, h, e, x)


class SSORT(Workload):
    """Distributed sample sort (alltoall-bound, multi-kernel)."""

    name = "SSORT"
    default_n = 4096  # keys per DPU (bounded by the WRAM staging area)

    def n_elems(self, scale: float) -> int:
        return min(super().n_elems(scale), SORT_MAX_N // 48 * 48)

    # ---- kernel 1: local sort ------------------------------------------------
    def build(self, nt, cache_mode=False):
        assert not cache_mode
        p = Program("SSORT-L", nt)
        A = p.walloc("A", SORT_MAX_N * 4)
        heads = p.walloc("heads", nt * 4)
        ends = p.walloc("ends", nt * 4)
        ob = p.walloc("ob", BLK)
        n, oin, oout = p.regs("n", "oin", "oout")
        p.load_arg(n, 0)
        p.load_arg(oin, 1)
        p.load_arg(oout, 2)
        mb = p.reg("mb")               # bytes per tasklet slice
        p.div(mb, n, N_TASKLETS)
        p.sll(mb, mb, 2)
        wb, ma = p.regs("wb", "ma")
        p.mul(wb, TID, mb)
        p.add(ma, wb, oin)
        p.add(wb, wb, A)
        p.free(oin)
        # stage my slice
        cw, cm, rem, nb = p.regs("cw", "cm", "rem", "nb")
        p.mv(cw, wb)
        p.mv(cm, ma)
        p.mv(rem, mb)
        _emit_stage_loop(p, cw, cm, rem, nb, load=True)
        p.free(cw, cm, rem, nb, ma)
        # insertion sort [wb, wb + mb)
        end, i, j, v, u = p.regs("end", "i", "j", "v", "u")
        p.add(end, wb, mb)
        p.add(i, wb, 4)
        outer, odone = p.newlabel("is"), p.newlabel("isend")
        p.label(outer)
        p.bge(i, end, odone)
        p.lw(v, i)
        p.sub(j, i, 4)
        inner, place = p.newlabel("in"), p.newlabel("pl")
        p.label(inner)
        p.blt(j, wb, place)
        p.lw(u, j)
        p.bge(v, u, place)
        p.sw(j, 4, u)
        p.sub(j, j, 4)
        p.jump(inner)
        p.label(place)
        p.sw(j, 4, v)
        p.add(i, i, 4)
        p.jump(outer)
        p.label(odone)
        p.free(end, i, j, v, u, wb)
        p.barrier()
        # tasklet 0: merge the nt runs and stream to MRAM
        sk = p.newlabel("skipm")
        p.bne(TID, ZERO, sk)
        t, hp, val = p.regs("t", "hp", "val")
        with p.for_range(t, 0, N_TASKLETS):
            p.sll(hp, t, 2)
            p.add(hp, hp, heads)
            p.mul(val, t, mb)
            p.add(val, val, A)
            p.sw(hp, 0, val)
            p.add(val, val, mb)
            p.sw(hp, ends - heads, val)
        p.free(val)
        _emit_kway_merge(p, total=n, k_stop=N_TASKLETS, heads=heads,
                         ends=ends, ob=ob, out_reg=oout, t=t, hp=hp)
        p.free(t, hp)
        p.label(sk)
        p.stop()
        return p

    # ---- kernel 2: merge the received buckets --------------------------------
    def _build_merge(self, nt):
        p = Program("SSORT-M", nt)
        cntraw = p.walloc("cntraw", MAX_D * 8)   # [count, 0] per source
        heads = p.walloc("heads", MAX_D * 4)
        ends = p.walloc("ends", MAX_D * 4)
        totw = p.walloc("tot", 8)
        A = p.walloc("A", MERGE_MAX_WORDS * 4)
        ob = p.walloc("ob", BLK)
        cb, ocnt, orecv, oout = p.regs("cb", "ocnt", "orecv", "oout")
        p.load_arg(cb, 0)    # bucket-block capacity (bytes)
        p.load_arg(ocnt, 1)  # received count blocks (MRAM)
        p.load_arg(orecv, 2)  # received bucket blocks (MRAM)
        p.load_arg(oout, 3)  # final sorted run (MRAM)
        # tasklet 0: stage counts, lay the packed runs out in WRAM
        sk0 = p.newlabel("sk0")
        p.bne(TID, ZERO, sk0)
        t, hp, cnt, off = p.regs("t", "hp", "cnt", "off")
        p.sll(cnt, N_DPUS, 3)          # nd * 8 bytes of count blocks
        p.li(hp, cntraw)
        p.ldma(hp, ocnt, cnt)
        p.li(off, A)
        with p.for_range(t, 0, N_DPUS):
            p.sll(hp, t, 3)
            p.add(hp, hp, cntraw)
            p.lw(cnt, hp)              # words from source t
            p.sll(cnt, cnt, 2)
            p.sll(hp, t, 2)
            p.add(hp, hp, heads)
            p.sw(hp, 0, off)
            p.add(off, off, cnt)
            p.sw(hp, ends - heads, off)
        p.li(hp, totw)                 # total received bytes
        p.sub(off, off, A)
        p.sw(hp, 0, off)
        p.free(t, hp, cnt, off)
        p.label(sk0)
        p.barrier()
        # every tasklet: stage blocks TID, TID+NT, ... into the packed runs
        d, hp, src, dst, rem, nb = p.regs("d", "hp", "src", "dst", "rem",
                                          "nb")
        p.mv(d, TID)
        dtop, dfin = p.newlabel("dt"), p.newlabel("dend")
        p.label(dtop)
        p.bge(d, N_DPUS, dfin)
        p.sll(hp, d, 2)
        p.add(hp, hp, heads)
        p.lw(dst, hp)
        p.lw(rem, hp, ends - heads)
        p.sub(rem, rem, dst)           # this run's bytes
        p.mul(src, d, cb)
        p.add(src, src, orecv)
        _emit_stage_loop(p, dst, src, rem, nb, load=True)
        p.add(d, d, N_TASKLETS)
        p.jump(dtop)
        p.label(dfin)
        p.free(d, hp, src, dst, rem, nb, cb, ocnt, orecv)
        p.barrier()
        # tasklet 0: merge the nd runs into the final MRAM output
        skm = p.newlabel("skm")
        p.bne(TID, ZERO, skm)
        t, hp, tot = p.regs("t", "hp", "tot")
        p.li(hp, totw)
        p.lw(tot, hp)
        p.srl(tot, tot, 2)             # words to pop
        _emit_kway_merge(p, total=tot, k_stop=N_DPUS, heads=heads,
                         ends=ends, ob=ob, out_reg=oout, t=t, hp=hp)
        p.free(t, hp, tot)
        p.label(skm)
        p.stop()
        return p

    def host_data(self, cfg, scale=1.0, seed=0, cache_mode=False):
        raise NotImplementedError("SSORT is multi-kernel; use run()")

    # ---- host orchestration --------------------------------------------------
    def _run(self, system: PIMSystem, n_threads: int, scale=1.0, seed=0,
             cache_mode=False):
        if cache_mode:
            raise ValueError("SSORT has no cache-mode (direct-addressing) "
                             "variant")
        cfg = system.cfg
        D = cfg.n_dpus
        if D > MAX_D:
            raise ValueError(f"SSORT supports up to {MAX_D} DPUs (got {D})")
        n = self.n_elems(scale)
        if n % n_threads:
            raise ValueError(f"n={n} must divide by n_threads={n_threads}")
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, 1 << 20, (D, n)).astype(np.int32)
        lsort = self.build(n_threads).binary(cfg.iram_instrs)
        merge = self._build_merge(n_threads).binary(cfg.iram_instrs)

        # kernel 1: local sort (keys at word 0, sorted run at word n)
        o_loc = n
        img = np.zeros((D, cfg.mram_words), np.int32)
        img[:, :n] = keys
        args = np.tile(np.array([n, 0, 4 * o_loc], np.int32), (D, 1))
        system.h2d(4.0 * n)
        st, rep1 = self.recover_launch(system, "SSORT-L", lsort, args, img,
                                       n_threads=n_threads)
        local = np.asarray(st["mram"])[:, o_loc:o_loc + n].copy()

        # splitters: gather evenly spaced samples to a root DPU, pick D-1
        # quantiles from the sample distribution, broadcast them back
        # (under faults, root at the first surviving DPU — a dead root
        # would raise a typed DpuFaultError)
        root = 0
        if (getattr(system, "faults", None) is not None
                and not system.active_mask[0]):
            root = system.active_dpus[0]
        s = min(SAMPLES, n)
        pos = ((np.arange(s) + 1) * n) // s - 1
        img2 = np.zeros((D, cfg.mram_words), np.int32)
        o_gath, o_spl = s, s + D * s
        img2[:, :s] = local[:, pos]
        collectives.gather(system, img2, 0, o_gath, s, root=root)
        allsamp = np.sort(img2[root, o_gath:o_gath + D * s])
        spl = allsamp[(np.arange(1, D) * (D * s)) // D]    # D-1 splitters
        img2[root, o_spl:o_spl + D - 1] = spl
        collectives.broadcast(system, img2, o_spl, D - 1, root=root)
        spl = img2[root, o_spl:o_spl + D - 1]

        # sorted rows + splitters -> contiguous buckets (bucket j = keys
        # in [spl[j-1], spl[j]), ties to the higher bucket)
        cuts = np.stack([np.searchsorted(local[d], spl, side="left")
                         for d in range(D)]) if D > 1 else \
            np.zeros((D, 0), int)
        bounds = np.concatenate([np.zeros((D, 1), int), cuts,
                                 np.full((D, 1), n)], axis=1)
        counts = np.diff(bounds, axis=1).astype(np.int32)  # (D, D)
        C = int(max(2, (int(counts.max()) + 1) // 2 * 2))  # even capacity
        recv_tot = counts.sum(axis=0)
        if int(recv_tot.max()) > MERGE_MAX_WORDS:
            raise ValueError(
                f"sample-sort imbalance: a DPU would receive "
                f"{int(recv_tot.max())} words > {MERGE_MAX_WORDS}; "
                "raise SAMPLES or shrink scale")

        # kernel-2 image: send blocks | recv blocks | count blocks | out
        o_recv = D * C
        o_cout = 2 * D * C
        o_cin = o_cout + 2 * D
        o_out = o_cin + 2 * D
        assert o_out + int(recv_tot.max()) <= cfg.mram_words, \
            "mram too small for SSORT exchange"
        img3 = np.zeros((D, cfg.mram_words), np.int32)
        for d in range(D):
            for j in range(D):
                seg = local[d, bounds[d, j]:bounds[d, j + 1]]
                img3[d, j * C:j * C + len(seg)] = seg
            img3[d, o_cout:o_cout + 2 * D:2] = counts[d]
        # the exchange: counts first, then the padded bucket blocks
        collectives.alltoall(system, img3, o_cout, o_cin, 2)
        collectives.alltoall(system, img3, 0, o_recv, C)
        args2 = np.tile(np.array([4 * C, 4 * o_cin, 4 * o_recv, 4 * o_out],
                                 np.int32), (D, 1))
        # SSORT-M reads the N_DPUS register to size its bucket loops, so
        # a degraded remap launch must keep the logical width D
        st, rep2 = self.recover_launch(system, "SSORT-M", merge, args2, img3,
                                       n_threads=n_threads, ndpus_reg=D)
        out = np.asarray(st["mram"])
        system.d2h(4.0 * recv_tot.astype(np.float64))

        # oracle: the concatenated per-DPU runs ARE the global sort
        got = np.concatenate([out[d, o_out:o_out + int(recv_tot[d])]
                              for d in range(D)])
        want = np.sort(keys.reshape(-1))
        if not np.array_equal(got, want):
            raise AssertionError("SSORT: output mismatch vs np.sort oracle")
        return st, merge_reports("SSORT", [rep1, rep2])
