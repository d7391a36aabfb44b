"""CUDA binding of the CRF command-step kernel (``csrc/crf_step.cu``).

The kernel runs K commands of every bank of the HBM-PIM command model per
launch.  It replaces no Pallas kernel: the JAX package runs the step
(``repro.core.hbmpim.make_cmd_step``) as jnp code.  Built with ``nvcc``
for ``sm_90a`` at first use and bound through ctypes.

The kernel reads, besides the state leaves of :data:`LEAVES` (by
pointer), the image's op, destination, a, b and target of each slot
(:func:`pack_image`, 8 int32 a slot), the int32 configuration fields of
:data:`CONFIG` with the float32 burst size (:func:`config_fields`), and,
on its ``resident_smem`` route, the staged image (:func:`staged_image`:
each slot's static timing and its operands' shared-memory descriptors)
and the copies that stage the image's rows (:func:`row_table`,
:func:`segments`).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.config import DPUConfig
from repro_torch.kernels.step_driver import StepLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "crf_step.cu",)
HEADERS = (CSRC.parents[1] / "step_common.cuh",)

#: the state leaves the kernel reads or writes, in its order (``enum Leaf``)
LEAVES = ("cycle", "pc", "status", "loop_left", "open_row", "grf_a", "grf_b",
          "srf", "mram", "c_active", "c_idle_mem", "c_issued", "c_cls",
          "c_hist", "c_dma_rd", "c_dma_wr", "c_dma_rd_bytes",
          "c_dma_wr_bytes", "c_row_hit", "c_row_miss")

#: every leaf of ``hbmpim.make_cmd_state_np``'s state
STATE_KEYS = frozenset(LEAVES) | {
    "c_idle_rev", "c_idle_rf", "c_tlb_hit", "c_tlb_miss", "c_dc_hit",
    "c_dc_miss", "c_acq_retry", "ts_buf", "ts_acc"}

#: int32 fields of the kernel's configuration (``enum Cfg``)
CONFIG = ("D", "hbm_lanes", "M", "P", "K", "H", "max_cycles",
          "row_hit_overhead", "row_miss_overhead", "xfer")

#: banks (warps) per block of the global route (``DPB``)
DPUS_PER_BLOCK = 4
#: int32 words per instruction slot of the packed image
N_FIELDS = 8

#: the CRF opcodes and operand kinds (``core/hbmpim.py``'s, which the
#: kernel's ``enum CmdOp`` and ``enum Kind`` repeat)
MOV, FILL, ADD, MUL, MAC = 3, 4, 5, 6, 7
K_BANK, K_GRF_A, K_GRF_B, K_SRF = 0, 1, 2, 3
IDX_MASK = 0xFFFFFF

_INT32_MAX = 2**31 - 1


def leaf_table(cfg: DPUConfig, D: int, M: int, H: int
               ) -> Dict[str, Tuple[torch.dtype, tuple]]:
    """Every leaf the kernel reads and writes: name -> (dtype, shape), for
    ``D`` banks, ``M`` MRAM words and ``H`` histogram bins."""
    W = cfg.hbm_lanes
    shapes = {"status": (D, 1), "grf_a": (D, 8, W), "grf_b": (D, 8, W),
              "srf": (D, 8), "mram": (D, M), "c_cls": (D, 6),
              "c_hist": (D, H)}
    return {name: (torch.float32 if name.endswith("_bytes") else torch.int32,
                   shapes.get(name, (D,))) for name in LEAVES}


def xfer(cfg: DPUConfig) -> int:
    """A bank operand's burst transfer cycles (``make_cmd_step``'s)."""
    return max(1, int(np.ceil((cfg.hbm_lanes * 4)
                              / (cfg.effective_mram_bw
                                 * cfg.coalesced_bw_mult))))


@dataclass(frozen=True)
class RowTable:
    """The MRAM rows a command stream touches, known from its image (a
    BANK operand's index is its row): ``rows``, the distinct rows sorted;
    ``slots`` (3, P), each slot's a, b and destination operand's index in
    ``rows`` where the command reads that operand from MRAM or writes it
    there, else -1; ``written``, the rows a destination names."""

    rows: np.ndarray
    slots: np.ndarray
    written: np.ndarray


def row_table(img: np.ndarray) -> RowTable:
    """The :class:`RowTable` of the (6, P) CRF image ``img``.  A command
    reads a from MRAM when it computes (MOV, FILL, ADD, MUL, MAC), b when
    it adds or multiplies (ADD, MUL, MAC), its destination when it
    accumulates (MAC), each when the operand's kind is no register (not
    GRF_A, GRF_B or SRF: ``make_cmd_step``'s read takes MRAM for every
    other kind); it writes its destination when it computes and the kind
    is BANK."""
    img = np.asarray(img, np.int32)
    op, dst, a, b = img[0], img[1], img[2], img[3]
    compute = np.isin(op, (MOV, FILL, ADD, MUL, MAC))
    uses_b = np.isin(op, (ADD, MUL, MAC))

    def from_mram(code):
        return ~np.isin(code >> 24, (K_GRF_A, K_GRF_B, K_SRF))

    write = compute & ((dst >> 24) == K_BANK)
    need = (compute & from_mram(a), uses_b & from_mram(b),
            ((op == MAC) & from_mram(dst)) | write)
    codes = (a, b, dst)
    rows = np.unique(np.concatenate(
        [c[n] & IDX_MASK for c, n in zip(codes, need)])).astype(np.int32)
    slots = np.full((3, img.shape[1]), -1, np.int32)
    for i, (c, n) in enumerate(zip(codes, need)):
        slots[i, n] = np.searchsorted(rows, c[n] & IDX_MASK)
    written = np.unique(dst[write] & IDX_MASK).astype(np.int32)
    return RowTable(rows, slots, written)


def segments(rows: np.ndarray, W: int, M: int, only=None) -> np.ndarray:
    """The copies between a bank's MRAM row and its staged rows, (n, 4)
    int32: (staged word, MRAM word, words, bulk).  Staged row i's word for
    lane l (staged word i * W + l) is MRAM word rows[i] * W + l; the
    copies cover every such word below M - 1 (column M - 1 and past it
    read one staged word, MRAM's last, which the kernel copies apart) of
    the rows in ``only`` (None: all), as runs of consecutive words, each
    cut into a 16-byte aligned body copied in bulk (bulk = 1: both word
    offsets and the length multiples of 4, and M too, so that every
    bank's row starts aligned) and the words around it (bulk = 0)."""
    rows = np.asarray(rows, np.int64)
    pick = np.ones(rows.size, bool) if only is None else np.isin(rows, only)
    col = (rows[:, None] * W + np.arange(W)[None, :]).reshape(-1)
    staged = np.arange(col.size, dtype=np.int64)
    keep = (col < M - 1) & np.repeat(pick, W)
    col, staged = col[keep], staged[keep]
    out = []
    if col.size:
        cut = np.flatnonzero((np.diff(col) != 1) | (np.diff(staged) != 1)) + 1
        for s0, c0, n in zip(staged[np.r_[0, cut]], col[np.r_[0, cut]],
                             np.diff(np.r_[0, cut, col.size])):
            s0, c0, n = int(s0), int(c0), int(n)
            head = -s0 % 4
            body = (n - head) // 4 * 4 if (s0 - c0) % 4 == 0 \
                and M % 4 == 0 and n > head else 0
            if body == 0:
                out.append((s0, c0, n, 0))
                continue
            if head:
                out.append((s0, c0, head, 0))
            out.append((s0 + head, c0 + head, body, 1))
            if n - head - body:
                out.append((s0 + head + body, c0 + head + body,
                            n - head - body, 0))
    return np.asarray(out, np.int32).reshape(-1, 4)


def writes_top(written: np.ndarray, W: int, M: int) -> bool:
    """Whether a written row holds column M - 1 (the one write that
    changes MRAM's last word; the columns past it are dropped)."""
    r = np.asarray(written, np.int64)
    return bool(((r * W <= M - 1) & (M - 1 < r * W + W)).any())


#: shared-memory words of the resident_smem route's register files: the
#: GRF (GRF_A[0..7], GRF_B[0..7], a row of 32 lanes each) and the SRF
GRF_WORDS, SRF_WORDS = 16 * 32, 8


def layout(n_slots: int, n_rows: int, lanes: int) -> Dict[str, int]:
    """The resident_smem route's shared memory, in words: the image
    (``n_slots`` slots of 8 words) from 0, then the GRF, the SRF, the
    ``n_rows`` staged rows of ``lanes`` words, and ``top`` (MRAM's last
    word); ``words``, the total rounded up to 16 bytes
    (``smem_route_bytes`` in the kernel)."""
    grf = n_slots * N_FIELDS
    srf = grf + GRF_WORDS
    rows = srf + SRF_WORDS
    top = rows + n_rows * lanes
    return dict(grf=grf, srf=srf, rows=rows, top=top,
                words=(top + 1 + 3) & ~3)


#: an operand descriptor's fields (:func:`descriptors`): the word's
#: address in shared memory (16 bits), the lane cut (6 bits), the mode
#: (lane-wise or broadcast), whether only a bank's active lanes take part,
#: whether a destination is written
DESC_CUT, DESC_MODE, DESC_BANK, DESC_WRITE = 16, 22, 24, 25
MODE_NONE, MODE_LANES, MODE_BROADCAST = 0, 1, 2


def descriptors(img: np.ndarray, table: RowTable, lanes: int,
                M: int) -> np.ndarray:
    """(3, P) int32: each slot's a, b and destination operand as the
    resident_smem kernel addresses it in shared memory (:func:`layout`),
    0 where the command neither reads it nor writes it.  ``base`` (bits
    0-15): GRF_A / GRF_B register r's row (lane-wise), SRF register r's
    word (broadcast), or the staged row of the operand's row-table slot
    (lane-wise, active lanes only, bit DESC_BANK); ``cut`` + 1 (bits
    16-21): a lane below ``cut`` reads base + lane and every other reads
    ``top``, and a write goes to base + lane below ``cut``, to ``top`` at
    ``cut`` and nowhere above it, with ``cut`` = M - 1 - row * lanes
    clipped to [-1, lanes] for a row (its column M - 1 and past it: the
    clamped read, the dropped write; an inactive lane reads ``top``, in
    bounds, and is given 0) and 32 for a register; bit
    DESC_WRITE: a computing command writes its destination there (BANK,
    GRF_A, GRF_B, SRF; another kind is read as MRAM and written
    nowhere)."""
    img = np.asarray(img, np.int32)
    P = img.shape[1]
    lay = layout(P, len(table.rows), lanes)
    op, dst, a, b = img[0], img[1], img[2], img[3]
    compute = np.isin(op, (MOV, FILL, ADD, MUL, MAC))
    uses_b = np.isin(op, (ADD, MUL, MAC))
    reads = (compute, uses_b, op == MAC)
    out = np.zeros((3, P), np.int64)
    for i, code in enumerate((a, b, dst)):
        kind, idx = code >> 24, (code & IDX_MASK).astype(np.int64)
        r = idx & 7
        grf = np.isin(kind, (K_GRF_A, K_GRF_B))
        srf = kind == K_SRF
        mram = ~grf & ~srf
        write = compute & np.isin(kind, (K_BANK, K_GRF_A, K_GRF_B, K_SRF)) \
            if i == 2 else np.zeros(P, bool)
        used = reads[i] | write
        slot = table.slots[i].astype(np.int64)
        base = np.where(grf, lay["grf"] + ((kind - 1) * 8 + r) * 32,
                        np.where(srf, lay["srf"] + r,
                                 lay["rows"] + slot * lanes))
        cut = np.where(mram, np.clip(M - 1 - idx * lanes, -1, lanes), 32)
        mode = np.where(srf, MODE_BROADCAST, MODE_LANES)
        desc = (base | (cut + 1) << DESC_CUT | mode << DESC_MODE
                | mram.astype(np.int64) << DESC_BANK
                | write.astype(np.int64) << DESC_WRITE)
        out[i] = np.where(used, desc, 0)
    return out.astype(np.int32)


def pack_image(img: np.ndarray) -> np.ndarray:
    """(6, P) CRF image -> (P, N_FIELDS) int32: op, destination, a, b,
    target, three zero words (the global route's image)."""
    img = np.asarray(img, np.int32)
    out = np.zeros((img.shape[1], N_FIELDS), np.int32)
    out[:, :5] = img[:5].T
    return out


#: word 0 of a staged slot (``enum`` of ``W_*`` in the kernel): the op,
#: then, for a running bank, its bank accesses, the hits among them after
#: the first, the reads and the write among them, its instruction class,
#: whether it computes
W_NBANK, W_HITS, W_NRD, W_NWR, W_CLS, W_COMPUTE = 8, 10, 12, 14, 16, 19
#: KernelReport's instruction classes (``core/isa.py``)
CLS_ALU, CLS_DMA, CLS_CTRL = 0, 2, 3


def staged_image(img: np.ndarray, table: RowTable, lanes: int,
                 M: int) -> np.ndarray:
    """(6, P) CRF image -> (P, 8) int32, the resident_smem route's image:
    word 0 the op and what the slot's bank accesses give (a BANK operand
    names its row, so ``make_cmd_step``'s open-row walk over a, b and the
    destination is known but for the first access, which meets the
    bank's open row: the accesses, the hits after the first, the reads
    and the write, the class, whether the command computes; fields at
    ``W_*``), a (JUMP's trip count), the target, the a, b and
    destination descriptors (:func:`descriptors`), the first and the
    last access's rows."""
    img = np.asarray(img, np.int32)
    op, dst, a, b, tgt = (img[i] for i in range(5))
    P = img.shape[1]
    compute = np.isin(op, (MOV, FILL, ADD, MUL, MAC))
    uses_b = np.isin(op, (ADD, MUL, MAC))
    acc = [u & ((c >> 24) == K_BANK) for u, c in
           ((compute, a), (uses_b, b), (compute, dst))]
    rows = [c & IDX_MASK for c in (a, b, dst)]
    n_bank = sum(x.astype(np.int64) for x in acc)
    first = np.where(acc[0], rows[0], np.where(acc[1], rows[1], rows[2]))
    last = np.where(acc[2], rows[2], np.where(acc[1], rows[1], rows[0]))
    hits = np.zeros(P, np.int64)
    prev, seen = np.zeros(P, np.int64), np.zeros(P, bool)
    for x, r in zip(acc, rows):
        hits += x & seen & (r == prev)
        prev = np.where(x, r, prev)
        seen |= x
    cls = np.where(n_bank > 0, CLS_DMA, np.where(compute, CLS_ALU, CLS_CTRL))
    w0 = (op.astype(np.int64) & 255 | n_bank << W_NBANK | hits << W_HITS
          | (acc[0].astype(np.int64) + acc[1]) << W_NRD
          | acc[2].astype(np.int64) << W_NWR | cls << W_CLS
          | compute.astype(np.int64) << W_COMPUTE)
    out = np.zeros((P, 8), np.int32)
    out[:, 0] = w0
    out[:, 1] = a
    out[:, 2] = tgt
    out[:, 3:6] = descriptors(img, table, lanes, M).T
    out[:, 6] = np.where(n_bank > 0, first, -1)
    out[:, 7] = np.where(n_bank > 0, last, -1)
    return out


def smem_bytes(P: int, n_rows: int, W: int) -> int:
    """The resident_smem route's shared memory a block (bytes):
    :func:`layout`'s words."""
    return 4 * layout(P, n_rows, W)["words"]


def config_fields(cfg: DPUConfig, D: int, M: int, P: int, K: int,
                  H: int) -> list:
    """The int32 fields of :data:`CONFIG` a launch passes (a
    ``max_cycles`` past int32 as the int32 maximum: an int32 cycle count
    never passes either)."""
    vals = dict(D=D, M=M, P=P, K=K, H=H, xfer=xfer(cfg),
                max_cycles=min(int(cfg.max_cycles), _INT32_MAX))
    return [int(vals[n]) if n in vals else int(getattr(cfg, n))
            for n in CONFIG]


class Args(ctypes.Structure):
    """The kernel's ``struct Args``, passed by value."""

    _fields_ = [("leaf", ctypes.c_void_p * len(LEAVES)),
                ("image", ctypes.c_void_p),
                ("staged", ctypes.c_void_p),
                ("stop", ctypes.c_void_p),
                ("vote", ctypes.c_void_p),
                ("flag", ctypes.c_void_p),
                ("load", ctypes.c_void_p),
                ("store", ctypes.c_void_p),
                ("sections", ctypes.c_void_p),
                ("parity", ctypes.c_int32),
                ("n_load", ctypes.c_int32),
                ("n_store", ctypes.c_int32),
                ("rows", ctypes.c_int32),
                ("store_top", ctypes.c_int32),
                ("c", ctypes.c_int32 * len(CONFIG)),
                ("burst", ctypes.c_float)]


#: each route -> its C launcher: ``"resident_smem"``, one cooperative
#: launch a K-block, one bank a block with the image and its rows staged
#: in shared memory; ``"global"``, MRAM in device memory, a run and a tail
#: launch a K-block
LAUNCHERS = {"resident_smem": "crf_step_launch_smem",
             "global": "crf_step_launch"}

#: the kernel's library (``step_driver.StepLibrary``: the plain and the
#: ``STEP_SECTIONS`` build, its layout checked against this module's;
#: its ``smem_bytes(P, rows, W)`` is :func:`smem_bytes`)
LIB = StepLibrary(
    "crf_step", SOURCES, HEADERS,
    layout=dict(dpus_per_block=DPUS_PER_BLOCK, n_leaves=len(LEAVES),
                n_config=len(CONFIG), args_bytes=ctypes.sizeof(Args)),
    launchers=LAUNCHERS)


def library(sections: bool = False) -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library (``sections``:
    the profiling build)."""
    return LIB.load(sections)


def card_limits():
    """The current device's limits for the resident_smem route."""
    return LIB.card_limits()
