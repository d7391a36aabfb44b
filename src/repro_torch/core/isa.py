"""uPIM ISA — a faithful UPMEM-like RISC subset.

24 general-purpose registers per tasklet.  Register conventions (set at
boot, never written by the DSL register allocator):

====  ==========================
r19   constant zero
r20   dpu_id
r21   n_dpus
r22   tasklet_id
r23   n_tasklets
====  ==========================

Memory model (matches the paper's Fig. 3): loads/stores address the
scratchpad (WRAM) only; MRAM (the per-DPU DRAM bank) is reachable only via
DMA instructions — the *scratchpad-centric* model.  All addresses are byte
addresses (word aligned).  Branch targets are absolute instruction indices
(the assembler resolves labels).

Instructions are stored structure-of-arrays: (opcode, rd, ra, rb, imm,
use_imm) int32 vectors — the simulator-internal "binary" emitted by
:mod:`repro_torch.core.asm`.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class Op(IntEnum):
    # ALU: rd = op(ra, rb|imm)
    ADD = 0
    SUB = 1
    AND = 2
    OR = 3
    XOR = 4
    SLL = 5
    SRL = 6
    SRA = 7
    MUL = 8       # multi-cycle (8x8 multiplier on the real DPU)
    DIV = 9       # multi-cycle iterative divide
    SLT = 10
    SLTU = 11
    # WRAM load/store (1-cycle scratchpad)
    LW = 12       # rd = WRAM[r[ra] + imm]
    SW = 13       # WRAM[r[ra] + imm] = r[rb]
    # DMA MRAM <-> WRAM (blocks the issuing tasklet)
    LDMA = 14     # WRAM[r[ra] ...] <- MRAM[r[rb] ...], imm bytes
    SDMA = 15     # MRAM[r[rb] ...] <- WRAM[r[ra] ...], imm bytes
    # control: branch to imm
    BEQ = 16
    BNE = 17
    BLT = 18
    BGE = 19
    BLTU = 20
    BGEU = 21
    JUMP = 22
    JAL = 23      # rd = pc + 1; pc = imm
    JR = 24       # pc = r[ra]
    # synchronization (atomic region)
    ACQUIRE = 25  # busy-wait test-and-set of atomic bit imm
    RELEASE = 26  # clear atomic bit imm
    BARRIER = 27  # all live tasklets rendezvous
    # misc
    STOP = 28
    NOP = 29
    SPC = 30      # rd = special[imm]: 0 tid, 1 n_tasklets, 2 dpu_id, 3 n_dpus


N_OPS = len(Op)

# instruction classes for the paper's instruction-mix breakdown (Fig. 9)
CLS_ALU, CLS_LDST, CLS_DMA, CLS_CTRL, CLS_SYNC, CLS_MISC = range(6)
CLASS_NAMES = ("alu", "wram_ldst", "dma", "control", "sync", "misc")


def op_class(op: int) -> int:
    if op <= Op.SLTU:
        return CLS_ALU
    if op in (Op.LW, Op.SW):
        return CLS_LDST
    if op in (Op.LDMA, Op.SDMA):
        return CLS_DMA
    if Op.BEQ <= op <= Op.JR:
        return CLS_CTRL
    if op in (Op.ACQUIRE, Op.RELEASE, Op.BARRIER):
        return CLS_SYNC
    return CLS_MISC


OP_CLASS_TABLE = np.array([op_class(o) for o in range(N_OPS)], np.int32)

# which operands each opcode actually reads (for the odd/even RF hazard)
READS_RA = np.zeros(N_OPS, bool)
READS_RB = np.zeros(N_OPS, bool)
for _o in range(N_OPS):
    READS_RA[_o] = _o not in (Op.JUMP, Op.JAL, Op.ACQUIRE, Op.RELEASE,
                              Op.BARRIER, Op.STOP, Op.NOP, Op.SPC)
    READS_RB[_o] = _o in (Op.ADD, Op.SUB, Op.AND, Op.OR, Op.XOR, Op.SLL,
                          Op.SRL, Op.SRA, Op.MUL, Op.DIV, Op.SLT, Op.SLTU,
                          Op.SW, Op.LDMA, Op.SDMA, Op.BEQ, Op.BNE, Op.BLT,
                          Op.BGE, Op.BLTU, Op.BGEU)
WRITES_RD = np.zeros(N_OPS, bool)
for _o in range(N_OPS):
    WRITES_RD[_o] = (_o <= Op.SLTU) or _o in (Op.LW, Op.JAL, Op.SPC)

# special registers
R_ZERO, R_DPU, R_NDPU, R_TID, R_NT = 19, 20, 21, 22, 23
N_REGS = 24
N_ALLOC = 19  # r0..r18 available to the register allocator


@dataclass
class Instr:
    op: int
    rd: int = 0
    ra: int = 0
    rb: int = 0
    imm: int = 0
    use_imm: bool = False
    label: str = ""  # unresolved branch target (assembler fills imm)

    def __repr__(self):
        tgt = self.label or self.imm
        return (f"{Op(self.op).name} rd=r{self.rd} ra=r{self.ra} "
                f"rb=r{self.rb} imm={tgt} {'I' if self.use_imm else ''}")


@dataclass
class Binary:
    """Assembled structure-of-arrays program image."""

    opcode: np.ndarray
    rd: np.ndarray
    ra: np.ndarray
    rb: np.ndarray
    imm: np.ndarray
    use_imm: np.ndarray
    n_instrs: int
    symbols: dict  # name -> WRAM/MRAM address info

    @property
    def arrays(self):
        return (self.opcode, self.rd, self.ra, self.rb, self.imm, self.use_imm)


def assemble(instrs, labels, iram_capacity: int, symbols=None) -> Binary:
    """Resolve labels and emit SoA int32 images (padded with STOP)."""
    n = len(instrs)
    if n > iram_capacity:
        raise ValueError(
            f"program of {n} instructions exceeds IRAM capacity "
            f"{iram_capacity} (the real UPMEM linker errors here too)")
    cap = iram_capacity
    opcode = np.full(cap, int(Op.STOP), np.int32)
    rd = np.zeros(cap, np.int32)
    ra = np.zeros(cap, np.int32)
    rb = np.zeros(cap, np.int32)
    imm = np.zeros(cap, np.int32)
    use_imm = np.zeros(cap, np.int32)
    for i, ins in enumerate(instrs):
        opcode[i] = ins.op
        rd[i] = ins.rd
        ra[i] = ins.ra
        rb[i] = ins.rb
        if ins.label:
            if ins.label not in labels:
                raise KeyError(f"undefined label {ins.label!r}")
            imm[i] = labels[ins.label]
        else:
            imm[i] = np.int32(np.uint32(ins.imm & 0xFFFFFFFF))
        use_imm[i] = int(ins.use_imm)
    return Binary(opcode, rd, ra, rb, imm, use_imm, n, symbols or {})
