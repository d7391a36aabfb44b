"""Tasklet-program DSL + assembler/linker.

This replaces the paper's (UPMEM LLVM compiler + custom linker/assembler)
frontend: programs are authored against a small builder API, the assembler
resolves labels and lays out WRAM/MRAM segments, and — like the paper's
custom linker — segments can be *relocated* (the cache-vs-scratchpad case
study maps what the program thinks is WRAM onto a DRAM-backed region).

Conventions
-----------
* WRAM bytes [0, 64) are the kernel-argument area (host-written scalars),
  the analogue of UPMEM host symbols / ``dpu_push_xfer`` of scalars.
* ``r18`` is the assembler temporary; ``r0..r17`` are allocatable.
* DMA sizes: immediate, or in ``rd`` when dynamic (rd is otherwise unused
  by DMA instructions).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Union

from repro_torch.core.isa import (Binary, Instr, N_ALLOC, Op, R_DPU, R_NDPU, R_NT,
                            R_TID, R_ZERO, assemble)

R_AT = 18  # assembler temporary
ARG_BASE = 0
ARG_BYTES = 64
# cache-centric mode: data is linked above the program's static WRAM
# allocations (args + walloc statics live below this line)
CACHE_DATA_BASE = 16_384
RegOrImm = Union[int, "Reg"]


class Reg(int):
    """Register index wrapper so ints can be disambiguated as immediates."""

    def __repr__(self):
        return f"r{int(self)}"


ZERO, DPU_ID, N_DPUS, TID, N_TASKLETS = map(
    Reg, (R_ZERO, R_DPU, R_NDPU, R_TID, R_NT))


class Program:
    def __init__(self, name: str, n_tasklets: int = 16, cache_mode: bool = False):
        self.name = name
        self.n_tasklets = n_tasklets
        self.cache_mode = cache_mode
        self.instrs: List[Instr] = []
        self.labels: Dict[str, int] = {}
        self._free = list(map(Reg, range(N_ALLOC - 1)))  # r0..r17
        self._names: Dict[Reg, str] = {}
        self._wram_cursor = ARG_BYTES
        self._label_n = 0
        self.symbols: Dict[str, int] = {}

    # --- registers ---------------------------------------------------------
    def reg(self, name: str = "") -> Reg:
        if not self._free:
            raise RuntimeError(f"{self.name}: out of registers ({self._names})")
        r = self._free.pop(0)
        self._names[r] = name
        return r

    def regs(self, *names):
        return tuple(self.reg(n) for n in names)

    def free(self, *rs):
        for r in rs:
            self._names.pop(r, None)
            self._free.insert(0, r)

    # --- WRAM static allocation ---------------------------------------------
    def walloc(self, name: str, nbytes: int) -> int:
        addr = self._wram_cursor
        self._wram_cursor += (nbytes + 7) // 8 * 8
        self.symbols[name] = addr
        return addr

    @property
    def wram_used(self) -> int:
        return self._wram_cursor

    # --- emission core --------------------------------------------------------
    def _emit(self, op, rd=0, ra=0, rb=0, imm=0, use_imm=False, label=""):
        self.instrs.append(Instr(int(op), int(rd), int(ra), int(rb),
                                 int(imm), use_imm, label))

    def _b(self, op, rd, ra, b: RegOrImm):
        if isinstance(b, Reg):
            self._emit(op, rd, ra, b)
        else:
            self._emit(op, rd, ra, 0, imm=b, use_imm=True)

    # --- ALU -----------------------------------------------------------------
    def add(self, rd, ra, b): self._b(Op.ADD, rd, ra, b)
    def sub(self, rd, ra, b): self._b(Op.SUB, rd, ra, b)
    def and_(self, rd, ra, b): self._b(Op.AND, rd, ra, b)
    def or_(self, rd, ra, b): self._b(Op.OR, rd, ra, b)
    def xor(self, rd, ra, b): self._b(Op.XOR, rd, ra, b)
    def sll(self, rd, ra, b): self._b(Op.SLL, rd, ra, b)
    def srl(self, rd, ra, b): self._b(Op.SRL, rd, ra, b)
    def sra(self, rd, ra, b): self._b(Op.SRA, rd, ra, b)
    def mul(self, rd, ra, b): self._b(Op.MUL, rd, ra, b)
    def div(self, rd, ra, b): self._b(Op.DIV, rd, ra, b)
    def slt(self, rd, ra, b): self._b(Op.SLT, rd, ra, b)
    def sltu(self, rd, ra, b): self._b(Op.SLTU, rd, ra, b)

    def li(self, rd, value: int):
        self._b(Op.ADD, rd, R_ZERO, int(value))

    def mv(self, rd, ra):
        self._emit(Op.ADD, rd, ra, R_ZERO)

    # --- memory ----------------------------------------------------------------
    def lw(self, rd, ra, offset=0):
        self._emit(Op.LW, rd, ra, 0, imm=offset)

    def sw(self, ra, offset, rb):
        self._emit(Op.SW, 0, ra, rb, imm=offset)

    def load_arg(self, rd, idx: int):
        self._emit(Op.LW, rd, R_ZERO, 0, imm=ARG_BASE + 4 * idx)

    def ldma(self, wram_reg, mram_reg, size: RegOrImm):
        if isinstance(size, Reg):
            self._emit(Op.LDMA, size, wram_reg, mram_reg, use_imm=False)
        else:
            self._emit(Op.LDMA, 0, wram_reg, mram_reg, imm=size, use_imm=True)

    def sdma(self, wram_reg, mram_reg, size: RegOrImm):
        if isinstance(size, Reg):
            self._emit(Op.SDMA, size, wram_reg, mram_reg, use_imm=False)
        else:
            self._emit(Op.SDMA, 0, wram_reg, mram_reg, imm=size, use_imm=True)

    # --- control -------------------------------------------------------------
    def newlabel(self, stem="L") -> str:
        self._label_n += 1
        return f".{stem}{self._label_n}"

    def label(self, name: str):
        self.labels[name] = len(self.instrs)

    def _branch(self, op, ra, b: RegOrImm, target: str):
        if not isinstance(b, Reg):
            self.li(Reg(R_AT), b)
            b = Reg(R_AT)
        self._emit(op, 0, ra, b, label=target)

    def beq(self, ra, b, target): self._branch(Op.BEQ, ra, b, target)
    def bne(self, ra, b, target): self._branch(Op.BNE, ra, b, target)
    def blt(self, ra, b, target): self._branch(Op.BLT, ra, b, target)
    def bge(self, ra, b, target): self._branch(Op.BGE, ra, b, target)
    def bltu(self, ra, b, target): self._branch(Op.BLTU, ra, b, target)
    def bgeu(self, ra, b, target): self._branch(Op.BGEU, ra, b, target)

    def jump(self, target: str):
        self._emit(Op.JUMP, label=target)

    def stop(self):
        self._emit(Op.STOP)

    def nop(self):
        self._emit(Op.NOP)

    # --- sync ------------------------------------------------------------------
    def acquire(self, mutex_id: int):
        self._emit(Op.ACQUIRE, imm=mutex_id)

    def release(self, mutex_id: int):
        self._emit(Op.RELEASE, imm=mutex_id)

    def barrier(self):
        self._emit(Op.BARRIER)

    # --- structured helpers ------------------------------------------------------
    @contextmanager
    def for_range(self, i: Reg, start: RegOrImm, stop: RegOrImm, step: int = 1):
        """for i in range(start, stop, step) — stop may be a register."""
        if isinstance(start, Reg):
            self.mv(i, start)
        else:
            self.li(i, start)
        top, end = self.newlabel("for"), self.newlabel("endfor")
        self.label(top)
        self.bge(i, stop, end)
        yield end
        self.add(i, i, step)
        self.jump(top)
        self.label(end)

    @contextmanager
    def while_lt(self, ra: Reg, b: RegOrImm):
        top, end = self.newlabel("wh"), self.newlabel("endwh")
        self.label(top)
        self.bge(ra, b, end)
        yield end
        self.jump(top)
        self.label(end)

    # --- finalize ---------------------------------------------------------------
    def binary(self, iram_capacity: int = 4096) -> Binary:
        if not self.instrs or self.instrs[-1].op != Op.STOP:
            self.stop()
        return assemble(self.instrs, self.labels, iram_capacity, self.symbols)
