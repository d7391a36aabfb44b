"""Command streams that drive every branch of the CRF step, for holding
the kernel against its plain version (the card tests and
``chip_smoke.py``) and the plain version against the JAX package (the
CPU tests).

:data:`CASES` maps a name to ``(program builder, DPUConfig fields,
edit)``: every ``CmdOp`` with each operand kind (BANK, GRF_A, GRF_B,
SRF) as source and destination, on int32 data that overflows; ``JUMP``
trip counts through the single loop counter; a bank write past the last
MRAM column (dropped) and a read of it (clamped); 8 and 32 SIMD lanes;
banks that pass ``max_cycles`` beside running ones (``edit`` moves their
cycle) and keep executing; 40 banks (10 blocks) and a DPU bucket with a
padded bank.  :func:`launch` turns a case into ``(cfg, binary, srf, mram,
1)`` with seeded data and :func:`edit_of` its change of the padded initial
state, which ``repro_torch.kernels.cycle_step.cases.hold_against_plain``
takes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.config import DPUConfig
from repro_torch.core.hbmpim import CrfProgram, bank, grf_a, grf_b, srf


def _ops_prog():
    p = CrfProgram()
    p.nop()
    p.fill(grf_a(0), bank(0))
    p.fill(grf_b(1), bank(1))
    p.mov(grf_a(2), grf_b(1))
    p.mov(srf(3), bank(2))
    p.mov(bank(10), srf(3))
    p.add(grf_b(2), grf_a(0), srf(1))
    p.add(bank(11), bank(0), grf_b(2))
    p.mul(srf(4), grf_a(2), bank(3))
    p.mul(grf_a(3), srf(4), srf(2))
    p.mac(grf_a(3), bank(1), grf_b(1))
    p.mac(bank(12), grf_a(3), srf(5))
    p.mac(srf(6), srf(6), bank(4))
    p.fill(grf_b(7), bank(12))
    p.add(bank(13), grf_b(7), bank(13))    # open row: a miss, then a hit
    p.mov(bank(14), srf(6))
    p.exit_()
    return p


def _jump_prog():
    """Two loops: 1 + 4 trips, then a zero-trip JUMP (falls through), then
    1 + 2 trips over a body that spans two bank rows."""
    p = CrfProgram()
    body = p.here()
    p.add(grf_a(0), grf_a(0), srf(0))
    p.mac(grf_b(0), grf_a(0), srf(1))
    p.jump(body, 4)
    p.jump(body, 0)
    body2 = p.here()
    p.mac(bank(5), grf_b(0), srf(2))
    p.add(bank(6), bank(5), grf_a(0))
    p.jump(body2, 2)
    p.mov(bank(7), grf_a(0))
    p.exit_()
    return p


def _past_end_prog():
    """With 1,000 MRAM words and 16 lanes, row 62 holds columns 992-1007:
    the write drops the last 8, the read clamps them onto word 999."""
    p = CrfProgram()
    p.fill(grf_a(1), bank(62))
    p.add(grf_a(1), grf_a(1), srf(0))
    p.mov(bank(62), grf_a(1))
    p.fill(grf_b(1), bank(62))
    p.mov(bank(61), grf_b(1))
    p.exit_()
    return p


def _spin_prog(n=6):
    """A long loop of bank MACs (runs past a few hundred cycles)."""
    p = CrfProgram()
    body = p.here()
    p.mac(bank(3), bank(1), srf(0))
    p.mac(grf_a(1), bank(2), srf(1))
    p.jump(body, n)
    p.mov(bank(4), grf_a(1))
    p.exit_()
    return p


def _late(banks, by):
    """An edit: the given banks start ``by`` cycles before max_cycles."""
    def edit(st, cap):
        for d in banks:
            st["cycle"][d] = cap - by
    return edit


#: name -> (program builder, DPUConfig fields, edit(st, max_cycles) or None)
CASES = {
    "ops": (_ops_prog, {}, None),
    "jump": (_jump_prog, {}, None),
    "past_end": (_past_end_prog, {"mram_bytes": 4000}, None),
    "lanes_8": (_ops_prog, {"hbm_lanes": 8}, None),
    "lanes_32": (_jump_prog, {"hbm_lanes": 32}, None),
    "max_cycles": (_spin_prog, {"n_dpus": 2, "max_cycles": 600},
                   _late([0], 30)),
    "many_banks": (lambda: _spin_prog(9), {"n_dpus": 40, "max_cycles": 900},
                   _late(range(0, 40, 3), 200)),
    "padded": (_jump_prog, {"n_dpus": 3}, None),
}


def launch(name: str, seed: int = 0):
    """``(cfg, binary, srf, mram, 1)`` of case ``name``: seeded int32
    MRAM over the full range (products overflow) and SRF scalars."""
    build, kw, _ = CASES[name]
    fields = dict(n_dpus=4, mram_bytes=1 << 14, backend="hbmpim_cmd")
    fields.update(kw)
    cfg = DPUConfig(**fields)
    rng = np.random.default_rng(seed)
    D = cfg.n_dpus
    mram = rng.integers(-2**31, 2**31, (D, cfg.mram_words),
                        dtype=np.int64).astype(np.int32)
    srf0 = rng.integers(-1000, 1000, (D, 8)).astype(np.int32)
    return cfg, build().binary(cfg.hbm_crf_slots), srf0, mram, 1


def edit_of(name: str):
    """The case's edit of the padded initial state, bound to its cap (or
    None)."""
    build, kw, edit = CASES[name]
    if edit is None:
        return None
    cap = kw.get("max_cycles", DPUConfig().max_cycles)
    return lambda st: edit(st, cap)
