// The simulator's 12-way int32 ALU as one device function.
//
// Replaces the Pallas TPU kernel repro/kernels/alu_exec/alu_exec.py
// (_alu_kernel / alu_exec_2d) and mirrors the engine's jnp twin
// repro/core/engine.py::alu_exec.  Kept in a header so that a fused
// cycle-step kernel can call it per simulated issue slot.
//
// Contract (the Pallas kernel's, alu_exec.py:47):
//   0 ADD  1 SUB  2 AND  3 OR  4 XOR  5 SLL  6 SRL  7 SRA
//   8 MUL  9 DIV (truncating; x/0 -> -1; INT_MIN/-1 -> INT_MIN)
//   10 SLT  11 SLTU; shift amounts masked to 5 bits;
//   0 for an opcode outside [0, 12).
// Wrapping arithmetic and logical shifts go through uint32_t, where C++
// defines them; signed overflow and INT_MIN/-1 are never evaluated.
#pragma once

#include <cstdint>

__device__ __forceinline__ int32_t alu_exec_one(int32_t op, int32_t a,
                                                int32_t b) {
  const uint32_t au = static_cast<uint32_t>(a);
  const uint32_t bu = static_cast<uint32_t>(b);
  const uint32_t sh = bu & 31u;
  switch (op) {
    case 0: return static_cast<int32_t>(au + bu);
    case 1: return static_cast<int32_t>(au - bu);
    case 2: return a & b;
    case 3: return a | b;
    case 4: return a ^ b;
    case 5: return static_cast<int32_t>(au << sh);
    case 6: return static_cast<int32_t>(au >> sh);
    case 7: return a >> sh;  // arithmetic shift of a signed value
    case 8: return static_cast<int32_t>(au * bu);
    case 9:
      if (b == 0) return -1;
      if (a == INT32_MIN && b == -1) return INT32_MIN;
      return a / b;  // C++ division truncates toward zero
    case 10: return a < b ? 1 : 0;
    case 11: return au < bu ? 1 : 0;
    default: return 0;
  }
}
