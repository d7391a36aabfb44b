// The HBM-PIM all-bank command step (the CRF command model), K commands
// per launch.
//
// Replaces, on the card, the eager torch step of the command model
// (repro_torch/core/hbmpim.py::make_cmd_step); the JAX reference is
// repro/core/hbmpim.py::make_cmd_step, plain jnp (no Pallas kernel).  The
// result is the eager step's, bit for bit: same int32 state, same float32
// counters, same step gating.
//
// Design:
// * one warp per bank (a simulated DPU), one lane per SIMD lane
//   (hbm_lanes <= 32): lane l holds word l of each of the 16 GRF
//   registers (GRF_A[0..7], GRF_B[0..7]) in registers, lane r < 8 holds
//   SRF[r];
// * each command: the operands decoded from its code (kind in the top
//   byte, index below), the three-access open-row timing (a, then b, then
//   the destination, each BANK operand a hit or a miss plus the burst
//   transfer), the writeback by destination kind (a bank write drops the
//   columns past the end of MRAM; a read clamps them), JUMP's single loop
//   counter, the counters;
// * the banks depend on each other only through `go` (some bank runs): a
//   bank past max_cycles that is not DONE keeps executing while another
//   bank runs.  Phase 1 steps each bank while it runs, up to K commands;
//   a vote of 2 * (steps it ran) + (still running) over the banks gives
//   G, the first step at which no bank ran; in phase 2 each bank that
//   stopped earlier takes its steps up to G (a bank that is not DONE
//   executes them); then the predicate goes to flag[parity].
//
// Two routes (ops.py picks):
// * resident_smem (crf_smem_kernel): one bank a block, one cooperative
//   launch a K-block, the two phases behind one grid barrier.  A BANK
//   operand names its row statically (the index is the code's low bits),
//   so the rows a command stream touches are known from its image: at
//   pack time crf_step.row_table lists them, and crf_step.staged_image
//   gives each slot what its bank accesses give (the open-row walk over
//   a, b and the destination is known but for the first access, which
//   meets the bank's open row) and each operand's descriptor: its word in
//   shared memory.  At the launch's start the block copies the staged
//   image and the rows into shared memory (bulk copies on an mbarrier
//   where 16-byte aligned, the rest word by word) and the GRF and SRF
//   beside them; every command then reads its three operands with one
//   load each and writes its destination with one store, all in shared
//   memory, with the bank's counters a register each, and the next
//   slot's words are loaded while a command runs.  The rows a
//   destination names go back to MRAM at the end.  A staged word is
//   indexed by its clamped column: every column at or past M - 1 reads
//   one word (`top`, MRAM's last), which only a write to column M - 1
//   itself changes, as in the reference;
// * global (crf_run_kernel, then crf_tail_kernel), where the image and
//   the rows do not fit a block's shared memory or the banks the card's
//   resident blocks: MRAM stays in device memory, read and written one
//   burst of hbm_lanes words a bank operand; two ordinary launches a
//   K-block (the run kernel votes into vote[parity]; the tail kernel
//   reads G, steps the banks that stopped early, writes the predicate and
//   clears the other parity's vote).
//
// What bounds it: a command moves at most 3 x hbm_lanes words of MRAM a
// bank; the chain of a command (decode, three reads, writeback) is a few
// dozen dependent instructions, so latency, not bytes: shared-memory
// round trips on resident_smem, L2 round trips on global; on
// resident_smem also a launch's fixed part (staging the image and rows,
// the grid barrier, the rows back).  A build with
// -DSTEP_SECTIONS sums each section's clock64() cycles
// (../../step_common.cuh; tools/torch_step_profile.py --sections).
//
// Integer arithmetic wraps through uint32_t; float32 counters use
// __fadd_rn / __fmul_rn.  Built by repro_torch/kernels/build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -shared, plain C interface)
// and called through ctypes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../../step_common.cuh"

namespace cg = cooperative_groups;
using step_common::Sections;

namespace {

// state leaves the step reads or writes (crf_step.py LEAVES)
enum Leaf {
  L_CYCLE, L_PC, L_STATUS, L_LOOP_LEFT, L_OPEN_ROW, L_GRF_A, L_GRF_B, L_SRF,
  L_MRAM, L_C_ACTIVE, L_C_IDLE_MEM, L_C_ISSUED, L_C_CLS, L_C_HIST,
  L_C_DMA_RD, L_C_DMA_WR, L_C_DMA_RD_BYTES, L_C_DMA_WR_BYTES, L_C_ROW_HIT,
  L_C_ROW_MISS, N_LEAVES
};

// sizes and configuration (crf_step.py CONFIG)
enum Cfg {
  C_D, C_W, C_M, C_P, C_K, C_H, C_MAX_CYCLES, C_HIT, C_MISS, C_XFER, N_CFG
};

// CRF opcodes and operand kinds (repro_torch/core/hbmpim.py)
enum CmdOp { NOP, EXIT, JUMP, MOV, FILL, ADD, MUL, MAC };
enum Kind { K_BANK, K_GRF_A, K_GRF_B, K_SRF };
constexpr int IDX_MASK = 0xFFFFFF;
// KernelReport's instruction classes (repro_torch/core/isa.py)
constexpr int CLS_ALU = 0, CLS_DMA = 2, CLS_CTRL = 3;

// counters held one to a lane; c_cls[i] at lane 16 + i
enum Counter {
  K_ACTIVE, K_IDLE_MEM, K_ISSUED, K_DMA_RD, K_DMA_WR, K_ROW_HIT, K_ROW_MISS,
  K_HIST1, N_COUNTERS, K_CLS = 16
};
// float counters: lane 0 c_dma_rd_bytes, lane 1 c_dma_wr_bytes
constexpr int F_RD_BYTES = 0, F_WR_BYTES = 1;

constexpr int RUN = 0, DONE = 3;
constexpr int DPB = 4;  // banks (warps) per block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  void* leaf[N_LEAVES];
  const int32_t* image;   // (P, 8): op, dst, a, b, target, 3 pad words
  // (P, 8), resident_smem: the staged image (step_staged's slot words)
  const int32_t* staged;
  // (D,): global route, steps each bank ran in this launch's phase 1;
  // resident_smem, each block's vote at the launch's end
  int32_t* stop;
  int32_t* vote;         // (2,): max over banks of 2 * stop + still running
  // (2,) in pinned host memory the card writes: the termination predicate
  // after a launch of parity p in flag[p]
  int32_t* flag;
  // resident_smem: the staged rows' copies, (n_seg, 4) int32 each: staged
  // word, MRAM word (of a bank's row), words, bulk (1: both 16-byte
  // aligned with a multiple of 4 words); `load` brings every staged word
  // below column M - 1 in, `store` takes the destination rows' back
  const int32_t* load;
  const int32_t* store;
  long long* sections;   // (N_SECTIONS,) cycle sums (STEP_SECTIONS builds)
  int32_t parity;        // which vote and flag this launch uses
  int32_t n_load, n_store;
  int32_t rows;          // resident_smem: rows staged (the table's length)
  int32_t store_top;     // resident_smem: a destination reaches word M - 1
  int32_t c[N_CFG];
  float burst;           // float32(hbm_lanes * 4)
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T* leaf(const Args& a, int i) {
  return static_cast<T*>(a.leaf[i]);
}

// This warp's bank while a launch runs.
struct Bank {
  int lane, d, W, M, P;
  bool act;           // lane < hbm_lanes
  int32_t* mram;      // this bank's row
  int cycle, pc, status, loop_left, open_row;
  int grf[16];        // lane l: GRF_A[0..7][l], GRF_B[0..7][l]
  int srf;            // lane r < 8: SRF[r]
  int cnt;
  float fcnt;
};

__device__ __forceinline__ bool bank_running(const Bank& b, const int* c) {
  return b.status != DONE && b.cycle < c[C_MAX_CYCLES];
}

// The register file's word of this lane for register `r` (0-7) of kind
// K_GRF_A or K_GRF_B: unrolled so that grf[] stays in registers.
__device__ __forceinline__ int grf_get(const Bank& b, int kind, int r) {
  const int i = (kind == K_GRF_B ? 8 : 0) + r;
  int v = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) v = k == i ? b.grf[k] : v;
  return v;
}
__device__ __forceinline__ void grf_set(Bank& b, int kind, int r, int v) {
  const int i = (kind == K_GRF_B ? 8 : 0) + r;
#pragma unroll
  for (int k = 0; k < 16; ++k) b.grf[k] = k == i ? v : b.grf[k];
}

// An operand's word for this lane (reads clamp the bank column).
__device__ __forceinline__ int read_op(const Bank& b, int code) {
  const int kind = code >> 24, idx = code & IDX_MASK, r = idx & 7;
  const int srf = __shfl_sync(FULL, b.srf, r);
  if (kind == K_GRF_A || kind == K_GRF_B) return grf_get(b, kind, r);
  if (kind == K_SRF) return srf;
  return b.act ? b.mram[clampi(wadd(wmul(idx, b.W), b.lane), 0, b.M - 1)] : 0;
}

// resident_smem: the block's shared memory (crf_step.layout): the image
// (P slots of 8 words), the GRF (GRF_A[0..7], GRF_B[0..7], a row of 32
// lanes each), the SRF (8 words), the staged rows, and `top`, MRAM's last
// word, which every column at or past M - 1 reads.
constexpr int GRF_WORDS = 16 * 32, SRF_WORDS = 8;
struct Stage {
  int32_t* words;
  int grf, srf, rows, top;  // word offsets
};
__host__ __device__ inline int stage_rows_at(int P) {
  return P * 8 + GRF_WORDS + SRF_WORDS;
}

// An operand's descriptor (crf_step.descriptors): its address in shared
// memory, the lane cut, the mode, whether only a bank's active lanes take
// part, whether a computing command writes it.
enum { D_CUT = 16, D_MODE = 22, D_BANK = 24, D_WRITE = 25 };
enum { M_NONE, M_LANES, M_BROADCAST };

// The word of the operand `desc` for this lane: lane-wise below the cut,
// `top` from it on (the clamped column), the same word in every lane
// (broadcast), 0 for an operand the command does not read or a bank's
// inactive lane.  One shared-memory load, whatever the kind.
__device__ __forceinline__ int read_desc(const Bank& b, const Stage& s,
                                         int desc) {
  const int base = desc & 0xFFFF, cut = ((desc >> D_CUT) & 63) - 1;
  const int mode = (desc >> D_MODE) & 3;
  const int at = mode == M_BROADCAST ? base
                 : b.lane < cut ? base + b.lane : s.top;
  const int v = s.words[at];
  return mode == M_NONE || ((desc >> D_BANK) & 1 && !b.act) ? 0 : v;
}

// Write this lane's `res` to the destination `desc` (a computing command
// of a running bank): lane-wise below the cut, `top` at it, nothing above
// (the columns past MRAM); a broadcast register from lane 0 (the bank's
// choice: every lane holds the same value).  One predicated store.
__device__ __forceinline__ void write_desc(const Bank& b, const Stage& s,
                                           int desc, int res, bool on) {
  const int base = desc & 0xFFFF, cut = ((desc >> D_CUT) & 63) - 1;
  const bool bc = ((desc >> D_MODE) & 3) == M_BROADCAST;
  const int at = bc ? base : b.lane < cut ? base + b.lane : s.top;
  const bool ok = bc ? b.lane == 0
                     : (!((desc >> D_BANK) & 1) || b.act) && b.lane <= cut;
  if (on && ((desc >> D_WRITE) & 1) && ok) s.words[at] = res;
}

// One command of this bank with go = true (some bank runs), the global
// route's: MRAM in device memory, the registers in registers.
__device__ void step_bank(Bank& b, const Args& args, Sections& sec) {
  const int* c = args.c;
  const int lane = b.lane, W = b.W;
  const int pc = clampi(b.pc, 0, b.P - 1);
  const int4 in = __ldg(reinterpret_cast<const int4*>(args.image + pc * 8));
  const int op = in.x, dst = in.y, a = in.z, bb = in.w;
  const int tgt = __ldg(args.image + pc * 8 + 4);
  const bool run_m = b.status == RUN;
  const bool is_mov = op == MOV || op == FILL;
  const bool is_compute = is_mov || op == ADD || op == MUL || op == MAC;
  const bool uses_b = op == ADD || op == MUL || op == MAC;
  sec.mark(step_common::S_PLAN);

  const int va = read_op(b, a), vb = read_op(b, bb), vd = read_op(b, dst);
  const int res = is_mov ? va
                  : op == ADD ? wadd(va, vb)
                  : op == MUL ? wmul(va, vb) : wadd(vd, wmul(va, vb));
  sec.mark(step_common::S_DRAM);

  // open-row timing over the command's bank accesses: a, b, destination
  int cost = 0, n_rd = 0, n_wr = 0, n_hit = 0, n_miss = 0;
  bool any_bank = false;
  int open_row = b.open_row;
  const int codes[3] = {a, bb, dst};
  const bool uses[3] = {is_compute, uses_b, is_compute};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int code = codes[s];
    const bool bk = uses[s] && (code >> 24) == K_BANK && run_m;
    const int row = code & IDX_MASK;
    const bool hit = bk && row == open_row;
    if (bk) {
      cost = wadd(cost, wadd(hit ? c[C_HIT] : c[C_MISS], c[C_XFER]));
      open_row = row;
      if (s == 2) ++n_wr; else ++n_rd;
      if (hit) ++n_hit; else ++n_miss;
      any_bank = true;
    }
  }

  // writeback by destination kind (every lane has read before any writes)
  __syncwarp();
  if (run_m && is_compute) {
    const int dkind = dst >> 24, didx = dst & IDX_MASK;
    if (dkind == K_BANK) {
      const long long col = static_cast<long long>(didx) * W + lane;
      if (b.act && col < b.M) b.mram[col] = res;   // past the end: dropped
    } else if (dkind == K_GRF_A || dkind == K_GRF_B) {
      grf_set(b, dkind, didx & 7, res);
    } else if (dkind == K_SRF) {
      const int r0 = __shfl_sync(FULL, res, 0);  // the bank's choice: uniform
      if (lane == (didx & 7)) b.srf = r0;
    }
  }
  __syncwarp();
  sec.mark(step_common::S_ISSUE);

  // control flow: JUMP's single loop counter
  const int remaining = b.loop_left >= 0 ? b.loop_left : a;
  const bool take = op == JUMP && run_m && remaining > 0;
  if (op == JUMP && run_m) b.loop_left = take ? remaining - 1 : -1;
  if (run_m) {
    b.pc = take ? tgt : wadd(b.pc, 1);
    if (op == EXIT) b.status = DONE;
    b.open_row = open_row;
  }

  const int service = run_m ? wadd(1, cost) : 0;
  const int cls = any_bank ? CLS_DMA : is_compute ? CLS_ALU : CLS_CTRL;
  const int ri = run_m ? 1 : 0;
  b.cycle = wadd(b.cycle, service);
  b.cnt = wadd(b.cnt, (lane == K_ACTIVE ? ri : 0)
                          + (lane == K_IDLE_MEM && run_m ? cost : 0)
                          + (lane == K_ISSUED && run_m ? (is_compute ? W : 1)
                                                       : 0)
                          + (lane == K_CLS + cls ? ri : 0)
                          + (lane == K_HIST1 ? ri : 0)
                          + (lane == K_DMA_RD ? n_rd : 0)
                          + (lane == K_DMA_WR ? n_wr : 0)
                          + (lane == K_ROW_HIT ? n_hit : 0)
                          + (lane == K_ROW_MISS ? n_miss : 0));
  if (lane == F_RD_BYTES)
    b.fcnt = __fadd_rn(b.fcnt, __fmul_rn(__int2float_rn(n_rd), args.burst));
  if (lane == F_WR_BYTES)
    b.fcnt = __fadd_rn(b.fcnt, __fmul_rn(__int2float_rn(n_wr), args.burst));
  sec.mark(step_common::S_CLASSIFY);
  sec.step();
}

// resident_smem: a slot of the staged image (crf_step.staged_image), 8
// words: its op and what the slot's static bank accesses give (a BANK
// operand names its row, so a, b and the destination's accesses, their
// rows and the hits after the first are known at pack time), a (JUMP's
// trip count), the target, the three operand descriptors, the first and
// the last bank access's rows.  Word 0's fields:
enum {
  W_OP = 0, W_NBANK = 8, W_HITS = 10, W_NRD = 12, W_NWR = 14, W_CLS = 16,
  W_COMPUTE = 19
};

// A bank on the resident_smem route: its scalars and each counter in a
// register of its own, the warp's alike (the global route keeps a counter
// a lane, which costs a chain of selects a command), and the next slot's
// words, loaded while a command runs (`next`: that slot, pc + 1 clamped;
// the image is read-only, so a JUMP that goes elsewhere only loads again).
struct Staged {
  int cycle, pc, status, loop_left, open_row;
  int active, idle_mem, issued, cls_alu, cls_dma, cls_ctrl, hist1, dma_rd,
      dma_wr, row_hit, row_miss;
  float rd_bytes, wr_bytes;
  int next;
  int4 nx, ny;
};

// One command of this bank with go = true, the resident_smem route's: the
// result of step_bank, bit for bit, from shared memory alone.
__device__ __forceinline__ void step_staged(Staged& g, const Bank& b,
                                            const Stage& st,
                                            const Args& args, Sections& sec) {
  const int* c = args.c;
  const int4* img = reinterpret_cast<const int4*>(st.words);
  const int pc = clampi(g.pc, 0, b.P - 1);
  int4 x = g.nx, y = g.ny;
  if (pc != g.next) x = img[2 * pc], y = img[2 * pc + 1];
  g.next = min(pc + 1, b.P - 1);
  g.nx = img[2 * g.next], g.ny = img[2 * g.next + 1];
  const int w0 = x.x, a = x.y, tgt = x.z;
  const int da = x.w, db = y.x, dd = y.y, first = y.z, last = y.w;
  const int op = (w0 >> W_OP) & 255;
  const bool run_m = g.status == RUN;
  const bool is_compute = (w0 >> W_COMPUTE) & 1;
  sec.mark(step_common::S_PLAN);

  const int va = read_desc(b, st, da), vb = read_desc(b, st, db);
  const int vd = read_desc(b, st, dd);
  const int res = op == MOV || op == FILL ? va
                  : op == ADD ? wadd(va, vb)
                  : op == MUL ? wmul(va, vb) : wadd(vd, wmul(va, vb));
  sec.mark(step_common::S_DRAM);

  // writeback (every lane has read before any writes)
  __syncwarp();
  write_desc(b, st, dd, res, run_m && is_compute);
  __syncwarp();
  sec.mark(step_common::S_ISSUE);

  // open-row timing: only the first bank access meets the open row
  const int nb = run_m ? (w0 >> W_NBANK) & 3 : 0;
  const int n_hit = nb > 0 ? (first == g.open_row) + ((w0 >> W_HITS) & 3)
                           : 0;
  const int n_miss = nb - n_hit;
  const int cost = wadd(wmul(n_hit, wadd(c[C_HIT], c[C_XFER])),
                        wmul(n_miss, wadd(c[C_MISS], c[C_XFER])));
  const int n_rd = run_m ? (w0 >> W_NRD) & 3 : 0;
  const int n_wr = run_m ? (w0 >> W_NWR) & 1 : 0;

  // control flow: JUMP's single loop counter
  const int remaining = g.loop_left >= 0 ? g.loop_left : a;
  const bool take = op == JUMP && run_m && remaining > 0;
  if (op == JUMP && run_m) g.loop_left = take ? remaining - 1 : -1;
  if (run_m) {
    g.pc = take ? tgt : wadd(g.pc, 1);
    if (op == EXIT) g.status = DONE;
    if (nb > 0) g.open_row = last;
  }
  const int ri = run_m ? 1 : 0, cls = (w0 >> W_CLS) & 7;
  g.cycle = wadd(g.cycle, run_m ? wadd(1, cost) : 0);
  g.active = wadd(g.active, ri);
  g.idle_mem = wadd(g.idle_mem, run_m ? cost : 0);
  g.issued = wadd(g.issued, run_m ? (is_compute ? b.W : 1) : 0);
  g.cls_alu = wadd(g.cls_alu, ri && cls == CLS_ALU);
  g.cls_dma = wadd(g.cls_dma, ri && cls == CLS_DMA);
  g.cls_ctrl = wadd(g.cls_ctrl, ri && cls == CLS_CTRL);
  g.hist1 = wadd(g.hist1, ri);
  g.dma_rd = wadd(g.dma_rd, n_rd);
  g.dma_wr = wadd(g.dma_wr, n_wr);
  g.row_hit = wadd(g.row_hit, n_hit);
  g.row_miss = wadd(g.row_miss, n_miss);
  g.rd_bytes = __fadd_rn(g.rd_bytes,
                         __fmul_rn(__int2float_rn(n_rd), args.burst));
  g.wr_bytes = __fadd_rn(g.wr_bytes,
                         __fmul_rn(__int2float_rn(n_wr), args.burst));
  sec.mark(step_common::S_CLASSIFY);
  sec.step();
}

// The bank's scalars and counters between the global route's layout (a
// counter a lane: Bank) and the resident_smem route's (Staged).
__device__ __forceinline__ Staged staged_of(const Bank& b) {
  Staged g;
  g.cycle = b.cycle, g.pc = b.pc, g.status = b.status;
  g.loop_left = b.loop_left, g.open_row = b.open_row;
  g.active = __shfl_sync(FULL, b.cnt, K_ACTIVE);
  g.idle_mem = __shfl_sync(FULL, b.cnt, K_IDLE_MEM);
  g.issued = __shfl_sync(FULL, b.cnt, K_ISSUED);
  g.cls_alu = __shfl_sync(FULL, b.cnt, K_CLS + CLS_ALU);
  g.cls_dma = __shfl_sync(FULL, b.cnt, K_CLS + CLS_DMA);
  g.cls_ctrl = __shfl_sync(FULL, b.cnt, K_CLS + CLS_CTRL);
  g.hist1 = __shfl_sync(FULL, b.cnt, K_HIST1);
  g.dma_rd = __shfl_sync(FULL, b.cnt, K_DMA_RD);
  g.dma_wr = __shfl_sync(FULL, b.cnt, K_DMA_WR);
  g.row_hit = __shfl_sync(FULL, b.cnt, K_ROW_HIT);
  g.row_miss = __shfl_sync(FULL, b.cnt, K_ROW_MISS);
  g.rd_bytes = __shfl_sync(FULL, b.fcnt, F_RD_BYTES);
  g.wr_bytes = __shfl_sync(FULL, b.fcnt, F_WR_BYTES);
  g.next = -1;   // nothing loaded ahead yet
  return g;
}
__device__ __forceinline__ void unstage(const Staged& g, Bank& b) {
  const int lane = b.lane;
  b.cycle = g.cycle, b.pc = g.pc, b.status = g.status;
  b.loop_left = g.loop_left, b.open_row = g.open_row;
  b.cnt = lane == K_ACTIVE ? g.active
          : lane == K_IDLE_MEM ? g.idle_mem
          : lane == K_ISSUED ? g.issued
          : lane == K_CLS + CLS_ALU ? g.cls_alu
          : lane == K_CLS + CLS_DMA ? g.cls_dma
          : lane == K_CLS + CLS_CTRL ? g.cls_ctrl
          : lane == K_HIST1 ? g.hist1
          : lane == K_DMA_RD ? g.dma_rd
          : lane == K_DMA_WR ? g.dma_wr
          : lane == K_ROW_HIT ? g.row_hit
          : lane == K_ROW_MISS ? g.row_miss : b.cnt;
  b.fcnt = lane == F_RD_BYTES ? g.rd_bytes
           : lane == F_WR_BYTES ? g.wr_bytes : b.fcnt;
}

// the int32 counter leaf of each counter lane
__device__ __forceinline__ int32_t* counter(const Args& args, int lane,
                                            int d, int H) {
  switch (lane) {
    case K_ACTIVE: return leaf<int32_t>(args, L_C_ACTIVE) + d;
    case K_IDLE_MEM: return leaf<int32_t>(args, L_C_IDLE_MEM) + d;
    case K_ISSUED: return leaf<int32_t>(args, L_C_ISSUED) + d;
    case K_DMA_RD: return leaf<int32_t>(args, L_C_DMA_RD) + d;
    case K_DMA_WR: return leaf<int32_t>(args, L_C_DMA_WR) + d;
    case K_ROW_HIT: return leaf<int32_t>(args, L_C_ROW_HIT) + d;
    case K_ROW_MISS: return leaf<int32_t>(args, L_C_ROW_MISS) + d;
    case K_HIST1: return leaf<int32_t>(args, L_C_HIST) + d * H + 1;
    default:
      if (lane >= K_CLS && lane < K_CLS + 6)
        return leaf<int32_t>(args, L_C_CLS) + d * 6 + lane - K_CLS;
      return nullptr;
  }
}

// This warp's bank: load it.  Returns false for a warp past the last bank.
__device__ bool load_bank(const Args& args, Bank& b) {
  const int* c = args.c;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (d >= c[C_D]) return false;
  const int W = c[C_W];
  b.lane = lane;
  b.d = d;
  b.W = W;
  b.M = c[C_M];
  b.P = c[C_P];
  b.act = lane < W;
  b.mram = leaf<int32_t>(args, L_MRAM) + static_cast<size_t>(d) * b.M;
  b.cycle = leaf<int32_t>(args, L_CYCLE)[d];
  b.pc = leaf<int32_t>(args, L_PC)[d];
  b.status = leaf<int32_t>(args, L_STATUS)[d];
  b.loop_left = leaf<int32_t>(args, L_LOOP_LEFT)[d];
  b.open_row = leaf<int32_t>(args, L_OPEN_ROW)[d];
  const int32_t* ga = leaf<int32_t>(args, L_GRF_A) + d * 8 * W;
  const int32_t* gb = leaf<int32_t>(args, L_GRF_B) + d * 8 * W;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    b.grf[r] = b.act ? ga[r * W + lane] : 0;
    b.grf[8 + r] = b.act ? gb[r * W + lane] : 0;
  }
  b.srf = lane < 8 ? leaf<int32_t>(args, L_SRF)[d * 8 + lane] : 0;
  const int32_t* p = counter(args, lane, d, c[C_H]);
  b.cnt = p ? *p : 0;
  b.fcnt = lane == F_RD_BYTES ? leaf<float>(args, L_C_DMA_RD_BYTES)[d]
           : lane == F_WR_BYTES ? leaf<float>(args, L_C_DMA_WR_BYTES)[d]
                                : 0.f;
  return true;
}

__device__ void store_bank(const Args& args, const Bank& b) {
  const int d = b.d, W = b.W, lane = b.lane;
  if (lane == 0) {
    leaf<int32_t>(args, L_CYCLE)[d] = b.cycle;
    leaf<int32_t>(args, L_PC)[d] = b.pc;
    leaf<int32_t>(args, L_STATUS)[d] = b.status;
    leaf<int32_t>(args, L_LOOP_LEFT)[d] = b.loop_left;
    leaf<int32_t>(args, L_OPEN_ROW)[d] = b.open_row;
  }
  if (b.act) {
    int32_t* ga = leaf<int32_t>(args, L_GRF_A) + d * 8 * W;
    int32_t* gb = leaf<int32_t>(args, L_GRF_B) + d * 8 * W;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      ga[r * W + lane] = b.grf[r];
      gb[r * W + lane] = b.grf[8 + r];
    }
  }
  if (lane < 8) leaf<int32_t>(args, L_SRF)[d * 8 + lane] = b.srf;
  int32_t* p = counter(args, lane, d, args.c[C_H]);
  if (p) *p = b.cnt;
  if (lane == F_RD_BYTES) leaf<float>(args, L_C_DMA_RD_BYTES)[d] = b.fcnt;
  if (lane == F_WR_BYTES) leaf<float>(args, L_C_DMA_WR_BYTES)[d] = b.fcnt;
}

// Global route, phase 1: each warp steps its bank while the bank runs, at
// most K steps.
__global__ void __launch_bounds__(DPB * 32) crf_run_kernel(const Args args) {
  Sections sec;
  sec.begin_launch();
  Bank b;
  if (!load_bank(args, b)) return;
  sec.mark(step_common::S_LOAD);
  const int K = args.c[C_K];
  int stop = 0;
  while (stop < K && bank_running(b, args.c)) {
    sec.start();
    step_bank(b, args, sec);
    ++stop;
  }
  const bool run_end = stop == K && bank_running(b, args.c);
  sec.start();
  store_bank(args, b);
  if (b.lane == 0) {
    args.stop[b.d] = stop;
    atomicMax(args.vote + args.parity, 2 * stop + run_end);
  }
  sec.mark(step_common::S_STORE);
  sec.end_launch(args.sections, b.lane == 0);
}

// Global route, phase 2: go was true up to step G; each bank that stopped
// earlier takes its steps up to G (one that is not DONE still executes).
// Then the predicate, and the other parity's vote cleared.
__global__ void __launch_bounds__(DPB * 32) crf_tail_kernel(const Args args) {
  const int vote = __ldcg(args.vote + args.parity);
  const int G = vote >> 1;
  const int d = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    args.flag[args.parity] = vote & 1;
    __threadfence_system();
    args.vote[args.parity ^ 1] = 0;
  }
  if (d >= args.c[C_D] || __ldcg(args.stop + d) >= G) return;
  Bank b;
  load_bank(args, b);
  Sections sec;   // not counted: the tail's steps are few
  for (int t = __ldcg(args.stop + d); t < G; ++t) step_bank(b, args, sec);
  store_bank(args, b);
}

// Bytes of the resident_smem kernel's shared memory (Stage): the image,
// the GRF, the SRF, the staged rows (rows x W words) and the top word,
// rounded up to 16 bytes.
__host__ __device__ size_t smem_route_bytes(int P, int rows, int W) {
  return 4 * ((static_cast<size_t>(stage_rows_at(P))
               + static_cast<size_t>(rows) * W + 1 + 3) & ~size_t{3});
}

// The resident_smem route: K commands of every bank, one bank a block, in
// one launch (cooperative past one bank: refused unless every block is
// resident).  The image and the bank's rows are staged in shared memory
// for the launch (Stage); phase 1, one vote over the launch behind a grid
// barrier, phase 2, the destination rows back, the predicate.
__global__ void __launch_bounds__(32, 1) crf_smem_kernel(const Args args) {
  const int* c = args.c;
  const int lane = threadIdx.x, K = c[C_K];
  const int P = c[C_P], W = c[C_W], M = c[C_M];
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ __align__(8) uint64_t s_bar;
  Sections sec;
  sec.begin_launch();
  Stage st;
  st.words = smem;
  st.grf = P * 8;
  st.srf = st.grf + GRF_WORDS;
  st.rows = stage_rows_at(P);
  st.top = st.rows + args.rows * W;
  int32_t* rows = smem + st.rows;
  int32_t* mram = leaf<int32_t>(args, L_MRAM)
                  + static_cast<size_t>(blockIdx.x) * M;

  // ---- the image and the rows into shared memory, the bank's scalars
  // into registers ----
  const uint32_t bar = step_common::smem_u32(&s_bar);
  const bool bulk_ok = ((reinterpret_cast<uintptr_t>(mram)
                         | reinterpret_cast<uintptr_t>(args.staged)) & 15)
                       == 0;
  if (lane == 0) {
    uint32_t total = bulk_ok ? 32u * P : 0u;
    const int4* seg = reinterpret_cast<const int4*>(args.load);
    for (int i = 0; i < args.n_load; ++i)
      if (seg[i].w && bulk_ok) total += 4u * seg[i].z;
    step_common::bulk_arm(bar, total);
    if (bulk_ok) {
      step_common::bulk_copy_in(bar, step_common::smem_u32(smem),
                                args.staged, 32u * P);
      for (int i = 0; i < args.n_load; ++i)
        if (seg[i].w)
          step_common::bulk_copy_in(
              bar, step_common::smem_u32(rows + seg[i].x),
              mram + seg[i].y, 4u * seg[i].z);
    }
  }
  if (!bulk_ok)
    for (int k = lane; k < P * 8; k += 32) smem[k] = args.staged[k];
  {
    const int4* seg = reinterpret_cast<const int4*>(args.load);
    for (int i = 0; i < args.n_load; ++i) {
      const int4 g = seg[i];
      if (g.w && bulk_ok) continue;
      for (int k = lane; k < g.z; k += 32) rows[g.x + k] = mram[g.y + k];
    }
  }
  if (lane == 0) smem[st.top] = mram[M - 1];
  Bank b;
  load_bank(args, b);
#pragma unroll
  for (int r = 0; r < 16; ++r) smem[st.grf + r * 32 + lane] = b.grf[r];
  if (lane < 8) smem[st.srf + lane] = b.srf;
  Staged g = staged_of(b);
  step_common::bulk_wait(bar);
  __syncwarp();
  sec.mark(step_common::S_LOAD);

  // ---- phase 1: this bank's commands while it runs ----
  const int cap = c[C_MAX_CYCLES];
  int stop = 0;
  while (stop < K && g.status != DONE && g.cycle < cap) {
    sec.start();
    step_staged(g, b, st, args, sec);
    ++stop;
  }
  const bool run_end = stop == K && g.status != DONE && g.cycle < cap;

  // ---- G and the predicate: one vote over the launch ----
  sec.start();
  int vote = 2 * stop + run_end;
  if (gridDim.x > 1) {
    if (lane == 0) args.stop[blockIdx.x] = vote;
    cg::this_grid().sync();
    int m = 0;
    for (unsigned i = lane; i < gridDim.x; i += 32)
      m = max(m, __ldcg(args.stop + i));
    vote = __reduce_max_sync(FULL, m);
  }
  const int G = vote >> 1;
  sec.mark(step_common::S_VOTE);

  // ---- phase 2: go was true up to step G ----
  for (int t = stop; t < G; ++t) {
    sec.start();
    step_staged(g, b, st, args, sec);
  }

  // ---- the destination rows and the bank's scalars back ----
  sec.start();
  const int4* seg = reinterpret_cast<const int4*>(args.store);
  if (bulk_ok) {
    step_common::bulk_store_fence();
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < args.n_store; ++i)
        if (seg[i].w)
          step_common::bulk_copy_out(
              mram + seg[i].y, step_common::smem_u32(rows + seg[i].x),
              4u * seg[i].z);
      step_common::bulk_commit();
    }
  }
  for (int i = 0; i < args.n_store; ++i) {
    const int4 g = seg[i];
    if (g.w && bulk_ok) continue;
    for (int k = lane; k < g.z; k += 32) mram[g.y + k] = rows[g.x + k];
  }
  if (args.store_top && lane == 0) mram[M - 1] = smem[st.top];
#pragma unroll
  for (int r = 0; r < 16; ++r) b.grf[r] = smem[st.grf + r * 32 + lane];
  if (lane < 8) b.srf = smem[st.srf + lane];
  unstage(g, b);
  store_bank(args, b);
  if (bulk_ok && lane == 0) step_common::bulk_store_wait();
  if (blockIdx.x == 0 && lane == 0) {
    args.flag[args.parity] = vote & 1;
    __threadfence_system();
  }
  sec.mark(step_common::S_STORE);
  sec.end_launch(args.sections, lane == 0);
}

}  // namespace

// A launch the runtime refused: the error, taken out of the runtime's
// last-error slot so that the next launch does not report it again.
static int refused(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" {

// Layout checks the Python side makes before it builds a launch.
int crf_step_dpus_per_block() { return DPB; }
int crf_step_n_leaves() { return N_LEAVES; }
int crf_step_n_config() { return N_CFG; }
int crf_step_args_bytes() { return static_cast<int>(sizeof(Args)); }

static bool args_ok(const Args* args) {
  const int W = args->c[C_W];
  return args->c[C_D] >= 1 && W >= 1 && W <= 32 && args->c[C_K] >= 1
         && args->c[C_P] >= 1 && (args->parity & ~1) == 0;
}

// Launch K commands (args->c[C_K]) of args->c[C_D] banks on `stream` by
// the global route: the run kernel and the tail kernel, DPB banks (warps)
// a block.  Returns the first cudaError_t as int.  (`args` points at a
// struct Args.)
int crf_step_launch(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  if (!args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  const int D = args->c[C_D];
  const int dpb = D < DPB ? D : DPB;
  const unsigned grid = (D + dpb - 1) / dpb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  crf_run_kernel<<<grid, dpb * 32, 0, s>>>(*args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  crf_tail_kernel<<<grid, dpb * 32, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// The resident_smem route's shared memory a block (bytes) for an image of
// P slots and `rows` staged rows of W words.
int crf_step_smem_bytes(int P, int rows, int W) {
  const size_t b = smem_route_bytes(P, rows, W);
  return b > static_cast<size_t>(INT_MAX) ? INT_MAX : static_cast<int>(b);
}

// What the current device allows the resident_smem kernel, into out[5]:
// SMs, the dynamic shared memory a block may opt in to, the shared memory
// of an SM, what a block takes besides its dynamic shared memory, and the
// kernel's blocks an SM holds with no dynamic shared memory.  Returns
// minus the cudaError_t on failure, else 0.
int crf_step_card_limits(int* out) {
  int dev = 0, reserved = 0;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out + 1,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        out + 2, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, crf_smem_kernel);
  out[3] = reserved + static_cast<int>(attr.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4,
                                                      crf_smem_kernel, 32, 0);
  return e == cudaSuccess ? 0 : -static_cast<int>(e);
}

// Let the resident_smem kernel take `bytes` of dynamic shared memory (once
// for each larger size).
static cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      crf_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// Launch K commands of args->c[C_D] banks by the resident_smem route, one
// bank a block: an ordinary launch for one bank, else a cooperative one
// (refused unless every block is resident).  Returns the cudaError_t as
// int.
int crf_step_launch_smem(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  if (!args_ok(args) || args->rows < 0 || args->n_load < 0
      || args->n_store < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = args->c[C_D];
  const size_t smem = smem_route_bytes(args->c[C_P], args->rows,
                                       args->c[C_W]);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return refused(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 1) {
    crf_smem_kernel<<<1, 32, smem, s>>>(*args);
  } else {
    Args copy = *args;
    void* params[] = {&copy};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(crf_smem_kernel), dim3(D), dim3(32),
        params, smem, s);
    if (e != cudaSuccess) return refused(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
