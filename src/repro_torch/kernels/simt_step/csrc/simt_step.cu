// The SIMT vector DPU's cycle step (case study #1, Fig. 11), K steps per
// launch, every lane's ALU on alu_exec_one (../../alu_exec/csrc/alu_exec.cuh).
//
// Replaces, on the card, the eager torch step of the SIMT engine
// (repro_torch/core/simt.py::make_step_traced, a few hundred small kernels
// a step); the JAX reference is repro/core/simt.py::make_step_traced,
// whose ALU is repro.core.engine.alu_exec, the jnp mirror of the Pallas
// kernel repro/kernels/alu_exec/alu_exec.py (_alu_kernel).  It also runs
// the HBM-PIM all-bank compat target (one simulated warp as wide as the
// tasklet set, coalescing on).  The result is the eager step's, bit for
// bit: same int32 state, same float32 counters, same step gating.
//
// Design (after cycle_step.cu):
// * one CUDA warp per simulated DPU, one lane per tasklet (T <= 32); a
//   simulated warp of W = simt_width tasklets is W consecutive lanes, so
//   its ready vote, min PC, first active lane and the coalescer's row
//   match are warp votes, reductions and __match_any_sync;
// * each tasklet's scalars live in its lane's registers for the K steps,
//   each DPU's scalars in every lane, warp w's next issue cycle in lane w,
//   the counters one to a lane; the register file in shared memory; WRAM,
//   MRAM and the atomics stay in device memory;
// * colliding stores resolve as the plain version (XLA's CPU scatter)
//   does: the last lane wins.  SW: the highest lane of each group of lanes
//   that store to one word stores.  DMA: the warp copies the DMA lanes'
//   windows one lane after another, in lane order, and within a window
//   only the last word of a run clipped onto the first or last word
//   writes;
// * DPUs depend on each other only through `go` (some DPU runs): the copy
//   window is a fixed 512 words, not the other DPUs' widest DMA.  So no
//   DPU ever waits for another.  A launch is two ordinary kernels (no
//   cooperative launch, so any DPU count): simt_run_kernel steps each DPU
//   while it runs (then go is true whatever the others do), up to K
//   steps, and votes 2 * (steps it ran) + (still running) into
//   vote[parity] (atomicMax); simt_tail_kernel reads G = vote >> 1, the
//   first step at which no DPU ran, and gives each DPU that stopped
//   earlier its steps up to G with go = true and nothing to issue (it
//   still retires DMAs and releases barriers), then writes the predicate
//   (vote & 1) into flag[parity] (pinned host memory) and clears the
//   other parity's vote for the next launch;
//
// * the resident_smem route (simt_smem_kernel), the main path's where a
//   DPU's rows fit (396 DPUs of 64 KiB WRAM on an H100): one DPU a
//   block, its WRAM row and atomics in shared memory for the launch (one
//   bulk copy in, one out), the tail folded in (one vote over the launch
//   at a grid barrier: a cooperative launch), shifts and masks for the
//   power-of-two divisors, and a DMA step's windows copied all at once
//   (each lane's words loaded before any is stored) when each lies inside
//   its memory and ends before the next DMA lane's begins: then no word
//   is written twice and none is clipped, so the order cannot matter;
//   otherwise lane after lane as above, a window's words loaded before
//   any is stored.  The two kernels above are the global route.
//
// What bounds it: not bytes (a 64-DPU rank's state is well under a MB,
// read and written once a launch, plus the words its DMAs copy) but the
// serial chain of each step, a few hundred dependent instructions and
// shared/L2 accesses, as for cycle_step.
//
// Integer arithmetic wraps through uint32_t; floor division and remainder
// are torch's (floor); float32 counters use __fadd_rn / __fmul_rn so that
// nothing is contracted into an FMA.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared, plain C interface) and called
// through ctypes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../../alu_exec/csrc/alu_exec.cuh"
#include "../../step_common.cuh"

namespace cg = cooperative_groups;

namespace {

using step_common::Sections;

// state leaves the step reads or writes (simt_step.py LEAVES)
enum Leaf {
  L_CYCLE, L_PC, L_REGS, L_STATUS, L_NEXT_ISSUE, L_RR, L_WRAM, L_MRAM,
  L_ATOMIC, L_REQ_VALID, L_REQ_MRAM, L_REQ_BYTES, L_REQ_ENQ, L_REQ_SERVICE,
  L_ENG_ACTIVE, L_ENG_THREAD, L_ENG_FINISH, L_OPEN_ROW, L_WARP_NEXT,
  L_C_ACTIVE, L_C_IDLE_MEM, L_C_IDLE_REV, L_C_ISSUED, L_C_CLS, L_C_HIST,
  L_C_DMA_RD, L_C_DMA_WR, L_C_DMA_RD_BYTES, L_C_DMA_WR_BYTES, L_C_ROW_HIT,
  L_C_ROW_MISS, L_C_ACQ_RETRY, N_LEAVES
};

// sizes and configuration (simt_step.py CONFIG)
enum Cfg {
  C_D, C_T, C_SW, C_W, C_M, C_A, C_P, C_K, C_MAX_CYCLES, C_ROW_BYTES,
  C_ROW_MISS, C_COALESCING, C_MUL_EXTRA, C_DIV_EXTRA, C_SKIP, N_CFG
};

// the decoded instruction image: 8 int32 per slot (simt.decode_image)
enum Field { F_OP, F_RD, F_RA, F_RB, F_IMM, F_UI, F_WRD, F_CLS, N_FIELDS };

// the ISA's opcodes the step tests (repro_torch/core/isa.py Op)
enum Op {
  OP_SLTU = 11, OP_LW = 12, OP_SW = 13, OP_LDMA = 14, OP_SDMA = 15,
  OP_BEQ = 16, OP_BNE = 17, OP_BLT = 18, OP_BGE = 19, OP_BLTU = 20,
  OP_BGEU = 21, OP_JUMP = 22, OP_JAL = 23, OP_JR = 24, OP_ACQUIRE = 25,
  OP_RELEASE = 26, OP_BARRIER = 27, OP_STOP = 28
};
constexpr int OP_MUL = 8, OP_DIV = 9;

// counters held one to a lane (lane = index); c_cls[i] at lane 16 + i
enum Counter {
  K_ACTIVE, K_IDLE_MEM, K_IDLE_REV, K_ISSUED, K_DMA_RD, K_DMA_WR, K_ROW_HIT,
  K_ROW_MISS, K_ACQ_RETRY, N_COUNTERS, K_CLS = 16
};
__constant__ int kCounterLeaf[N_COUNTERS] = {
    L_C_ACTIVE, L_C_IDLE_MEM, L_C_IDLE_REV, L_C_ISSUED, L_C_DMA_RD,
    L_C_DMA_WR, L_C_ROW_HIT, L_C_ROW_MISS, L_C_ACQ_RETRY};
// float counters: lane 0 c_dma_rd_bytes, lane 1 c_dma_wr_bytes
constexpr int F_RD_BYTES = 0, F_WR_BYTES = 1;

constexpr int RUN = 0, BLK_DMA = 1, BLK_BAR = 2, DONE = 3;
constexpr int INF = 1 << 30;
constexpr int NREGS = 24;
constexpr int MAX_DMA_BYTES = 2048;
constexpr int DPB = 4;  // DPUs (warps) per block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  void* leaf[N_LEAVES];
  const int32_t* image;  // (P, N_FIELDS)
  // (D,): steps each DPU ran in this launch's phase 1 (global route); the
  // per-block votes before the grid barrier (resident_smem route)
  int32_t* stop;
  int32_t* vote;         // (2,): max over DPUs of 2 * stop + still running
  // (2,) in pinned host memory the card writes: the termination predicate
  // after a launch of parity p in flag[p]
  int32_t* flag;
  long long* sections;   // (N_SECTIONS,) cycle sums (STEP_SECTIONS builds)
  int32_t parity;        // which vote and flag this launch uses
  int32_t c[N_CFG];
  float inv_bw;          // float32(1) / float32(the DMA bandwidth)
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
// torch.div(x, d, rounding_mode="floor") for d > 0
__device__ __forceinline__ int floordiv(int x, int d) {
  int q = x / d;
  if (x % d != 0 && x < 0) --q;
  return q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// first lane of the minimum / maximum over lanes with act (torch's ties)
__device__ __forceinline__ int argmin_first(int key, bool act) {
  const int v = act ? key : INT_MAX;
  const int m = __reduce_min_sync(FULL, v);
  return __ffs(__ballot_sync(FULL, act && v == m)) - 1;
}
__device__ __forceinline__ int argmax_first(int key, bool act) {
  const int v = act ? key : INT_MIN;
  const int m = __reduce_max_sync(FULL, v);
  return __ffs(__ballot_sync(FULL, act && v == m)) - 1;
}

template <typename T>
__device__ __forceinline__ T* leaf(const Args& a, int i) {
  return static_cast<T*>(a.leaf[i]);
}

struct Instr {
  int op, rd, ra, rb, imm, ui, wrd, cls;
};

__device__ __forceinline__ Instr fetch(const int32_t* image, int p) {
  const int4* row = reinterpret_cast<const int4*>(image + p * N_FIELDS);
  const int4 x = __ldg(row), y = __ldg(row + 1);
  return Instr{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
}

// This warp's DPU while a launch runs.
struct Dpu {
  // per tasklet (lane)
  int pc, status, next_issue, req_mram, req_bytes, req_enq, req_service;
  bool req_valid;
  // per DPU (every lane)
  int cycle, rr, eng_thread, eng_finish, open_row;
  bool eng_active;
  int warp_next;  // lane w: warp w's
  int cnt, hist, hist32;
  float fcnt;
};

struct Warp {
  int lane, d, T, SW, nW, W, M, P;
  bool act;
  int32_t* wram;    // this DPU's row (in shared memory on resident_smem)
  int32_t* mram;
  int32_t* sregs;   // the register file, in shared memory
  int32_t* atomic;  // resident_smem: this DPU's atomics, in shared memory
  // resident_smem: log2 of simt_width, of the warp count and of row_bytes
  // where they are powers of two, else -1
  int sh_SW, sh_nW, sh_row;
};

// floor division and remainder of step_dpu: by shift and mask on the
// resident_smem route where the divisor is a power of two
template <bool kSmem>
__device__ __forceinline__ int fdiv(int x, int d, int sh) {
  if constexpr (kSmem) return step_common::floordiv_p2(x, d, sh);
  else return floordiv(x, d);
}

constexpr int WIN_REGS = MAX_DMA_BYTES / 4 / 32;  // a window's words a lane
constexpr int FLAT_B = 8;  // words a lane loads before it stores (flat copy)

// A DMA source word: WRAM (shared memory on resident_smem) for a store to
// MRAM, else MRAM, through L2 only (it streams; L1 keeps the image).  The
// index is clamped into the row, so the load needs no test.
__device__ __forceinline__ int load_src(const int32_t* src, int i,
                                        bool from_wram) {
  return from_wram ? src[i] : __ldcg(src + i);
}

__device__ __forceinline__ bool dpu_running(const Dpu& u, const Warp& w,
                                            const int* c) {
  return __any_sync(FULL, w.act && u.status != DONE)
         && u.cycle < c[C_MAX_CYCLES];
}

// One simulated cycle of this DPU with go = true (some DPU runs):
// the DRAM engine, the barrier release, the issue of one ready warp (none
// when the DPU itself has stopped: `running` false) and the cycle's
// classification.  kSmem: the resident_smem route (WRAM and the atomics
// in shared memory, the DMA copy in parallel where the order cannot
// matter).
template <bool kSmem>
__device__ void step_dpu(Dpu& u, const Warp& w, const Args& args,
                         bool running, Sections& sec) {
  const int* c = args.c;
  const int lane = w.lane, T = w.T, SW = w.SW, nW = w.nW;
  const bool act = w.act;
  const int cyc = u.cycle;
  const int my_warp = kSmem ? fdiv<true>(lane, SW, w.sh_SW) : lane / SW;
  sec.start();

  // ---- DRAM engine: completion wakes the leader's warp, FR-FCFS ----
  if (u.eng_active && u.eng_finish <= cyc) {
    if (act && my_warp == u.eng_thread / SW && u.status == BLK_DMA) {
      u.status = RUN;
      u.next_issue = wadd(cyc, 1);
    }
    if (lane == u.eng_thread) u.req_valid = false;
    u.eng_active = false;
  }
  if (!u.eng_active && __any_sync(FULL, act && u.req_valid)) {
    const int row = fdiv<kSmem>(u.req_mram, c[C_ROW_BYTES], w.sh_row);
    const int score = u.req_valid ? wsub(row == u.open_row ? INF : 0,
                                         u.req_enq)
                                  : -INF;
    const int j = argmax_first(score, act);
    const int service = __shfl_sync(FULL, u.req_service, j);
    const int m_j = __shfl_sync(FULL, u.req_mram, j);
    const int b_j = __shfl_sync(FULL, u.req_bytes, j);
    const bool hit_j = __shfl_sync(FULL, row, j) == u.open_row;
    u.eng_active = true;
    u.eng_thread = j;
    u.eng_finish = wadd(cyc, service);
    u.open_row = fdiv<kSmem>(wsub(wadd(m_j, b_j < 1 ? 1 : b_j), 1),
                             c[C_ROW_BYTES], w.sh_row);
    u.cnt = wadd(u.cnt, (lane == K_ROW_HIT && hit_j)
                            + (lane == K_ROW_MISS && !hit_j));
  }

  // ---- barrier release (all live lanes arrived) ----
  {
    const unsigned bar = __ballot_sync(FULL, act && u.status == BLK_BAR);
    const unsigned alive = __ballot_sync(FULL, act && u.status != DONE);
    if (bar != 0 && __popc(bar) == __popc(alive) && act
        && u.status == BLK_BAR)
      u.status = RUN;
  }
  sec.mark(step_common::S_DRAM);

  // ---- warp selection: lane l < nW speaks for simulated warp l ----
  const unsigned blk = __ballot_sync(
      FULL, act && (u.status == BLK_DMA || u.status == BLK_BAR));
  const unsigned runm = __ballot_sync(FULL, act && u.status == RUN);
  const unsigned wmask0 = SW == 32 ? FULL : (1u << SW) - 1u;
  const bool is_w = lane < nW;
  const unsigned lw_mask = is_w ? wmask0 << (lane * SW) : 0u;
  const int n_run = __popc(runm & lw_mask);
  const bool runnable = is_w && n_run > 0 && (blk & lw_mask) == 0;
  const bool ready = runnable && u.warp_next <= cyc && running;
  const int n_ready0 = __reduce_add_sync(FULL, ready ? n_run : 0);
  int wsel;
  bool valid;
  if constexpr (kSmem) {
    // the first ready warp from rr on, round robin (argmin_first of the
    // priority (lane - rr) mod nW, from one ballot); warp 0 if none
    const unsigned rb = __ballot_sync(FULL, ready);
    const unsigned hi = rb >> u.rr, lo = rb & ((1u << u.rr) - 1u);
    wsel = hi ? u.rr + __ffs(hi) - 1 : lo ? __ffs(lo) - 1 : 0;
    valid = rb != 0;
  } else {
    int prio = (lane - u.rr) % (nW > 0 ? nW : 1);
    if (prio < 0) prio += nW;
    wsel = argmin_first(ready ? prio : INF, is_w);
    valid = __any_sync(FULL, ready);
  }

  // ---- the selected warp's lanes at its minimum PC ----
  const bool in_warp = act && my_warp == wsel;
  const int warp_pc = __reduce_min_sync(
      FULL, in_warp && u.status == RUN ? u.pc : INF);
  const bool active = valid && in_warp && u.status == RUN
                      && u.pc == warp_pc;
  const unsigned amask = __ballot_sync(FULL, active);
  const int n_active = __popc(amask);
  const int first = amask ? __ffs(amask) - 1 - wsel * SW : 0;
  const int leader = wsel * SW + first;

  bool acq_stall = false, do_dma = false, is_sdma = false;
  int size = 0, cls = 0, op = -1;
  int dma_lanes = 0, dma_bytes = 0;  // the DMA lanes and their bytes
  if (valid) {  // uniform across the warp
    const Instr in = fetch(args.image, clampi(warp_pc, 0, w.P - 1));
    op = in.op;
    cls = in.cls;
    int32_t* rf = w.sregs + (act ? lane : 0) * NREGS;
    const int a = act ? rf[in.ra] : 0;
    const int breg = act ? rf[in.rb] : 0;
    const int b = in.ui ? in.imm : breg;
    const int addr = wadd(a, in.imm);
    const int widx = clampi(addr >> 2, 0, w.W - 1);
    const int ldval = (act && op == OP_LW) ? w.wram[widx] : 0;
    const int res = op <= OP_SLTU ? alu_exec_one(op, a, b)
                    : op == OP_LW ? ldval : wadd(warp_pc, 1);
    const int aidx = clampi(in.imm, 0, c[C_A] - 1);
    int32_t* at = kSmem ? w.atomic + aidx
                        : leaf<int32_t>(args, L_ATOMIC)
                              + static_cast<size_t>(w.d) * c[C_A] + aidx;
    const int aold = *at;
    // every lane has read before any lane writes
    __syncwarp();
    if (active && in.wrd) rf[in.rd] = res;

    // (op is the warp's: on resident_smem the warp votes of an
    // instruction are taken only where the instruction has them)
    // SW: of the lanes that store to one word, the highest stores
    if (!kSmem || op == OP_SW) {
      const bool do_sw = active && op == OP_SW;
      const unsigned same = __match_any_sync(
          FULL, do_sw ? static_cast<unsigned long long>(
                            static_cast<uint32_t>(widx))
                      : (1ull << 32) + lane);
      if (do_sw && 31 - __clz(same) == lane) w.wram[widx] = breg;
    }

    // atomics: lane-serialised, the first active lane may acquire
    if (!kSmem || op == OP_ACQUIRE || op == OP_RELEASE) {
      const bool is_acq = op == OP_ACQUIRE;
      const bool acq_ok = active && is_acq && lane == leader && aold == 0;
      acq_stall = active && is_acq && !acq_ok;
      const bool acq_any = __any_sync(FULL, acq_ok);
      const bool rel_any = __any_sync(FULL, active && op == OP_RELEASE);
      if (lane == 0 && (acq_any || rel_any)) *at = acq_any ? 1 : 0;
    }

    // DMA: merge the lanes' requests (coalescer), copy now (a valid issue
    // has an active lane: the warp's minimum PC is some RUN lane's)
    do_dma = active && (op == OP_LDMA || op == OP_SDMA);
    is_sdma = op == OP_SDMA;
    if (kSmem ? op == OP_LDMA || op == OP_SDMA : __any_sync(FULL, do_dma)) {
      sec.mark(step_common::S_ISSUE);
      __syncwarp();
      const int sz = in.ui ? in.imm : (act ? rf[in.rd] : 0);
      size = do_dma ? clampi(sz, 0, MAX_DMA_BYTES) : 0;
      const int total = __reduce_add_sync(FULL, size);
      if constexpr (kSmem) {
        dma_lanes = __popc(__ballot_sync(FULL, do_dma));
        dma_bytes = total;
      }
      int n_act;
      if (c[C_COALESCING]) {
        // one activate per unique row among the lanes
        const unsigned long long key =
            do_dma ? static_cast<unsigned long long>(static_cast<uint32_t>(
                         fdiv<kSmem>(breg, c[C_ROW_BYTES], w.sh_row)))
                   : (1ull << 32) + lane;
        const unsigned grp = __match_any_sync(FULL, key);
        n_act = __popc(__ballot_sync(FULL, do_dma && __ffs(grp) - 1 == lane));
      } else {
        n_act = kSmem ? dma_lanes : __popc(__ballot_sync(FULL, do_dma));
      }
      const int transfer = static_cast<int>(ceilf(__fmul_rn(
          __int2float_rn(total), args.inv_bw)));
      const int service = wadd(wmul(n_act, c[C_ROW_MISS]), transfer);
      const int m_lead = __shfl_sync(FULL, breg, leader);
      if (lane == leader) {
        u.req_valid = true;
        u.req_mram = m_lead;
        u.req_bytes = total;
        u.req_enq = cyc;
        u.req_service = service;
      }
      // the copy: each DMA lane's window in lane order; within a window
      // the last word clipped onto the first or last word writes
      const int n = (size + 3) >> 2;
      const int dst_b = (is_sdma ? breg : a) >> 2;
      const int src_b = (is_sdma ? a : breg) >> 2;
      int32_t* dst = is_sdma ? w.mram : w.wram;
      const int32_t* src = is_sdma ? w.wram : w.mram;
      const int dtop = (is_sdma ? w.M : w.W) - 1;
      const int stop_ = (is_sdma ? w.W : w.M) - 1;
      const bool mine = do_dma && n > 0;
      unsigned lanes_left = __ballot_sync(FULL, mine);
      bool flat = false;
      if constexpr (kSmem) {
        // In lane order the copies can only differ from one flat copy
        // where two windows share a word or one is clipped onto an end
        // word (source and destination lie in different memories).  So:
        // when every window lies inside its memory and each ends before
        // the next DMA lane's begins, copy them all at once.
        const unsigned later = lane == 31 ? 0u
                                          : lanes_left & (~0u << (lane + 1));
        const int nxt = later ? __ffs(later) - 1 : lane;
        const int next_db = __shfl_sync(FULL, dst_b, nxt);
        flat = __all_sync(FULL, !mine || (dst_b >= 0 && dst_b + n - 1 <= dtop
                                          && (!later || dst_b + n <= next_db)));
      }
      if (flat) {
        // word g of the windows laid end to end, in lane order, is word
        // g - off[m] of lane m's, m the last lane with off[m] <= g
        const int nn = mine ? n : 0;
        int incl = nn;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        const int off = incl - nn;
        const int total = __shfl_sync(FULL, incl, 31);
        for (int g0 = 0; g0 < total; g0 += 32 * FLAT_B) {
          int val[FLAT_B], at_[FLAT_B];
#pragma unroll
          for (int j = 0; j < FLAT_B; ++j) {
            const int g = g0 + 32 * j + lane;
            int m = 0;
#pragma unroll
            for (int step = 16; step >= 1; step >>= 1)
              if (__shfl_sync(FULL, off, m + step) <= g) m += step;
            const int k = g - __shfl_sync(FULL, off, m);
            const int db = __shfl_sync(FULL, dst_b, m);
            const int sb = __shfl_sync(FULL, src_b, m);
            at_[j] = g < total ? db + k : -1;
            val[j] = load_src(src, clampi(sb + k, 0, stop_), is_sdma);
          }
#pragma unroll
          for (int j = 0; j < FLAT_B; ++j)
            if (at_[j] >= 0) dst[at_[j]] = val[j];
        }
        __syncwarp();
        lanes_left = 0;
      }
      while (lanes_left) {
        const int m = __ffs(lanes_left) - 1;
        lanes_left &= lanes_left - 1;
        const int nm = __shfl_sync(FULL, n, m);
        const int db = __shfl_sync(FULL, dst_b, m);
        const int sb = __shfl_sync(FULL, src_b, m);
        const int low = min(nm - 1, -db);
        if constexpr (kSmem) {
          // the window's words loaded before any is stored
          int val[WIN_REGS];
#pragma unroll
          for (int i = 0; i < WIN_REGS; ++i)
            val[i] = load_src(src, clampi(sb + lane + 32 * i, 0, stop_),
                              is_sdma);
#pragma unroll
          for (int i = 0; i < WIN_REGS; ++i) {
            const int k = lane + 32 * i;
            if (k >= nm) continue;
            const int t = clampi(db + k, 0, dtop);
            const bool win = t == dtop ? k == nm - 1
                                       : (t == 0 ? k == low : true);
            if (win) dst[t] = val[i];
          }
        } else {
          for (int k = lane; k < nm; k += 32) {
            const int t = clampi(db + k, 0, dtop);
            const bool win = t == dtop ? k == nm - 1 : (t == 0 ? k == low
                                                                  : true);
            if (win) dst[t] = src[clampi(sb + k, 0, stop_)];
          }
        }
        __syncwarp();
      }
      sec.mark(step_common::S_DMA);
    }

    // control flow / status
    bool taken;
    switch (op) {
      case OP_BEQ: taken = a == b; break;
      case OP_BNE: taken = a != b; break;
      case OP_BLT: taken = a < b; break;
      case OP_BGE: taken = a >= b; break;
      case OP_BLTU:
        taken = static_cast<uint32_t>(a) < static_cast<uint32_t>(b);
        break;
      case OP_BGEU:
        taken = static_cast<uint32_t>(a) >= static_cast<uint32_t>(b);
        break;
      default: taken = false;
    }
    const int pc1 = wadd(warp_pc, 1);
    const int new_pc = (op >= OP_BEQ && op <= OP_BGEU) ? (taken ? in.imm : pc1)
                       : (op == OP_JUMP || op == OP_JAL) ? in.imm
                       : op == OP_JR ? a
                       : (acq_stall || op == OP_STOP) ? warp_pc : pc1;
    if (active) u.pc = new_pc;
    if (active && op == OP_STOP) u.status = DONE;
    else if (do_dma) u.status = BLK_DMA;
    else if (active && op == OP_BARRIER) u.status = BLK_BAR;

    const int gap = 1 + (op == OP_MUL ? c[C_MUL_EXTRA]
                         : op == OP_DIV ? c[C_DIV_EXTRA] : 0);
    if (lane == wsel) u.warp_next = wadd(cyc, gap);
    if constexpr (kSmem)
      u.rr = w.sh_nW >= 0 ? (wsel + 1) & (nW - 1) : (wsel + 1) % nW;
    else
      u.rr = (wsel + 1) % nW;
  }

  // ---- counters of the issue ----
  {
    int n_stall, n_rd, n_wr, rd_b, wr_b;
    if constexpr (kSmem) {   // from the DMA's own sums, as the votes give
      n_stall = op == OP_ACQUIRE ? __popc(__ballot_sync(FULL, acq_stall)) : 0;
      n_rd = is_sdma ? 0 : dma_lanes;
      n_wr = is_sdma ? dma_lanes : 0;
      rd_b = is_sdma ? 0 : dma_bytes;
      wr_b = is_sdma ? dma_bytes : 0;
    } else {
      n_stall = __popc(__ballot_sync(FULL, acq_stall));
      n_rd = __popc(__ballot_sync(FULL, do_dma && !is_sdma));
      n_wr = __popc(__ballot_sync(FULL, do_dma && is_sdma));
      rd_b = __reduce_add_sync(FULL, do_dma && !is_sdma ? size : 0);
      wr_b = __reduce_add_sync(FULL, do_dma && is_sdma ? size : 0);
    }
    const int issued = valid ? n_active : 0;
    u.cnt = wadd(u.cnt, (lane == K_ISSUED ? issued : 0)
                            + (lane == K_CLS + cls ? issued : 0)
                            + (lane == K_ACQ_RETRY ? n_stall : 0)
                            + (lane == K_DMA_RD ? n_rd : 0)
                            + (lane == K_DMA_WR ? n_wr : 0));
    if (lane == F_RD_BYTES) u.fcnt = __fadd_rn(u.fcnt, __int2float_rn(rd_b));
    if (lane == F_WR_BYTES) u.fcnt = __fadd_rn(u.fcnt, __int2float_rn(wr_b));
  }

  // ---- classify + advance (warp-level events) ----
  sec.mark(step_common::S_ISSUE);
  const int ni = __reduce_min_sync(FULL, runnable ? u.warp_next : INF);
  const int df = u.eng_active ? u.eng_finish : INF;
  const int nxt = min(ni, df);
  const bool idle = running && !valid;
  const int cyc_p1 = wadd(cyc, 1);
  int new_cycle = cyc;
  if (running) {
    new_cycle = (c[C_SKIP] && idle && nxt < INF) ? max(cyc_p1, nxt) : cyc_p1;
  }
  const int delta = wsub(new_cycle, cyc);
  const bool mem = idle && df <= ni;
  if (running) {
    const int h = clampi(n_ready0, 0, T);
    if (h == 32) u.hist32 = wadd(u.hist32, 1);
    else if (lane == h) u.hist = wadd(u.hist, 1);
  }
  u.cycle = new_cycle;
  u.cnt = wadd(u.cnt, (lane == K_ACTIVE && valid)
                          + ((lane == K_IDLE_MEM && mem) ? delta : 0)
                          + ((lane == K_IDLE_REV && idle && !mem) ? delta
                                                                  : 0));
  sec.mark(step_common::S_CLASSIFY);
  sec.step();
}

// This warp's DPU: set up `w` and load `u` (the register file into
// shared memory).  Returns false for a warp past the last DPU.
__device__ bool load_dpu(const Args& args, int32_t* smem, Warp& w, Dpu& u) {
  const int* c = args.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dpb = blockDim.x >> 5;
  const int d = blockIdx.x * dpb + warp;
  const int T = c[C_T];
  w.lane = lane;
  w.d = d;
  w.T = T;
  w.SW = c[C_SW];
  w.nW = T / w.SW;
  w.W = c[C_W];
  w.M = c[C_M];
  w.P = c[C_P];
  w.act = lane < T;
  w.wram = leaf<int32_t>(args, L_WRAM) + static_cast<size_t>(d) * w.W;
  w.mram = leaf<int32_t>(args, L_MRAM) + static_cast<size_t>(d) * w.M;
  w.sregs = smem + warp * T * NREGS;
  u = Dpu{};
  u.status = DONE;
  u.open_row = -1;
  if (d >= c[C_D]) return false;
  const int i = d * T + lane;
  if (w.act) {
    u.pc = leaf<int32_t>(args, L_PC)[i];
    u.status = leaf<int32_t>(args, L_STATUS)[i];
    u.next_issue = leaf<int32_t>(args, L_NEXT_ISSUE)[i];
    u.req_valid = leaf<uint8_t>(args, L_REQ_VALID)[i] != 0;
    u.req_mram = leaf<int32_t>(args, L_REQ_MRAM)[i];
    u.req_bytes = leaf<int32_t>(args, L_REQ_BYTES)[i];
    u.req_enq = leaf<int32_t>(args, L_REQ_ENQ)[i];
    u.req_service = leaf<int32_t>(args, L_REQ_SERVICE)[i];
  }
  if (lane < w.nW) u.warp_next = leaf<int32_t>(args, L_WARP_NEXT)[d * w.nW
                                                                   + lane];
  u.cycle = leaf<int32_t>(args, L_CYCLE)[d];
  u.rr = leaf<int32_t>(args, L_RR)[d];
  u.eng_active = leaf<uint8_t>(args, L_ENG_ACTIVE)[d] != 0;
  u.eng_thread = leaf<int32_t>(args, L_ENG_THREAD)[d];
  u.eng_finish = leaf<int32_t>(args, L_ENG_FINISH)[d];
  u.open_row = leaf<int32_t>(args, L_OPEN_ROW)[d];
  if (lane < N_COUNTERS) u.cnt = leaf<int32_t>(args, kCounterLeaf[lane])[d];
  else if (lane >= K_CLS && lane < K_CLS + 6)
    u.cnt = leaf<int32_t>(args, L_C_CLS)[d * 6 + lane - K_CLS];
  if (lane == F_RD_BYTES) u.fcnt = leaf<float>(args, L_C_DMA_RD_BYTES)[d];
  if (lane == F_WR_BYTES) u.fcnt = leaf<float>(args, L_C_DMA_WR_BYTES)[d];
  const int32_t* h = leaf<int32_t>(args, L_C_HIST) + d * (T + 1);
  if (lane <= T) u.hist = h[lane];
  if (T == 32) u.hist32 = h[32];
  const int32_t* r = leaf<int32_t>(args, L_REGS) + d * T * NREGS;
  for (int k = lane; k < T * NREGS; k += 32) w.sregs[k] = r[k];
  __syncwarp();
  return true;
}

__device__ void store_dpu(const Args& args, const Warp& w, const Dpu& u) {
  const int lane = w.lane, d = w.d, T = w.T;
  const int i = d * T + lane;
  if (w.act) {
    leaf<int32_t>(args, L_PC)[i] = u.pc;
    leaf<int32_t>(args, L_STATUS)[i] = u.status;
    leaf<int32_t>(args, L_NEXT_ISSUE)[i] = u.next_issue;
    leaf<uint8_t>(args, L_REQ_VALID)[i] = u.req_valid;
    leaf<int32_t>(args, L_REQ_MRAM)[i] = u.req_mram;
    leaf<int32_t>(args, L_REQ_BYTES)[i] = u.req_bytes;
    leaf<int32_t>(args, L_REQ_ENQ)[i] = u.req_enq;
    leaf<int32_t>(args, L_REQ_SERVICE)[i] = u.req_service;
  }
  if (lane < w.nW) leaf<int32_t>(args, L_WARP_NEXT)[d * w.nW + lane] =
      u.warp_next;
  if (lane == 0) {
    leaf<int32_t>(args, L_CYCLE)[d] = u.cycle;
    leaf<int32_t>(args, L_RR)[d] = u.rr;
    leaf<uint8_t>(args, L_ENG_ACTIVE)[d] = u.eng_active;
    leaf<int32_t>(args, L_ENG_THREAD)[d] = u.eng_thread;
    leaf<int32_t>(args, L_ENG_FINISH)[d] = u.eng_finish;
    leaf<int32_t>(args, L_OPEN_ROW)[d] = u.open_row;
  }
  if (lane < N_COUNTERS) leaf<int32_t>(args, kCounterLeaf[lane])[d] = u.cnt;
  else if (lane >= K_CLS && lane < K_CLS + 6)
    leaf<int32_t>(args, L_C_CLS)[d * 6 + lane - K_CLS] = u.cnt;
  if (lane == F_RD_BYTES) leaf<float>(args, L_C_DMA_RD_BYTES)[d] = u.fcnt;
  if (lane == F_WR_BYTES) leaf<float>(args, L_C_DMA_WR_BYTES)[d] = u.fcnt;
  int32_t* h = leaf<int32_t>(args, L_C_HIST) + d * (T + 1);
  if (lane <= T) h[lane] = u.hist;
  if (T == 32 && lane == 0) h[32] = u.hist32;
  int32_t* r = leaf<int32_t>(args, L_REGS) + d * T * NREGS;
  for (int k = lane; k < T * NREGS; k += 32) r[k] = w.sregs[k];
}

// Phase 1: each warp steps its DPU while the DPU runs, at most K steps.
__global__ void __launch_bounds__(DPB * 32)
simt_run_kernel(const Args args) {
  extern __shared__ int32_t smem[];
  Sections sec;
  sec.begin_launch();
  Warp w;
  Dpu u;
  if (!load_dpu(args, smem, w, u)) return;
  sec.mark(step_common::S_LOAD);
  const int* c = args.c;
  const int K = c[C_K];
  int stop = 0;
  while (stop < K && dpu_running(u, w, c)) {
    step_dpu<false>(u, w, args, true, sec);
    ++stop;
  }
  const bool run_end = stop == K && dpu_running(u, w, c);
  sec.start();
  store_dpu(args, w, u);
  if (w.lane == 0) {
    args.stop[w.d] = stop;
    atomicMax(args.vote + args.parity, 2 * stop + run_end);
  }
  sec.mark(step_common::S_STORE);
  sec.end_launch(args.sections, w.lane == 0);
}

// Phase 2: go was true up to step G (the first step at which no DPU ran):
// each DPU that stopped earlier takes its steps up to G with nothing to
// issue.  Then the predicate, and the other parity's vote cleared.
__global__ void __launch_bounds__(DPB * 32)
simt_tail_kernel(const Args args) {
  const int vote = __ldcg(args.vote + args.parity);
  const int G = vote >> 1;
  const int dpb = blockDim.x >> 5;
  const int d = blockIdx.x * dpb + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    args.flag[args.parity] = vote & 1;
    __threadfence_system();
    args.vote[args.parity ^ 1] = 0;
  }
  if (d >= args.c[C_D] || __ldcg(args.stop + d) >= G) return;
  extern __shared__ int32_t smem[];
  Sections sec;
  Warp w;
  Dpu u;
  load_dpu(args, smem, w, u);
  for (int t = __ldcg(args.stop + d); t < G; ++t)
    step_dpu<false>(u, w, args, false, sec);
  store_dpu(args, w, u);
}

size_t smem_bytes(int dpb, int T) {
  return static_cast<size_t>(dpb) * T * NREGS * 4;
}

// The resident_smem route's shared memory a block: the register file
// (load_dpu's layout for one warp a block), WRAM and the atomics, each
// rounded up to 16 bytes.
__host__ __device__ int smem_head_words(int T) { return (T * NREGS + 3) & ~3; }
__host__ __device__ size_t smem_route_bytes(int T, int W, int A) {
  return 4 * (static_cast<size_t>(smem_head_words(T)) + ((W + 3) & ~3)
              + ((A + 3) & ~3));
}

// The largest vote of every warp of a resident_smem launch (one warp a
// block): one grid barrier; `partial` holds a vote a block.
__device__ __forceinline__ int vote_max(int v, int32_t* partial) {
  const int lane = threadIdx.x;
  if (gridDim.x == 1) return v;
  if (lane == 0) partial[blockIdx.x] = v;
  cg::this_grid().sync();
  int g = 0;
  for (unsigned i = lane; i < gridDim.x; i += 32)
    g = max(g, __ldcg(partial + i));
  return __reduce_max_sync(FULL, g);
}

// The resident_smem route: K steps of every DPU in one launch, one DPU
// (warp) a block, with its WRAM row and atomics in shared memory for the
// launch (one bulk copy in at the start, while the scalars load, one out
// at the end), so LW, SW, the atomics and the WRAM side of every DMA
// touch shared memory only; a DMA step's windows are copied all at once
// where their order cannot matter.  The tail is folded in: after phase 1
// one vote over the launch (a grid barrier: every block resident, a
// cooperative launch past one block) gives G, and each DPU that stopped
// earlier takes its steps up to G in the same launch.
__global__ void __launch_bounds__(32, 1) simt_smem_kernel(const Args args) {
  const int* c = args.c;
  const int d = blockIdx.x, lane = threadIdx.x;
  const int T = c[C_T], W = c[C_W], A = c[C_A], K = c[C_K];
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ __align__(8) uint64_t s_bar;
  Sections sec;
  sec.begin_launch();
  int32_t* swram = smem + smem_head_words(T);
  int32_t* satom = swram + ((W + 3) & ~3);
  int32_t* gwram = leaf<int32_t>(args, L_WRAM) + static_cast<size_t>(d) * W;
  int32_t* gatom = leaf<int32_t>(args, L_ATOMIC) + static_cast<size_t>(d) * A;
  const bool bulk = W % 4 == 0 && A % 4 == 0
                    && ((reinterpret_cast<uintptr_t>(gwram)
                         | reinterpret_cast<uintptr_t>(gatom)) & 15) == 0;
  const uint32_t bar = step_common::smem_u32(&s_bar);
  const uint32_t sdst[2] = {step_common::smem_u32(swram),
                            step_common::smem_u32(satom)};
  const uint32_t nbytes[2] = {4u * W, 4u * A};
  if (bulk && lane == 0 && d < c[C_D]) {
    const void* gsrc[2] = {gwram, gatom};
    step_common::bulk_load(bar, 2, sdst, gsrc, nbytes);
  }
  Warp w;
  Dpu u;
  const bool live = load_dpu(args, smem, w, u);
  if (live) {
    if (bulk) {
      step_common::bulk_wait(bar);
    } else {
      for (int k = lane; k < W; k += 32) swram[k] = gwram[k];
      for (int k = lane; k < A; k += 32) satom[k] = gatom[k];
      __syncwarp();
    }
  }
  w.wram = swram;
  w.atomic = satom;
  w.sh_SW = step_common::pow2_shift(w.SW);
  w.sh_nW = step_common::pow2_shift(w.nW);
  w.sh_row = step_common::pow2_shift(c[C_ROW_BYTES]);
  sec.mark(step_common::S_LOAD);

  // phase 1
  int stop = 0;
  bool run_end = false;
  if (live) {
    while (stop < K && dpu_running(u, w, c)) {
      step_dpu<true>(u, w, args, true, sec);
      ++stop;
    }
    run_end = stop == K && dpu_running(u, w, c);
  }
  // G and the predicate
  sec.start();
  const int vote = vote_max(live ? 2 * stop + run_end : 0, args.stop);
  const int G = vote >> 1;
  sec.mark(step_common::S_VOTE);
  // phase 2
  if (live)
    for (int t = stop; t < G; ++t) step_dpu<true>(u, w, args, false, sec);
  // the state, WRAM and the atomics back
  sec.start();
  if (live) {
    if (bulk) {   // the rows' copy out runs while the scalars are stored
      step_common::bulk_store_fence();
      __syncwarp();
      if (lane == 0) {
        void* gdst[2] = {gwram, gatom};
        step_common::bulk_store(2, gdst, sdst, nbytes);
      }
    } else {
      for (int k = lane; k < W; k += 32) gwram[k] = swram[k];
      for (int k = lane; k < A; k += 32) gatom[k] = satom[k];
    }
    store_dpu(args, w, u);
    if (bulk && lane == 0) step_common::bulk_store_wait();
  }
  if (d == 0 && lane == 0) {
    args.flag[args.parity] = vote & 1;
    __threadfence_system();
  }
  sec.mark(step_common::S_STORE);
  sec.end_launch(args.sections, live && lane == 0);
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
int simt_step_dpus_per_block() { return DPB; }
int simt_step_n_leaves() { return N_LEAVES; }
int simt_step_n_config() { return N_CFG; }
int simt_step_n_fields() { return N_FIELDS; }
int simt_step_args_bytes() { return static_cast<int>(sizeof(Args)); }

// The resident_smem route's shared memory a block (bytes).
int simt_step_smem_bytes(int T, int W, int A) {
  const size_t b = smem_route_bytes(T, W, A);
  return b > static_cast<size_t>(INT_MAX) ? INT_MAX : static_cast<int>(b);
}

// What the current device allows the resident_smem kernel, into out[5]
// (as cycle_step_card_limits): SMs, the opt-in dynamic shared memory of a
// block, the shared memory of an SM, what a block takes besides its
// dynamic shared memory, and the kernel's blocks an SM holds with none.
// Returns minus the cudaError_t on failure, else 0.
int simt_step_card_limits(int* out) {
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
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, simt_smem_kernel);
  out[3] = reserved + static_cast<int>(attr.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4,
                                                      simt_smem_kernel, 32, 0);
  return e == cudaSuccess ? 0 : -static_cast<int>(e);
}

static cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      simt_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// Launch K steps of args->c[C_D] DPUs on the resident_smem route, one DPU
// a block (an ordinary launch for one DPU, else a cooperative one, refused
// unless every block is resident).  Returns the cudaError_t as int.
int simt_step_launch_smem(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  const int D = args->c[C_D], T = args->c[C_T], SW = args->c[C_SW];
  if (D < 1 || T < 1 || T > 32 || SW < 1 || T % SW != 0 || args->c[C_K] < 1
      || (args->parity & ~1) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_route_bytes(T, args->c[C_W], args->c[C_A]);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return refused(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 1) {
    simt_smem_kernel<<<1, 32, smem, s>>>(*args);
  } else {
    Args copy = *args;
    void* params[] = {&copy};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(simt_smem_kernel), dim3(D), dim3(32),
        params, smem, s);
    if (e != cudaSuccess) return refused(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K steps (args->c[C_K]) of args->c[C_D] DPUs on `stream`: the run
// kernel and the tail kernel, DPB DPUs (warps) a block.  Returns the first
// cudaError_t as int.  (`args` points at a struct Args.)
int simt_step_launch(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  const int D = args->c[C_D], T = args->c[C_T], SW = args->c[C_SW];
  if (D < 1 || T < 1 || T > 32 || SW < 1 || T % SW != 0 || args->c[C_K] < 1
      || (args->parity & ~1) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dpb = D < DPB ? D : DPB;
  const unsigned grid = (D + dpb - 1) / dpb;
  const size_t smem = smem_bytes(dpb, T);  // < 48 KiB: no opt-in needed
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  simt_run_kernel<<<grid, dpb * 32, smem, s>>>(*args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return refused(e);
  simt_tail_kernel<<<grid, dpb * 32, smem, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
