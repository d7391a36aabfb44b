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
//   (vote & 1) into `flag` and clears the other parity's vote for the next
//   launch.
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
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../../alu_exec/csrc/alu_exec.cuh"

namespace {

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
  int32_t* stop;         // (D,): steps each DPU ran in this launch's phase 1
  int32_t* vote;         // (2,): max over DPUs of 2 * stop + still running
  int32_t* flag;         // the termination predicate after the launch
  int32_t parity;        // which vote this launch uses
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
  int32_t* wram;   // this DPU's row
  int32_t* mram;
  int32_t* sregs;  // the register file, in shared memory
};

__device__ __forceinline__ bool dpu_running(const Dpu& u, const Warp& w,
                                            const int* c) {
  return __any_sync(FULL, w.act && u.status != DONE)
         && u.cycle < c[C_MAX_CYCLES];
}

// One simulated cycle of this DPU with go = true (some DPU runs):
// the DRAM engine, the barrier release, the issue of one ready warp (none
// when the DPU itself has stopped: `running` false) and the cycle's
// classification.
__device__ void step_dpu(Dpu& u, const Warp& w, const Args& args,
                         bool running) {
  const int* c = args.c;
  const int lane = w.lane, T = w.T, SW = w.SW, nW = w.nW;
  const bool act = w.act;
  const int cyc = u.cycle;
  const int my_warp = lane / SW;

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
    const int row = floordiv(u.req_mram, c[C_ROW_BYTES]);
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
    u.open_row = floordiv(wsub(wadd(m_j, b_j < 1 ? 1 : b_j), 1),
                          c[C_ROW_BYTES]);
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
  int prio = (lane - u.rr) % (nW > 0 ? nW : 1);
  if (prio < 0) prio += nW;
  const int wsel = argmin_first(ready ? prio : INF, is_w);
  const bool valid = __any_sync(FULL, ready);

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
    int32_t* at = leaf<int32_t>(args, L_ATOMIC)
                  + static_cast<size_t>(w.d) * c[C_A] + aidx;
    const int aold = *at;
    // every lane has read before any lane writes
    __syncwarp();
    if (active && in.wrd) rf[in.rd] = res;

    // SW: of the lanes that store to one word, the highest stores
    const bool do_sw = active && op == OP_SW;
    const unsigned same = __match_any_sync(
        FULL, do_sw ? static_cast<unsigned long long>(
                          static_cast<uint32_t>(widx))
                    : (1ull << 32) + lane);
    if (do_sw && 31 - __clz(same) == lane) w.wram[widx] = breg;

    // atomics: lane-serialised, the first active lane may acquire
    const bool is_acq = op == OP_ACQUIRE;
    const bool acq_ok = active && is_acq && lane == leader && aold == 0;
    acq_stall = active && is_acq && !acq_ok;
    const bool acq_any = __any_sync(FULL, acq_ok);
    const bool rel_any = __any_sync(FULL, active && op == OP_RELEASE);
    if (lane == 0 && (acq_any || rel_any)) *at = acq_any ? 1 : 0;

    // DMA: merge the lanes' requests (coalescer), copy now
    do_dma = active && (op == OP_LDMA || op == OP_SDMA);
    is_sdma = op == OP_SDMA;
    if (__any_sync(FULL, do_dma)) {
      __syncwarp();
      const int sz = in.ui ? in.imm : (act ? rf[in.rd] : 0);
      size = do_dma ? clampi(sz, 0, MAX_DMA_BYTES) : 0;
      const int total = __reduce_add_sync(FULL, size);
      int n_act;
      if (c[C_COALESCING]) {
        // one activate per unique row among the lanes
        const unsigned long long key =
            do_dma ? static_cast<unsigned long long>(static_cast<uint32_t>(
                         floordiv(breg, c[C_ROW_BYTES])))
                   : (1ull << 32) + lane;
        const unsigned grp = __match_any_sync(FULL, key);
        n_act = __popc(__ballot_sync(FULL, do_dma && __ffs(grp) - 1 == lane));
      } else {
        n_act = __popc(__ballot_sync(FULL, do_dma));
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
      unsigned lanes_left = __ballot_sync(FULL, do_dma && n > 0);
      while (lanes_left) {
        const int m = __ffs(lanes_left) - 1;
        lanes_left &= lanes_left - 1;
        const int nm = __shfl_sync(FULL, n, m);
        const int db = __shfl_sync(FULL, dst_b, m);
        const int sb = __shfl_sync(FULL, src_b, m);
        const int low = min(nm - 1, -db);
        for (int k = lane; k < nm; k += 32) {
          const int t = clampi(db + k, 0, dtop);
          const bool win = t == dtop ? k == nm - 1 : (t == 0 ? k == low
                                                                : true);
          if (win) dst[t] = src[clampi(sb + k, 0, stop_)];
        }
        __syncwarp();
      }
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
    u.rr = (wsel + 1) % nW;
  }

  // ---- counters of the issue ----
  {
    const int n_stall = __popc(__ballot_sync(FULL, acq_stall));
    const int n_rd = __popc(__ballot_sync(FULL, do_dma && !is_sdma));
    const int n_wr = __popc(__ballot_sync(FULL, do_dma && is_sdma));
    const int rd_b = __reduce_add_sync(FULL, do_dma && !is_sdma ? size : 0);
    const int wr_b = __reduce_add_sync(FULL, do_dma && is_sdma ? size : 0);
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
  Warp w;
  Dpu u;
  if (!load_dpu(args, smem, w, u)) return;
  const int* c = args.c;
  const int K = c[C_K];
  int stop = 0;
  while (stop < K && dpu_running(u, w, c)) {
    step_dpu(u, w, args, true);
    ++stop;
  }
  const bool run_end = stop == K && dpu_running(u, w, c);
  store_dpu(args, w, u);
  if (w.lane == 0) {
    args.stop[w.d] = stop;
    atomicMax(args.vote + args.parity, 2 * stop + run_end);
  }
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
    *args.flag = vote & 1;
    args.vote[args.parity ^ 1] = 0;
  }
  if (d >= args.c[C_D] || __ldcg(args.stop + d) >= G) return;
  extern __shared__ int32_t smem[];
  Warp w;
  Dpu u;
  load_dpu(args, smem, w, u);
  for (int t = __ldcg(args.stop + d); t < G; ++t) step_dpu(u, w, args, false);
  store_dpu(args, w, u);
}

size_t smem_bytes(int dpb, int T) {
  return static_cast<size_t>(dpb) * T * NREGS * 4;
}

}  // namespace

extern "C" {

// Layout checks the Python side makes before it builds a launch.
int simt_step_dpus_per_block() { return DPB; }
int simt_step_n_leaves() { return N_LEAVES; }
int simt_step_n_config() { return N_CFG; }
int simt_step_n_fields() { return N_FIELDS; }
int simt_step_args_bytes() { return static_cast<int>(sizeof(Args)); }

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
  if (e != cudaSuccess) return static_cast<int>(e);
  simt_tail_kernel<<<grid, dpb * 32, smem, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
