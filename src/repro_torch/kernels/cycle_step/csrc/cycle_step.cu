// The simulator's whole cycle step, K steps per launch, every issue slot's
// ALU on alu_exec_one (../../alu_exec/csrc/alu_exec.cuh).
//
// Replaces, on the card, the per-step graph of a few hundred small torch
// kernels around one ALU launch per issue slot that ran the port's eager
// step (repro_torch/core/engine.py::_step_coro); the JAX reference is
// repro/core/engine.py::make_step_traced, whose ALU is the Pallas kernel
// repro/kernels/alu_exec/alu_exec.py (_alu_kernel / alu_exec_2d).  The
// result is the eager step's, bit for bit: same int32 state, same float32
// counters, same step gating.
//
// Design:
// * one warp per DPU, one lane per tasklet (T <= 32).  The ready set,
//   FR-FCFS's argmax, the issue argmin and the barrier count are warp
//   votes and reductions; the DMA window strides over the 32 lanes;
// * each tasklet's scalars (pc, status, next_issue, DMA latch, ...) live
//   in its lane's registers for the K steps; each DPU's scalars in every
//   lane of its warp (computed redundantly); the counters one to a lane
//   (lane i holds counter i, lane i holds c_hist[i]); the register file
//   in shared memory; WRAM, MRAM, atomics, TLB, D$ and the time series
//   stay in device memory (L2-resident at one rank);
// * two values cross DPUs: `go` (any DPU running: a stopped DPU still
//   retires DMAs, releases barriers, drains its port and accumulates the
//   time series while others run) and, per issue slot, whether any DPU's
//   DMA is wider than small_dma_words (the copy window nw, which decides
//   what a clipped tail writes).  Neither needs a barrier a step.  A
//   running DPU knows `go` is true, so each warp steps its DPU on its
//   own while it runs (phase 1); one vote over the launch then gives the
//   first step at which no DPU ran, and each DPU that stopped earlier
//   takes the steps up to it with nothing to issue (phase 2).  The width
//   matters only to a DMA of exactly small_dma_words whose window reaches
//   the last word or lies below word 0: each warp publishes its step's
//   issue plan (the DRAM step and the barrier release only make threads
//   RUN with next_issue = cycle + 1, so the plan is known at the step's
//   start) and such a DMA waits for every DPU's plan of its step.  The
//   waits need every warp resident: one block, or a cooperative launch;
// * after K steps the kernel writes the termination predicate into
//   `flag`; the host reads it once per launch.
//
// Above the resident limit (cycle_step_max_dpus) a cooperative launch is
// refused, so the stepwise route takes every step as two ordinary
// launches and lets the kernel boundary order the DPUs: a plan launch in
// which each running DPU ORs its step's wide bits and `go` (kGo) into
// wide[t], then a run launch that reads them instead of waiting.  Each
// launch loads its DPU's state from device memory and the run launch
// stores it back; after the K steps one more plan launch ORs the
// predicate into `flag`.  The same step_dpu, the same result bit for bit;
// speed is not its aim.
//
// What bounds it: not bytes (the state of a 64-DPU rank is ~0.7 MB, read
// and written once a launch) but the serial chain of each step, a few
// hundred dependent instructions and shared/L2 accesses.
//
// Integer arithmetic wraps through uint32_t; floor division and remainder
// are torch's (floor), not C++'s (truncation); float32 counters use
// __fadd_rn / __fmul_rn so that nothing is contracted into an FMA.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared, plain C interface) and called
// through ctypes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../../alu_exec/csrc/alu_exec.cuh"

namespace cg = cooperative_groups;

namespace {

// state leaves, in the order of engine.make_state_np (cycle_step.py LEAVES)
enum Leaf {
  L_CYCLE, L_PC, L_REGS, L_STATUS, L_NEXT_ISSUE, L_LAST_DEST, L_LAST_READY,
  L_PORT_BUSY, L_RR, L_WRAM, L_MRAM, L_ATOMIC, L_REQ_VALID, L_REQ_WRAM,
  L_REQ_MRAM, L_REQ_BYTES, L_REQ_WRITE, L_REQ_ENQ, L_ENG_ACTIVE,
  L_ENG_THREAD, L_ENG_FINISH, L_OPEN_ROW, L_TLB_TAGS, L_TLB_LRU, L_DC_TAGS,
  L_DC_LRU, L_DC_DIRTY, L_C_ACTIVE, L_C_IDLE_MEM, L_C_IDLE_REV, L_C_IDLE_RF,
  L_C_ISSUED, L_C_CLS, L_C_HIST, L_C_DMA_RD, L_C_DMA_WR, L_C_DMA_RD_BYTES,
  L_C_DMA_WR_BYTES, L_C_ROW_HIT, L_C_ROW_MISS, L_C_TLB_HIT, L_C_TLB_MISS,
  L_C_DC_HIT, L_C_DC_MISS, L_C_ACQ_RETRY, L_TS_BUF, L_TS_ACC, N_LEAVES
};

// sizes and configuration (cycle_step.py CONFIG)
enum Cfg {
  C_D, C_T, C_W, C_M, C_A, C_E, C_NSETS, C_WAYS, C_L, C_P, C_K,
  C_MAX_CYCLES, C_ROW_BYTES, C_ROW_HIT, C_ROW_MISS, C_PAGE_BYTES,
  C_LINE_BYTES, C_SMALL, C_REVOLVER, C_WIN, C_SS, C_FWD, C_URF, C_MMU,
  C_CACHE, C_SKIP, C_DETAIL, N_CFG
};

// the decoded instruction image: 12 int32 per slot (cycle_step.py)
enum Field {
  F_RA, F_RB, F_RD, F_SPC, F_OP, F_IMM, F_CLS, F_EXTRA, F_LAT, F_BIDX,
  F_FLAGS, N_FIELDS = 12
};
enum Flag {
  B_UIV, B_ALU, B_LW, B_SW, B_MEM, B_JAL, B_JMP, B_JR, B_STOP, B_BAR, B_BR,
  B_ACQ, B_REL, B_DMA, B_SDMA, B_WRD, B_RD_RA, B_RB_DEP, B_TWO
};

// counters held one to a lane (lane = index); c_cls[i] at lane 16 + i
enum Counter {
  K_ACTIVE, K_IDLE_MEM, K_IDLE_REV, K_IDLE_RF, K_ISSUED, K_DMA_RD, K_DMA_WR,
  K_ROW_HIT, K_ROW_MISS, K_TLB_HIT, K_TLB_MISS, K_DC_HIT, K_DC_MISS,
  K_ACQ_RETRY, N_COUNTERS, K_CLS = 16
};
__constant__ int kCounterLeaf[N_COUNTERS] = {
    L_C_ACTIVE, L_C_IDLE_MEM, L_C_IDLE_REV, L_C_IDLE_RF, L_C_ISSUED,
    L_C_DMA_RD, L_C_DMA_WR, L_C_ROW_HIT, L_C_ROW_MISS, L_C_TLB_HIT,
    L_C_TLB_MISS, L_C_DC_HIT, L_C_DC_MISS, L_C_ACQ_RETRY};
// float counters: lane 0 c_dma_rd_bytes, lane 1 c_dma_wr_bytes, lane 2 ts_acc
constexpr int F_RD_BYTES = 0, F_WR_BYTES = 1, F_TS_ACC = 2;

constexpr int RUN = 0, BLK_DMA = 1, BLK_BAR = 2, DONE = 3;
constexpr int INF = 1 << 30;
constexpr int NREGS = 24;
constexpr int MAX_DMA_BYTES = 2048;
constexpr int MAX_DMA_WORDS = MAX_DMA_BYTES / 4;
constexpr int MAX_SLOTS = 8;
// DPUs (warps) per block.  Every block of a resident launch must be
// resident at once (the cross-DPU waits and the grid barrier), so that
// route takes at most cycle_step_max_dpus() DPUs; the stepwise route
// takes any number.
constexpr int DPB = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  void* leaf[N_LEAVES];
  const int32_t* image;  // (P, N_FIELDS)
  uint32_t* partial;     // (gridDim.x,): per-block vote at the launch's end
  int32_t* flag;         // the termination predicate after the launch
  // (D,): per DPU, 1 + the absolute index of the last step whose issue
  // plan it has published, or kStopped once it runs no more
  long long* prog;
  // (K,): bit s of step t: a DMA of slot s is wide; kGo (stepwise route
  // only): some DPU runs at step t
  uint32_t* wide;
  long long base;        // absolute index of this launch's first step
  int32_t c[N_CFG];
  float inv_bw;          // float32(1) / float32(effective_mram_bw)
  float inv_win;         // float32(1) / float32(timeseries_window)
};
constexpr long long kStopped = 0x7fffffffffffffffLL;
constexpr uint32_t kGo = 1u << 31;

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
// torch.remainder(x, n) for n > 0
__device__ __forceinline__ int remainder(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// first lane of the minimum (torch.argmin's tie rule) over lanes with act
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
// (first index with tag == want or INT_MAX, first index of the least lru)
// over n entries strided across the warp
__device__ __forceinline__ void match_and_lru(const int32_t* tags,
                                              const int32_t* lru, int n,
                                              int want, int lane, int* first,
                                              int* victim) {
  int fm = INT_MAX, mv = INT_MAX, mi = INT_MAX;
  for (int e = lane; e < n; e += 32) {
    const int tg = tags[e], lr = lru[e];
    if (tg == want && fm == INT_MAX) fm = e;
    if (mi == INT_MAX || lr < mv) { mv = lr; mi = e; }
  }
  *first = __reduce_min_sync(FULL, fm);
  const int gmin = __reduce_min_sync(FULL, mv);
  *victim = __reduce_min_sync(FULL, mv == gmin ? mi : INT_MAX);
}

template <typename T>
__device__ __forceinline__ T* leaf(const Args& a, int i) {
  return static_cast<T*>(a.leaf[i]);
}

struct Instr {
  int ra, rb, rd, spc, op, imm, cls, extra, lat, bidx, flags;
  __device__ __forceinline__ bool f(int bit) const { return (flags >> bit) & 1; }
};

__device__ __forceinline__ Instr fetch(const int32_t* image, int p) {
  const int4* row = reinterpret_cast<const int4*>(image + p * N_FIELDS);
  const int4 x = __ldg(row), y = __ldg(row + 1), z = __ldg(row + 2);
  return Instr{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z};
}

// This warp's DPU while a launch runs: lane = tasklet for the per-tasklet
// fields, the DPU's scalars in every lane, counters one to a lane.
struct Dpu {
  int pc, status, next_issue, last_dest, last_ready;
  int req_wram, req_mram, req_bytes, req_enq;
  bool req_valid, req_write;
  int cycle, port_busy, rr, eng_thread, eng_finish, open_row;
  bool eng_active;
  int cnt, hist, hist32;
  float fcnt;
};

// What a warp reads besides its DPU's state.
struct Warp {
  int lane, d, T, W, M, D, P, small, SS;
  bool act;
  int32_t* wram;   // this DPU's row
  int32_t* mram;
  int32_t* sregs;  // the register file, in shared memory
  int32_t* splan;  // per slot: valid, tsel, pidx
};

__device__ __forceinline__ bool dpu_running(const Dpu& u, const Warp& w,
                                            const int* c) {
  return __any_sync(FULL, w.act && u.status != DONE)
         && u.cycle < c[C_MAX_CYCLES];
}

// Plan the issue slots of a running DPU's step from its own state (the
// DRAM step and the barrier release that come first only make threads
// RUN with next_issue = cycle + 1, which cannot issue this cycle).
// Returns bit s set when slot s issues a DMA wider than small_dma_words.
__device__ __forceinline__ uint32_t plan(const Dpu& u, const Warp& w,
                                         const Args& args) {
  const int* c = args.c;
  uint32_t bits = 0;
  bool already = false, slot_block = false;
#pragma unroll 1
  for (int s = 0; s < w.SS; ++s) {
    const bool ready = w.act && u.status == RUN && u.next_issue <= u.cycle
                       && !already;
    const bool valid = u.port_busy == 0 && __any_sync(FULL, ready)
                       && !slot_block;
    const int tsel = argmin_first(ready ? remainder(w.lane - u.rr, w.T) : INF,
                                  w.act);
    int pidx = __shfl_sync(FULL, u.pc, tsel);
    if (pidx < 0) pidx += w.P;  // JAX gather: wrap once, then clamp
    pidx = clampi(pidx, 0, w.P - 1);
    bool hazard = false;
    if (valid) {
      const Instr in = fetch(args.image, pidx);
      if (in.f(B_DMA)) {
        const int size = clampi(in.f(B_UIV) ? in.imm
                                : w.sregs[tsel * NREGS + in.rd],
                                0, MAX_DMA_BYTES);
        if (((size + 3) >> 2) > w.small) bits |= 1u << s;
      }
      hazard = !c[C_URF] && in.f(B_TWO) && ((in.ra & 1) == (in.rb & 1));
    }
    if (w.lane == 0) {
      w.splan[s * 3] = valid;
      w.splan[s * 3 + 1] = tsel;
      w.splan[s * 3 + 2] = pidx;
    }
    already = already || (valid && w.lane == tsel);
    slot_block = slot_block || hazard || !valid;
  }
  __syncwarp();
  return bits;
}

// Whether some DPU's DMA in slot s of step `step` is wide: waits until
// every DPU has published its plan of that step (or stopped).  All DPUs
// are resident (cooperative launch), and each publishes before it can
// wait, so the DPU furthest behind never waits on another.  (The
// stepwise route reads wide[t] instead: its plan launch has ended.)
__device__ __noinline__ bool wide_anywhere(const Args& args, const Warp& w,
                                           long long step, int t, int s) {
  for (int e = w.lane; e < w.D; e += 32) {
    const volatile long long* p = args.prog + e;
    while (*p < step + 1) {
    }
  }
  __syncwarp();
  __threadfence();
  return (atomicOr(args.wide + t, 0u) >> s) & 1u;
}

// One simulated cycle of this DPU with go = true (some DPU runs): the
// DRAM engine, the barrier release, the planned issue slots (none when
// the DPU itself has stopped) and the cycle's classification.
// kResident: the route (how a DMA learns the other DPUs' widths).
template <bool kResident>
__device__ __forceinline__ void step_dpu(Dpu& u, const Warp& w,
                                         const Args& args, bool running,
                                         int t) {
  const int* c = args.c;
  const int lane = w.lane, d = w.d, T = w.T, W = w.W, M = w.M;
  const bool act = w.act;
  int32_t* wram = w.wram;
  int32_t* mram = w.mram;
  const int cyc = u.cycle;

  // ---- DRAM engine: completions, FR-FCFS, MMU ----
  const bool comp = u.eng_active && u.eng_finish <= cyc;
  if (comp && lane == u.eng_thread) {
    u.status = RUN;
    u.next_issue = wadd(cyc, 1);
    u.req_valid = false;
  }
  if (comp) u.eng_active = false;
  const bool can = !u.eng_active && __any_sync(FULL, act && u.req_valid);
  if (can) {
    const int row = floordiv(u.req_mram, c[C_ROW_BYTES]);
    const int score = u.req_valid ? wsub(row == u.open_row ? INF : 0,
                                         u.req_enq)
                                  : -INF;
    const int j = argmax_first(score, act);
    const int b_j = __shfl_sync(FULL, u.req_bytes, j);
    const int m_j = __shfl_sync(FULL, u.req_mram, j);
    const int row_j = __shfl_sync(FULL, row, j);
    const bool hit_j = row_j == u.open_row;
    const int end_row = floordiv(wsub(wadd(m_j, b_j < 1 ? 1 : b_j), 1),
                                 c[C_ROW_BYTES]);
    int service = wadd(hit_j ? c[C_ROW_HIT] : c[C_ROW_MISS],
                       wmul(wsub(end_row, row_j), c[C_ROW_MISS]));
    service = wadd(service, static_cast<int>(ceilf(__fmul_rn(
                                __int2float_rn(b_j), args.inv_bw))));
    if (c[C_MMU]) {
      const int E = c[C_E];
      const int page = floordiv(m_j, c[C_PAGE_BYTES]);
      int32_t* tags = leaf<int32_t>(args, L_TLB_TAGS) + d * E;
      int32_t* lru = leaf<int32_t>(args, L_TLB_LRU) + d * E;
      int first, victim;
      match_and_lru(tags, lru, E, page, lane, &first, &victim);
      const bool t_hit = first != INT_MAX;
      __syncwarp();
      if (lane == 0) {
        const int way = t_hit ? first : victim;
        tags[way] = page;
        lru[way] = cyc;
      }
      u.cnt = wadd(u.cnt, (lane == K_TLB_HIT && t_hit)
                              + (lane == K_TLB_MISS && !t_hit));
      if (!t_hit) service = wadd(service, c[C_ROW_MISS]);
    }
    u.eng_active = true;
    u.eng_thread = j;
    u.eng_finish = wadd(cyc, service);
    u.open_row = end_row;
    u.cnt = wadd(u.cnt, (lane == K_ROW_HIT && hit_j)
                            + (lane == K_ROW_MISS && !hit_j));
  }

  // ---- barrier release ----
  {
    const unsigned bar = __ballot_sync(FULL, act && u.status == BLK_BAR);
    const unsigned alive = __ballot_sync(FULL, act && u.status != DONE);
    if (bar != 0 && __popc(bar) == __popc(alive) && act
        && u.status == BLK_BAR) {
      u.status = RUN;
      u.next_issue = wadd(cyc, 1);
    }
  }
  const int n_ready0 = __popc(__ballot_sync(
      FULL, act && u.status == RUN && u.next_issue <= cyc));

  // ---- issue slots ----
  bool issued_any = false;
#pragma unroll 1
  for (int s = 0; running && s < w.SS; ++s) {
    if (!w.splan[s * 3]) continue;  // uniform: nothing of the slot runs
    issued_any = true;
    const int tsel = w.splan[s * 3 + 1];
    const Instr in = fetch(args.image, w.splan[s * 3 + 2]);
    const int pcv = __shfl_sync(FULL, u.pc, tsel);
    const int32_t* rf = w.sregs + tsel * NREGS;
    const int a = rf[in.ra], breg = rf[in.rb], rd_old = rf[in.rd];
    const int spc = rf[in.spc];
    const int b = in.f(B_UIV) ? in.imm : breg;
    const int addr = wadd(a, in.imm);
    const int widx = clampi(addr >> 2, 0, W - 1);
    const int ldval = in.f(B_LW) ? wram[widx] : 0;
    const int ld_dest = __shfl_sync(FULL, u.last_dest, tsel);
    const int ld_ready = __shfl_sync(FULL, u.last_ready, tsel);
    const int res = in.f(B_ALU) ? alu_exec_one(in.op, a, b)
                    : in.f(B_LW) ? ldval
                    : in.f(B_JAL) ? wadd(pcv, 1) : spc;
    __syncwarp();  // every lane has read before any lane writes
    if (lane == 0) {
      if (in.f(B_WRD)) w.sregs[tsel * NREGS + in.rd] = res;
      if (in.f(B_SW)) wram[widx] = breg;
    }
    const bool sel = lane == tsel;

    // cache-centric mode: LW/SW through the D$ timing model
    if (c[C_CACHE] && in.f(B_MEM)) {
      const int ways = c[C_WAYS], line_bytes = c[C_LINE_BYTES];
      const int line = floordiv(addr, line_bytes);
      const int set = remainder(line, c[C_NSETS]);
      const size_t base = (static_cast<size_t>(d) * c[C_NSETS] + set) * ways;
      int32_t* tags = leaf<int32_t>(args, L_DC_TAGS) + base;
      int32_t* lru = leaf<int32_t>(args, L_DC_LRU) + base;
      uint8_t* dirty = leaf<uint8_t>(args, L_DC_DIRTY) + base;
      int first, victim;
      match_and_lru(tags, lru, ways, line, lane, &first, &victim);
      const bool hit = first != INT_MAX;
      const int way = hit ? first : victim;
      const bool vic_dirty = dirty[victim] != 0 && tags[victim] >= 0;
      const bool way_dirty = dirty[way] != 0;
      const int fill_bytes = line_bytes + (vic_dirty ? line_bytes : 0);
      __syncwarp();
      if (lane == 0) {
        tags[way] = line;
        lru[way] = cyc;
        dirty[way] = hit ? (way_dirty || in.f(B_SW)) : in.f(B_SW);
      }
      if (!hit && sel) {
        u.status = BLK_DMA;
        u.req_valid = true;
        u.req_mram = wmul(line, line_bytes);
        u.req_bytes = fill_bytes;
        u.req_write = false;
        u.req_enq = cyc;
      }
      u.cnt = wadd(u.cnt, (lane == K_DC_HIT && hit)
                              + (lane == K_DC_MISS && !hit));
    }

    // atomics
    bool acq_retry = false;
    if (in.f(B_ACQ) || in.f(B_REL)) {
      int32_t* at = leaf<int32_t>(args, L_ATOMIC) + d * c[C_A]
                    + clampi(in.imm, 0, c[C_A] - 1);
      const int aold = *at;
      acq_retry = in.f(B_ACQ) && aold != 0;
      __syncwarp();
      if (lane == 0) *at = in.f(B_ACQ) ? (aold != 0 ? aold : 1) : 0;
    }

    // DMA: latch the request, copy now (timing is the DRAM engine's)
    int size = 0;
    if (in.f(B_DMA)) {
      const bool st = in.f(B_SDMA);
      size = clampi(in.f(B_UIV) ? in.imm : rd_old, 0, MAX_DMA_BYTES);
      if (sel) {
        u.status = BLK_DMA;
        u.req_valid = true;
        u.req_wram = a;
        u.req_mram = breg;
        u.req_bytes = size;
        u.req_write = st;
        u.req_enq = cyc;
      }
      // The copy window is small_dma_words, or 512 if any DPU's DMA of
      // this slot is wider; a clipped run of lanes writes its winner's
      // value (the last lane at the top, lane -base at the bottom).  Only
      // a DMA of exactly small_dma_words that reaches the last word or
      // lies small_dma_words below word 0 writes differently in the two
      // windows; every other DMA uses the narrow one, with the result of
      // either.
      const int small = w.small;
      const int wb0 = a >> 2, mb0 = breg >> 2, sw = (size + 3) >> 2;
      const int b0 = st ? mb0 : wb0, top = st ? M - 1 : W - 1;
      int nw = small;
      if (small < MAX_DMA_WORDS) {
        if (sw > small)
          nw = MAX_DMA_WORDS;
        else if (sw == small && (b0 + small - 1 >= top || b0 <= -small)
                 && (kResident
                         ? wide_anywhere(args, w, args.base + t, t, s)
                         : ((__ldcg(args.wide + t) >> s) & 1u)))
          nw = MAX_DMA_WORDS;
      }
      const int last = nw - 1;
      for (int k = lane; k < nw; k += 32) {
        const int wc = clampi(wb0 + k, 0, W - 1);
        const int mc = clampi(mb0 + k, 0, M - 1);
        if (!st) {
          const int rep = wc == W - 1 ? last
                          : wc == 0 ? min(-wb0, last) : k;
          if (rep == k && k < sw) wram[wc] = mram[mc];
        } else {
          const int rep = mc == M - 1 ? last
                          : mc == 0 ? min(-mb0, last) : k;
          if (rep == k && k < sw) mram[mc] = wram[wc];
        }
      }
    }

    // control flow
    bool taken;
    switch (in.bidx) {
      case 0: taken = a == b; break;
      case 1: taken = a != b; break;
      case 2: taken = a < b; break;
      case 3: taken = a >= b; break;
      case 4: taken = static_cast<uint32_t>(a) < static_cast<uint32_t>(b);
        break;
      default:
        taken = static_cast<uint32_t>(a) >= static_cast<uint32_t>(b);
    }
    const int pc1 = wadd(pcv, 1);
    const int new_pc = in.f(B_BR) ? (taken ? in.imm : pc1)
                       : in.f(B_JMP) ? in.imm
                       : in.f(B_JR) ? a
                       : (acq_retry || in.f(B_STOP)) ? pcv : pc1;

    // issue gap: revolver / forwarding / long ops
    int nxt;
    if (c[C_FWD]) {
      const bool raw = ld_dest >= 0
                       && ((in.f(B_RD_RA) && in.ra == ld_dest)
                           || (in.f(B_RB_DEP) && in.rb == ld_dest));
      nxt = max(wadd(cyc, 1), raw ? ld_ready : 0);
    } else {
      nxt = wadd(cyc, c[C_REVOLVER]);
    }
    if (sel) {
      u.pc = new_pc;
      if (in.f(B_STOP)) u.status = DONE;
      else if (in.f(B_BAR)) u.status = BLK_BAR;
      u.next_issue = wadd(nxt, in.extra);
      u.last_dest = in.f(B_WRD) ? in.rd : -1;
      u.last_ready = wadd(cyc, in.lat);
    }
    // odd/even RF structural hazard: +2, the end-of-cycle decrement
    // leaves the port busy for exactly the next cycle
    if (!c[C_URF] && in.f(B_TWO) && (in.ra & 1) == (in.rb & 1))
      u.port_busy += 2;
    u.rr = (tsel + 1) % T;

    const bool rd_dma = in.f(B_DMA) && !in.f(B_SDMA);
    const bool wr_dma = in.f(B_DMA) && in.f(B_SDMA);
    u.cnt = wadd(u.cnt, (lane == K_ISSUED) + (lane == K_CLS + in.cls)
                            + (lane == K_ACQ_RETRY && acq_retry)
                            + (lane == K_DMA_RD && rd_dma)
                            + (lane == K_DMA_WR && wr_dma));
    if ((lane == F_RD_BYTES && rd_dma) || (lane == F_WR_BYTES && wr_dma))
      u.fcnt = __fadd_rn(u.fcnt, __int2float_rn(size));
    __syncwarp();
  }

  // ---- classify the cycle and advance ----
  const int ni = __reduce_min_sync(
      FULL, act ? (u.status == RUN ? u.next_issue : INF) : INT_MAX);
  const int df = u.eng_active ? u.eng_finish : INF;
  const int nxt = min(ni, df);
  const bool port_blocked = u.port_busy > 0;
  const bool idle = running && !issued_any;
  const int cyc_p1 = wadd(cyc, 1);
  int new_cycle = cyc;
  if (running) {
    new_cycle = (c[C_SKIP] && idle && !port_blocked && nxt < INF)
                ? max(cyc_p1, nxt) : cyc_p1;
  }
  const int delta = wsub(new_cycle, cyc);
  const bool rf = idle && port_blocked && n_ready0 > 0;
  const bool mem = idle && !rf && df <= ni;
  const bool rev = idle && !rf && !mem;
  if (c[C_DETAIL]) {
    if (running) {
      const int h = clampi(n_ready0, 0, T);
      if (h == 32) u.hist32 = wadd(u.hist32, 1);
      else if (lane == h) u.hist = wadd(u.hist, 1);
      if (lane == 0) u.hist = wadd(u.hist, wsub(delta, 1));
    }
    if (lane == F_TS_ACC) {
      u.fcnt = __fadd_rn(u.fcnt, __int2float_rn(n_ready0));
      const int win = c[C_WIN];
      const int w_old = floordiv(cyc, win);
      if (floordiv(new_cycle, win) > w_old) {
        leaf<float>(args, L_TS_BUF)[d * c[C_L]
                                    + clampi(w_old, 0, c[C_L] - 1)] =
            __fmul_rn(u.fcnt, args.inv_win);
        u.fcnt = 0.f;
      }
    }
  }
  u.cycle = new_cycle;
  u.port_busy -= port_blocked;
  // one counter a lane: at most one of these terms is not 0
  u.cnt = wadd(u.cnt, (lane == K_ACTIVE && issued_any)
                          + ((lane == K_IDLE_MEM && mem) ? delta : 0)
                          + ((lane == K_IDLE_REV && rev) ? delta : 0)
                          + ((lane == K_IDLE_RF && rf) ? delta : 0));
}

// The largest vote of every warp of the launch: one block barrier and,
// with more than one block, one grid barrier.
__device__ __forceinline__ int vote_max(int v, uint32_t* partial) {
  __shared__ int s_vote[DPB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_vote[warp] = v;
  __syncthreads();
  int b = lane < static_cast<int>(blockDim.x >> 5) ? s_vote[lane] : 0;
  b = __reduce_max_sync(FULL, b);
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) partial[blockIdx.x] = b;
    cg::this_grid().sync();
    int g = 0;
    for (unsigned i = lane; i < gridDim.x; i += 32)
      g = max(g, static_cast<int>(__ldcg(partial + i)));
    b = __reduce_max_sync(FULL, g);
  }
  return b;
}

// This warp's DPU: set up `w` and load `u` (the register file into
// shared memory).  Returns false for a warp past the last DPU, which gets
// a stopped DPU and must store nothing.
__device__ __forceinline__ bool load_dpu(const Args& args, int32_t* smem,
                                         Warp& w, Dpu& u) {
  const int* c = args.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dpb = blockDim.x >> 5;
  const int d = blockIdx.x * dpb + warp;
  const int T = c[C_T], W = c[C_W], M = c[C_M];
  const bool live = d < c[C_D];
  w.lane = lane;
  w.d = d;
  w.T = T;
  w.W = W;
  w.M = M;
  w.D = c[C_D];
  w.P = c[C_P];
  w.small = c[C_SMALL];
  w.SS = c[C_SS];
  w.act = lane < T;
  w.wram = leaf<int32_t>(args, L_WRAM) + static_cast<size_t>(d) * W;
  w.mram = leaf<int32_t>(args, L_MRAM) + static_cast<size_t>(d) * M;
  w.sregs = smem + warp * T * NREGS;
  w.splan = smem + dpb * T * NREGS + warp * MAX_SLOTS * 3;

  u = Dpu{};
  u.status = DONE;
  u.last_dest = -1;
  u.open_row = -1;
  if (live) {
    const int i = d * T + lane;
    if (w.act) {
      u.pc = leaf<int32_t>(args, L_PC)[i];
      u.status = leaf<int32_t>(args, L_STATUS)[i];
      u.next_issue = leaf<int32_t>(args, L_NEXT_ISSUE)[i];
      u.last_dest = leaf<int32_t>(args, L_LAST_DEST)[i];
      u.last_ready = leaf<int32_t>(args, L_LAST_READY)[i];
      u.req_valid = leaf<uint8_t>(args, L_REQ_VALID)[i] != 0;
      u.req_wram = leaf<int32_t>(args, L_REQ_WRAM)[i];
      u.req_mram = leaf<int32_t>(args, L_REQ_MRAM)[i];
      u.req_bytes = leaf<int32_t>(args, L_REQ_BYTES)[i];
      u.req_write = leaf<uint8_t>(args, L_REQ_WRITE)[i] != 0;
      u.req_enq = leaf<int32_t>(args, L_REQ_ENQ)[i];
    }
    u.cycle = leaf<int32_t>(args, L_CYCLE)[d];
    u.port_busy = leaf<int32_t>(args, L_PORT_BUSY)[d];
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
    if (lane == F_TS_ACC) u.fcnt = leaf<float>(args, L_TS_ACC)[d];
    const int32_t* h = leaf<int32_t>(args, L_C_HIST) + d * (T + 1);
    if (lane <= T) u.hist = h[lane];
    if (T == 32) u.hist32 = h[32];
    const int32_t* r = leaf<int32_t>(args, L_REGS) + d * T * NREGS;
    for (int k = lane; k < T * NREGS; k += 32) w.sregs[k] = r[k];
  }
  __syncwarp();
  return live;
}

// Store this warp's DPU back (a live warp only).
__device__ __forceinline__ void store_dpu(const Args& args, const Warp& w,
                                          const Dpu& u) {
  const int lane = w.lane, d = w.d, T = w.T;
  const int i = d * T + lane;
  if (w.act) {
    leaf<int32_t>(args, L_PC)[i] = u.pc;
    leaf<int32_t>(args, L_STATUS)[i] = u.status;
    leaf<int32_t>(args, L_NEXT_ISSUE)[i] = u.next_issue;
    leaf<int32_t>(args, L_LAST_DEST)[i] = u.last_dest;
    leaf<int32_t>(args, L_LAST_READY)[i] = u.last_ready;
    leaf<uint8_t>(args, L_REQ_VALID)[i] = u.req_valid;
    leaf<int32_t>(args, L_REQ_WRAM)[i] = u.req_wram;
    leaf<int32_t>(args, L_REQ_MRAM)[i] = u.req_mram;
    leaf<int32_t>(args, L_REQ_BYTES)[i] = u.req_bytes;
    leaf<uint8_t>(args, L_REQ_WRITE)[i] = u.req_write;
    leaf<int32_t>(args, L_REQ_ENQ)[i] = u.req_enq;
  }
  if (lane == 0) {
    leaf<int32_t>(args, L_CYCLE)[d] = u.cycle;
    leaf<int32_t>(args, L_PORT_BUSY)[d] = u.port_busy;
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
  if (lane == F_TS_ACC) leaf<float>(args, L_TS_ACC)[d] = u.fcnt;
  int32_t* h = leaf<int32_t>(args, L_C_HIST) + d * (T + 1);
  if (lane <= T) h[lane] = u.hist;
  if (T == 32 && lane == 0) h[32] = u.hist32;
  int32_t* r = leaf<int32_t>(args, L_REGS) + d * T * NREGS;
  for (int k = lane; k < T * NREGS; k += 32) r[k] = w.sregs[k];
}

// K steps of every DPU.  Phase 1: each warp steps its DPU while the DPU
// runs (then `go` is true whatever the others do), publishing each
// step's issue plan; a DMA whose result depends on the other DPUs' DMAs
// of its slot waits for their plans.  One vote over the launch then
// gives G, the first step at which no DPU runs, and the predicate after
// the launch.  Phase 2: a DPU that stopped at step s < G takes steps
// s..G-1 with go = true and nothing to issue (it still retires DMAs,
// releases barriers, drains its port and accumulates the time series).
// (at least 4 blocks an SM: at most 128 registers a thread.  It keeps its
// own copy of load_dpu's and store_dpu's code: built from those two, ptxas
// gives it 99 registers instead of 111 and it runs ~1% slower.)
__global__ void __launch_bounds__(DPB * 32, 4)
cycle_step_kernel(const Args args) {
  const int* c = args.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dpb = blockDim.x >> 5;
  const int d = blockIdx.x * dpb + warp;
  const int T = c[C_T], W = c[C_W], M = c[C_M], K = c[C_K];
  const bool live = d < c[C_D];

  extern __shared__ int32_t smem[];
  Warp w;
  w.lane = lane;
  w.d = d;
  w.T = T;
  w.W = W;
  w.M = M;
  w.D = c[C_D];
  w.P = c[C_P];
  w.small = c[C_SMALL];
  w.SS = c[C_SS];
  w.act = lane < T;
  w.wram = leaf<int32_t>(args, L_WRAM) + static_cast<size_t>(d) * W;
  w.mram = leaf<int32_t>(args, L_MRAM) + static_cast<size_t>(d) * M;
  w.sregs = smem + warp * T * NREGS;
  w.splan = smem + dpb * T * NREGS + warp * MAX_SLOTS * 3;

  // ---- load the state of this warp's DPU ----
  Dpu u{};
  u.status = DONE;
  u.last_dest = -1;
  u.open_row = -1;
  if (live) {
    const int i = d * T + lane;
    if (w.act) {
      u.pc = leaf<int32_t>(args, L_PC)[i];
      u.status = leaf<int32_t>(args, L_STATUS)[i];
      u.next_issue = leaf<int32_t>(args, L_NEXT_ISSUE)[i];
      u.last_dest = leaf<int32_t>(args, L_LAST_DEST)[i];
      u.last_ready = leaf<int32_t>(args, L_LAST_READY)[i];
      u.req_valid = leaf<uint8_t>(args, L_REQ_VALID)[i] != 0;
      u.req_wram = leaf<int32_t>(args, L_REQ_WRAM)[i];
      u.req_mram = leaf<int32_t>(args, L_REQ_MRAM)[i];
      u.req_bytes = leaf<int32_t>(args, L_REQ_BYTES)[i];
      u.req_write = leaf<uint8_t>(args, L_REQ_WRITE)[i] != 0;
      u.req_enq = leaf<int32_t>(args, L_REQ_ENQ)[i];
    }
    u.cycle = leaf<int32_t>(args, L_CYCLE)[d];
    u.port_busy = leaf<int32_t>(args, L_PORT_BUSY)[d];
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
    if (lane == F_TS_ACC) u.fcnt = leaf<float>(args, L_TS_ACC)[d];
    const int32_t* h = leaf<int32_t>(args, L_C_HIST) + d * (T + 1);
    if (lane <= T) u.hist = h[lane];
    if (T == 32) u.hist32 = h[32];
    const int32_t* r = leaf<int32_t>(args, L_REGS) + d * T * NREGS;
    for (int k = lane; k < T * NREGS; k += 32) w.sregs[k] = r[k];
  }
  __syncwarp();

  // ---- phase 1: this DPU's steps while it runs ----
  int stop = 0;          // the first step of the launch it does not run
  bool run_end = false;  // still running after the launch's K steps
  if (live) {
    for (stop = 0; stop < K; ++stop) {
      if (!dpu_running(u, w, c)) break;
      const uint32_t bits = plan(u, w, args);
      if (lane == 0) {
        if (bits) atomicOr(args.wide + stop, bits);
        __threadfence();
        *reinterpret_cast<volatile long long*>(args.prog + d) =
            args.base + stop + 1;
      }
      __syncwarp();
      step_dpu<true>(u, w, args, true, stop);
    }
    run_end = stop == K && dpu_running(u, w, c);
    if (!run_end && lane == 0) {  // it will not run again
      __threadfence();
      *reinterpret_cast<volatile long long*>(args.prog + d) = kStopped;
    }
  }

  // ---- G and the predicate: one vote over the launch ----
  const int vote = vote_max(live ? 2 * stop + run_end : 0, args.partial);
  const int G = vote >> 1;

  // ---- phase 2: go was true up to step G for the DPUs that stopped ----
  if (live) {
    for (int t = stop; t < G; ++t) step_dpu<true>(u, w, args, false, t);
  }

  // ---- store the state back ----
  if (live) {
    const int i = d * T + lane;
    if (w.act) {
      leaf<int32_t>(args, L_PC)[i] = u.pc;
      leaf<int32_t>(args, L_STATUS)[i] = u.status;
      leaf<int32_t>(args, L_NEXT_ISSUE)[i] = u.next_issue;
      leaf<int32_t>(args, L_LAST_DEST)[i] = u.last_dest;
      leaf<int32_t>(args, L_LAST_READY)[i] = u.last_ready;
      leaf<uint8_t>(args, L_REQ_VALID)[i] = u.req_valid;
      leaf<int32_t>(args, L_REQ_WRAM)[i] = u.req_wram;
      leaf<int32_t>(args, L_REQ_MRAM)[i] = u.req_mram;
      leaf<int32_t>(args, L_REQ_BYTES)[i] = u.req_bytes;
      leaf<uint8_t>(args, L_REQ_WRITE)[i] = u.req_write;
      leaf<int32_t>(args, L_REQ_ENQ)[i] = u.req_enq;
    }
    if (lane == 0) {
      leaf<int32_t>(args, L_CYCLE)[d] = u.cycle;
      leaf<int32_t>(args, L_PORT_BUSY)[d] = u.port_busy;
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
    if (lane == F_TS_ACC) leaf<float>(args, L_TS_ACC)[d] = u.fcnt;
    int32_t* h = leaf<int32_t>(args, L_C_HIST) + d * (T + 1);
    if (lane <= T) h[lane] = u.hist;
    if (T == 32 && lane == 0) h[32] = u.hist32;
    int32_t* r = leaf<int32_t>(args, L_REGS) + d * T * NREGS;
    for (int k = lane; k < T * NREGS; k += 32) r[k] = w.sregs[k];
  }
  if (blockIdx.x == 0) {
    // every DPU has passed phase 1: the next launch starts from no votes
    for (int t = threadIdx.x; t < K; t += blockDim.x) args.wide[t] = 0;
    if (threadIdx.x == 0) *args.flag = vote & 1;
  }
}

// Stepwise route, the plan launch of step t < K: each running DPU ORs
// its issue plan's wide bits and kGo into wide[t].  At t == K (after the
// launch's last step) each running DPU ORs 1 into `flag` instead.
__global__ void __launch_bounds__(DPB * 32)
cycle_plan_kernel(const Args args, int t) {
  extern __shared__ int32_t smem[];
  Warp w;
  Dpu u;
  if (!load_dpu(args, smem, w, u) || !dpu_running(u, w, args.c)) return;
  if (t == args.c[C_K]) {
    if (w.lane == 0) atomicOr(args.flag, 1);
    return;
  }
  const uint32_t bits = plan(u, w, args);
  if (w.lane == 0) atomicOr(args.wide + t, bits | kGo);
}

// Stepwise route, the run launch of step t: with go (wide[t] & kGo) every
// DPU takes the step as step_dpu does on the resident route, reading
// the plan launch's wide bits; without it the step is gated off.
__global__ void __launch_bounds__(DPB * 32)
cycle_run_kernel(const Args args, int t) {
  if (!(__ldcg(args.wide + t) & kGo)) return;
  extern __shared__ int32_t smem[];
  Warp w;
  Dpu u;
  if (!load_dpu(args, smem, w, u)) return;
  const bool running = dpu_running(u, w, args.c);
  if (running) plan(u, w, args);
  step_dpu<false>(u, w, args, running, t);
  store_dpu(args, w, u);
}

size_t smem_bytes(int dpb, int T) {
  return static_cast<size_t>(dpb) * (T * NREGS + MAX_SLOTS * 3) * 4;
}

}  // namespace

extern "C" {

// Limits the Python side checks before it builds a launch.
int cycle_step_max_slots() { return MAX_SLOTS; }
int cycle_step_dpus_per_block() { return DPB; }
int cycle_step_n_leaves() { return N_LEAVES; }
int cycle_step_n_config() { return N_CFG; }
int cycle_step_n_fields() { return N_FIELDS; }
int cycle_step_args_bytes() { return static_cast<int>(sizeof(Args)); }

// The most DPUs of T tasklets one launch can take on the current device:
// DPB a block times the blocks that can be resident at once.  Returns
// minus the cudaError_t on failure.
int cycle_step_max_dpus(int T) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cycle_step_kernel, DPB * 32, smem_bytes(DPB, T));
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms * DPB;
}

static bool args_ok(const Args* args) {
  const int D = args->c[C_D], T = args->c[C_T];
  return D >= 1 && T >= 1 && T <= 32 && args->c[C_SS] >= 1
         && args->c[C_SS] <= MAX_SLOTS && args->c[C_K] >= 1;
}

// Launch K steps (args->c[C_K]) over args->c[C_D] DPUs, DPB DPUs (warps)
// a block (fewer when there are fewer DPUs), on `stream`.  One block: an
// ordinary launch; more: a cooperative launch (refused unless every
// block is resident).  Returns the cudaError_t as int.
// (`args` points at a struct Args: a C type keeps the symbol external.)
int cycle_step_launch(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  if (!args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  const int D = args->c[C_D], T = args->c[C_T];
  const int dpb = D < DPB ? D : DPB;
  const unsigned grid = (D + dpb - 1) / dpb;
  const size_t smem = smem_bytes(dpb, T);  // < 48 KiB: no opt-in needed
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 1) {
    cycle_step_kernel<<<1, dpb * 32, smem, s>>>(*args);
  } else {
    Args copy = *args;
    void* params[] = {&copy};
    cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(cycle_step_kernel), dim3(grid),
        dim3(dpb * 32), params, smem, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The stepwise route of the same K steps, for any number of DPUs: a plan
// and a run launch a step, a vote launch for the predicate, all ordinary
// launches on `stream`; leaves wide zero, as the resident route does.
// Returns the first cudaError_t as int.
int cycle_step_launch_stepwise(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  if (!args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  const int D = args->c[C_D], T = args->c[C_T], K = args->c[C_K];
  const int dpb = D < DPB ? D : DPB;
  const unsigned grid = (D + dpb - 1) / dpb;
  const size_t smem = smem_bytes(dpb, T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  for (int t = 0; t < K && e == cudaSuccess; ++t) {
    cycle_plan_kernel<<<grid, dpb * 32, smem, s>>>(*args, t);
    cycle_run_kernel<<<grid, dpb * 32, smem, s>>>(*args, t);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess)
    e = cudaMemsetAsync(args->flag, 0, sizeof(int32_t), s);
  if (e == cudaSuccess) {
    cycle_plan_kernel<<<grid, dpb * 32, smem, s>>>(*args, K);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess)
    e = cudaMemsetAsync(args->wide, 0, sizeof(uint32_t) * K, s);
  return static_cast<int>(e);
}

}  // extern "C"
