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
//   in shared memory; MRAM, TLB, D$ and the time series stay in device
//   memory (L2-resident at one rank), and WRAM and the atomics too but on
//   the resident_smem route;
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
//   flag[parity], pinned host memory; the host reads launch n's flag
//   while launch n + 1 (the other parity) runs.
//
// Three routes run step_dpu, the same result bit for bit (ops.py picks):
// * resident_smem (cycle_step_smem_kernel), the main path's: one DPU a
//   block, the DPU's WRAM row and atomics in shared memory for the
//   launch (one bulk copy in, one out), so LW, SW, the atomics and the
//   WRAM side of a DMA never wait on L2.  A step's plan goes to the DPU's
//   ring in one relaxed 64-bit store, tagged with its absolute step (no
//   fence a step: a reader checks the tag); a DPU publishes kStopped,
//   after the one fence left, once it runs no more.  Slot 0's MRAM window
//   is loaded at plan time, and a window's words are all loaded before
//   any is stored.  Floor division and remainder by a power of two are a
//   shift and a mask.  Up to as many DPUs as the card holds such blocks
//   at once (396 of 64 KiB WRAM on an H100: three blocks an SM; the
//   Python side's picker counts them from cycle_step_card_limits());
// * resident (cycle_step_kernel): four DPUs a block, WRAM in device
//   memory, each step's plan published with an atomicOr and a fence; for
//   rows that do not fit in shared memory (the cache study's 8 MiB WRAM)
//   and up to cycle_step_max_dpus() DPUs (2,112 on an H100);
// * stepwise, above that, where a cooperative launch is refused: every
//   step as two ordinary launches, the kernel boundary ordering the
//   DPUs: a plan launch in which each running DPU ORs its step's wide
//   bits and `go` (kGo) into wide[t], then a run launch that reads them
//   instead of waiting.  Each launch loads its DPU's state from device
//   memory and the run launch stores it back; after the K steps one more
//   plan launch ORs the predicate into wide[K], which a one-warp launch
//   moves to flag[parity].  Speed is not its aim.
//
// What bounds it: not bytes (the state of a 64-DPU rank is ~0.7 MB, read
// and written once a launch) but the serial chain of each step, a few
// hundred dependent instructions and shared/L2 accesses.  A build with
// -DSTEP_SECTIONS sums each section's clock64() cycles
// (../../step_common.cuh; tools/torch_step_profile.py --sections).
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
#include "../../step_common.cuh"

namespace cg = cooperative_groups;
using step_common::Sections;

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
  // (2,) in pinned host memory the card writes: the termination predicate
  // after a launch of parity p in flag[p] (the host reads launch n's while
  // launch n + 1 runs)
  int32_t* flag;
  // (D,): per DPU, 1 + the absolute index of the last step whose issue
  // plan it has published (resident route), or kStopped once it runs no
  // more (both resident routes)
  long long* prog;
  // (K + 1,): bit s of step t: a DMA of slot s is wide; kGo (stepwise
  // route only): some DPU runs at step t; wide[K] (stepwise): some DPU
  // runs after the launch
  uint32_t* wide;
  // (D, ring_k), resident_smem route: entry t of a DPU is its issue plan
  // of step t of the launch that wrote it last, (absolute step + 1) << 8
  // | wide bits, one relaxed 64-bit store
  unsigned long long* ring;
  long long* sections;   // (N_SECTIONS,) cycle sums (STEP_SECTIONS builds)
  long long base;        // absolute index of this launch's first step
  int32_t parity;        // which flag this launch writes
  int32_t ring_k;        // entries of a DPU's ring (>= K)
  int32_t c[N_CFG];
  float inv_bw;          // float32(1) / float32(effective_mram_bw)
  float inv_win;         // float32(1) / float32(timeseries_window)
};
constexpr long long kStopped = 0x7fffffffffffffffLL;
constexpr uint32_t kGo = 1u << 31;

// How a launch orders the DPUs (the kernel that runs step_dpu): one
// cooperative launch with WRAM in device memory, a plan and a run launch
// a step, or one cooperative launch with WRAM in shared memory.
enum Route { R_RESIDENT, R_STEPWISE, R_SMEM };

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
  int32_t* wram;   // this DPU's row (in shared memory on R_SMEM)
  int32_t* mram;
  int32_t* sregs;  // the register file, in shared memory
  int32_t* splan;  // per slot: valid, tsel, pidx
  int32_t* atomic;  // R_SMEM: this DPU's atomics row, in shared memory
  // R_SMEM: log2 of T, row_bytes, page_bytes, line_bytes, n_sets and
  // timeseries_window where they are powers of two, else -1
  int sh_T, sh_row, sh_page, sh_line, sh_sets, sh_win;
};

// floordiv and remainder of step_dpu: on R_SMEM by shift and mask where
// the divisor is a power of two (the same floor semantics)
template <int R>
__device__ __forceinline__ int fdiv(int x, int d, int sh) {
  if constexpr (R == R_SMEM) return step_common::floordiv_p2(x, d, sh);
  else return floordiv(x, d);
}
template <int R>
__device__ __forceinline__ int frem(int x, int n, int sh) {
  if constexpr (R == R_SMEM) return step_common::remainder_p2(x, n, sh);
  else return remainder(x, n);
}

// R_SMEM: the MRAM words of a slot's MRAM-to-WRAM DMA, loaded ahead of the
// copy: lane l holds word l + 32 i of the window in v[i].  `ok`: slot 0's
// window, loaded at plan time.  The plan's slot 0 in registers (its
// values are the warp's): `valid`, `tsel` and, when valid, `in`.
constexpr int WIN_REGS = MAX_DMA_WORDS / 32;
struct Window {
  int v[WIN_REGS];
  bool ok, valid;
  int tsel;
  Instr in;
};

// Issue the loads of the 512 words of the MRAM window at word mb0, each
// clamped into the row as the copy clamps it (so every address is in the
// row, and no load waits on a test); they complete while the warp goes on.
// Through L2 only: MRAM streams, and L1 keeps the instruction image.
__device__ __forceinline__ void load_window(Window& p, const int32_t* mram,
                                            int mb0, int M, int lane) {
  if (mb0 >= 0 && mb0 <= M - MAX_DMA_WORDS) {  // inside: one base address
    const int32_t* q = mram + mb0 + lane;
#pragma unroll
    for (int i = 0; i < WIN_REGS; ++i) p.v[i] = __ldcg(q + 32 * i);
  } else {
#pragma unroll
    for (int i = 0; i < WIN_REGS; ++i)
      p.v[i] = __ldcg(mram + clampi(mb0 + lane + 32 * i, 0, M - 1));
  }
}

__device__ __forceinline__ bool dpu_running(const Dpu& u, const Warp& w,
                                            const int* c) {
  return __any_sync(FULL, w.act && u.status != DONE)
         && u.cycle < c[C_MAX_CYCLES];
}

// Plan the issue slots of a running DPU's step from its own state (the
// DRAM step and the barrier release that come first only make threads
// RUN with next_issue = cycle + 1, which cannot issue this cycle).
// Returns bit s set when slot s issues a DMA wider than small_dma_words.
// R_SMEM: slot 0's plan and instruction into *p0 too.
template <int R>
__device__ __forceinline__ uint32_t plan(const Dpu& u, const Warp& w,
                                         const Args& args,
                                         Window* p0 = nullptr) {
  const int* c = args.c;
  uint32_t bits = 0;
  bool already = false, slot_block = false;
#pragma unroll 1
  for (int s = 0; s < w.SS; ++s) {
    const bool ready = w.act && u.status == RUN && u.next_issue <= u.cycle
                       && !already;
    int tsel;
    bool valid;
    if constexpr (R == R_SMEM) {
      // the first ready lane from rr on, round robin (argmin_first of the
      // priority (lane - rr) mod T, from one ballot); lane 0 if none
      const unsigned rb = __ballot_sync(FULL, ready);
      const unsigned hi = rb >> u.rr, lo = rb & ((1u << u.rr) - 1u);
      tsel = hi ? u.rr + __ffs(hi) - 1 : lo ? __ffs(lo) - 1 : 0;
      valid = u.port_busy == 0 && rb != 0 && !slot_block;
    } else {
      valid = u.port_busy == 0 && __any_sync(FULL, ready) && !slot_block;
      tsel = argmin_first(ready ? remainder(w.lane - u.rr, w.T) : INF,
                          w.act);
    }
    int pidx = __shfl_sync(FULL, u.pc, tsel);
    if (pidx < 0) pidx += w.P;  // JAX gather: wrap once, then clamp
    pidx = clampi(pidx, 0, w.P - 1);
    bool hazard = false;
    if (valid) {
      const Instr in = fetch(args.image, pidx);
      if constexpr (R == R_SMEM)
        if (s == 0) p0->in = in;
      if (in.f(B_DMA)) {
        const int size = clampi(in.f(B_UIV) ? in.imm
                                : w.sregs[tsel * NREGS + in.rd],
                                0, MAX_DMA_BYTES);
        if (((size + 3) >> 2) > w.small) bits |= 1u << s;
      }
      hazard = !c[C_URF] && in.f(B_TWO) && ((in.ra & 1) == (in.rb & 1));
    }
    if constexpr (R == R_SMEM) {
      if (s == 0) {
        p0->valid = valid;
        p0->tsel = tsel;
      }
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

// R_SMEM: the same answer from the DPUs' rings: DPU e's entry t holds its
// plan of step `step` once e has taken it (the tag is the absolute step,
// so an entry of an earlier launch never passes for this one), and e's
// prog word turns kStopped, after a fence, once e runs no more: then its
// plans of the steps it took are visible, and it takes no later one.
// (Its arguments are values, not the Args: a noinline callee would make
// the kernel copy its parameters to local memory.)
__device__ __noinline__ bool wide_ring(const unsigned long long* ring,
                                       int ring_k, const long long* prog,
                                       int D, int lane, long long step, int t,
                                       int s) {
  const unsigned long long want = static_cast<unsigned long long>(step + 1);
  uint32_t bits = 0;
  for (int e = lane; e < D; e += 32) {
    const volatile unsigned long long* r =
        ring + static_cast<size_t>(e) * ring_k + t;
    const volatile long long* p = prog + e;
    for (;;) {
      unsigned long long v = *r;
      if ((v >> 8) == want) {
        bits |= static_cast<uint32_t>(v);
        break;
      }
      if (*p == kStopped) {
        __threadfence();
        v = *r;
        if ((v >> 8) == want) bits |= static_cast<uint32_t>(v);
        break;
      }
    }
  }
  return (__reduce_or_sync(FULL, bits) >> s) & 1u;
}

// One simulated cycle of this DPU with go = true (some DPU runs): the
// DRAM engine, the barrier release, the planned issue slots (none when
// the DPU itself has stopped) and the cycle's classification.
// R: the route (where WRAM lives, how a DMA learns the other DPUs'
// widths); `pre`: R_SMEM's slot-0 MRAM window, loaded at plan time.
template <int R>
__device__ __forceinline__ void step_dpu(Dpu& u, const Warp& w,
                                         const Args& args, bool running,
                                         int t, const Window& pre,
                                         Sections& sec) {
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
    const int row = fdiv<R>(u.req_mram, c[C_ROW_BYTES], w.sh_row);
    const int score = u.req_valid ? wsub(row == u.open_row ? INF : 0,
                                         u.req_enq)
                                  : -INF;
    const int j = argmax_first(score, act);
    const int b_j = __shfl_sync(FULL, u.req_bytes, j);
    const int m_j = __shfl_sync(FULL, u.req_mram, j);
    const int row_j = __shfl_sync(FULL, row, j);
    const bool hit_j = row_j == u.open_row;
    const int end_row = fdiv<R>(wsub(wadd(m_j, b_j < 1 ? 1 : b_j), 1),
                                c[C_ROW_BYTES], w.sh_row);
    int service = wadd(hit_j ? c[C_ROW_HIT] : c[C_ROW_MISS],
                       wmul(wsub(end_row, row_j), c[C_ROW_MISS]));
    service = wadd(service, static_cast<int>(ceilf(__fmul_rn(
                                __int2float_rn(b_j), args.inv_bw))));
    if (c[C_MMU]) {
      const int E = c[C_E];
      const int page = fdiv<R>(m_j, c[C_PAGE_BYTES], w.sh_page);
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
  sec.mark(step_common::S_DRAM);

  // ---- issue slots ----
  bool issued_any = false;
#pragma unroll 1
  for (int s = 0; running && s < w.SS; ++s) {
    // uniform: nothing of the slot runs
    if (R == R_SMEM && s == 0 ? !pre.valid : !w.splan[s * 3]) continue;
    issued_any = true;
    const int tsel = R == R_SMEM && s == 0 ? pre.tsel : w.splan[s * 3 + 1];
    Instr in;
    if constexpr (R == R_SMEM)
      in = s == 0 ? pre.in : fetch(args.image, w.splan[s * 3 + 2]);
    else
      in = fetch(args.image, w.splan[s * 3 + 2]);
    const int pcv = __shfl_sync(FULL, u.pc, tsel);
    const int32_t* rf = w.sregs + tsel * NREGS;
    const int a = rf[in.ra], breg = rf[in.rb], rd_old = rf[in.rd];
    const int spc = rf[in.spc];
    const int b = in.f(B_UIV) ? in.imm : breg;
    const int addr = wadd(a, in.imm);
    const int widx = clampi(addr >> 2, 0, W - 1);
    const int ldval = in.f(B_LW) ? wram[widx] : 0;
    // (R_SMEM: only forwarding reads them)
    int ld_dest = 0, ld_ready = 0;
    if (R != R_SMEM || c[C_FWD]) {
      ld_dest = __shfl_sync(FULL, u.last_dest, tsel);
      ld_ready = __shfl_sync(FULL, u.last_ready, tsel);
    }
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
      const int line = fdiv<R>(addr, line_bytes, w.sh_line);
      const int set = frem<R>(line, c[C_NSETS], w.sh_sets);
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
      int32_t* at;
      if constexpr (R == R_SMEM)
        at = w.atomic + clampi(in.imm, 0, c[C_A] - 1);
      else
        at = leaf<int32_t>(args, L_ATOMIC) + d * c[C_A]
             + clampi(in.imm, 0, c[C_A] - 1);
      const int aold = *at;
      acq_retry = in.f(B_ACQ) && aold != 0;
      __syncwarp();
      if (lane == 0) *at = in.f(B_ACQ) ? (aold != 0 ? aold : 1) : 0;
    }

    // DMA: latch the request, copy now (timing is the DRAM engine's)
    int size = 0;
    if (in.f(B_DMA)) {
      sec.mark(step_common::S_ISSUE);
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
        else if (sw == small && (b0 + small - 1 >= top || b0 <= -small)) {
          bool wide;
          if constexpr (R == R_RESIDENT)
            wide = wide_anywhere(args, w, args.base + t, t, s);
          else if constexpr (R == R_SMEM)
            wide = wide_ring(args.ring, args.ring_k, args.prog, w.D, lane,
                             args.base + t, t, s);
          else
            wide = (__ldcg(args.wide + t) >> s) & 1u;
          if (wide) nw = MAX_DMA_WORDS;
        }
      }
      const int last = nw - 1;
      if constexpr (R == R_SMEM) {
        // every word of the window is loaded before any is stored: the
        // words a lane writes are distinct, and source and destination
        // lie in different memories
        Window v;
        if (!st) {
          if (s == 0 && pre.ok) v = pre;
          else load_window(v, mram, mb0, M, lane);
        } else {
#pragma unroll
          for (int i = 0; i < WIN_REGS; ++i)
            v.v[i] = wram[clampi(wb0 + lane + 32 * i, 0, W - 1)];
        }
        // a window inside its destination row writes word k at k (no word
        // is clipped onto an end word): one base address, no tests a word
        const int b0d = st ? mb0 : wb0, nd = st ? M : W;
        const int lim = min(nw, sw);
        if (b0d >= 0 && b0d <= nd - nw) {
          int32_t* q = (st ? mram : wram) + b0d + lane;
#pragma unroll
          for (int i = 0; i < WIN_REGS; ++i)
            if (lane + 32 * i < lim) q[32 * i] = v.v[i];
        } else {
#pragma unroll
          for (int i = 0; i < WIN_REGS; ++i) {
            const int k = lane + 32 * i;
            if (k >= lim) continue;
            const int wc = clampi(wb0 + k, 0, W - 1);
            const int mc = clampi(mb0 + k, 0, M - 1);
            if (!st) {
              const int rep = wc == W - 1 ? last
                              : wc == 0 ? min(-wb0, last) : k;
              if (rep == k) wram[wc] = v.v[i];
            } else {
              const int rep = mc == M - 1 ? last
                              : mc == 0 ? min(-mb0, last) : k;
              if (rep == k) mram[mc] = v.v[i];
            }
          }
        }
      } else {
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
      sec.mark(step_common::S_DMA);
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
    if constexpr (R == R_SMEM) u.rr = frem<R>(tsel + 1, T, w.sh_T);
    else u.rr = (tsel + 1) % T;

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
  sec.mark(step_common::S_ISSUE);
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
      const int w_old = fdiv<R>(cyc, win, w.sh_win);
      if (fdiv<R>(new_cycle, win, w.sh_win) > w_old) {
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
  sec.mark(step_common::S_CLASSIFY);
  sec.step();
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

  Sections sec;
  sec.begin_launch();
  Window none;
  none.ok = none.valid = false;

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
  sec.mark(step_common::S_LOAD);

  // ---- phase 1: this DPU's steps while it runs ----
  int stop = 0;          // the first step of the launch it does not run
  bool run_end = false;  // still running after the launch's K steps
  if (live) {
    for (stop = 0; stop < K; ++stop) {
      if (!dpu_running(u, w, c)) break;
      sec.start();
      const uint32_t bits = plan<R_RESIDENT>(u, w, args);
      if (lane == 0) {
        if (bits) atomicOr(args.wide + stop, bits);
        __threadfence();
        *reinterpret_cast<volatile long long*>(args.prog + d) =
            args.base + stop + 1;
      }
      __syncwarp();
      sec.mark(step_common::S_PLAN);
      step_dpu<R_RESIDENT>(u, w, args, true, stop, none, sec);
    }
    run_end = stop == K && dpu_running(u, w, c);
    if (!run_end && lane == 0) {  // it will not run again
      __threadfence();
      *reinterpret_cast<volatile long long*>(args.prog + d) = kStopped;
    }
  }

  // ---- G and the predicate: one vote over the launch ----
  sec.start();
  const int vote = vote_max(live ? 2 * stop + run_end : 0, args.partial);
  const int G = vote >> 1;
  sec.mark(step_common::S_VOTE);

  // ---- phase 2: go was true up to step G for the DPUs that stopped ----
  if (live) {
    for (int t = stop; t < G; ++t) {
      sec.start();
      step_dpu<R_RESIDENT>(u, w, args, false, t, none, sec);
    }
  }

  // ---- store the state back ----
  sec.start();
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
    if (threadIdx.x == 0) {
      args.flag[args.parity] = vote & 1;
      __threadfence_system();
    }
  }
  sec.mark(step_common::S_STORE);
  sec.end_launch(args.sections, live && lane == 0);
}

// Words of the resident_smem kernel's shared memory before the WRAM row:
// the register file and the issue plan (load_dpu's layout for one warp a
// block), rounded up to 16 bytes; then WRAM and the atomics, each rounded
// up to 16 bytes.
__host__ __device__ int smem_head_words(int T) {
  return (T * NREGS + MAX_SLOTS * 3 + 3) & ~3;
}
__host__ __device__ size_t smem_route_bytes(int T, int W, int A) {
  return 4 * (static_cast<size_t>(smem_head_words(T)) + ((W + 3) & ~3)
              + ((A + 3) & ~3));
}

// R_SMEM: the loads of slot 0's MRAM-to-WRAM DMA window, issued at plan
// time (the plan names the slot's tasklet and instruction, and nothing
// before slot 0 in the step changes its registers or MRAM).
__device__ __forceinline__ void prefetch_slot0(Window& p, const Warp& w) {
  p.ok = false;
  if (!p.valid || !p.in.f(B_DMA) || p.in.f(B_SDMA)) return;
  const int32_t* rf = w.sregs + p.tsel * NREGS;
  load_window(p, w.mram, rf[p.in.rb] >> 2, w.M, w.lane);
  p.ok = true;
}

// The resident_smem route: K steps of every DPU as cycle_step_kernel takes
// them, one DPU (warp) a block, with the DPU's WRAM row and atomics in
// shared memory for the launch: brought in by one bulk copy at the start
// (while the scalars load) and taken back by one at the end, so LW, SW,
// the atomics and the WRAM side of every DMA touch shared memory only.
// Each step's issue plan goes to the DPU's ring in one relaxed store (no
// fence a step); a DPU publishes kStopped, after the one fence left, once
// it runs no more.  Slot 0's MRAM window is loaded at plan time.  Floor
// division and remainder by a power of two are a shift and a mask.
// Every block must be resident (a cooperative launch past one block,
// refused otherwise).
__global__ void __launch_bounds__(32, 1)
cycle_step_smem_kernel(const Args args) {
  const int* c = args.c;
  const int d = blockIdx.x, lane = threadIdx.x;
  const int T = c[C_T], W = c[C_W], A = c[C_A], K = c[C_K];
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ __align__(8) uint64_t s_bar;
  Sections sec;
  sec.begin_launch();
  Window none;
  none.ok = none.valid = false;

  // ---- WRAM and atomics into shared memory, the scalars into registers ----
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
  w.sh_T = step_common::pow2_shift(T);
  w.sh_row = step_common::pow2_shift(c[C_ROW_BYTES]);
  w.sh_page = step_common::pow2_shift(c[C_PAGE_BYTES]);
  w.sh_line = step_common::pow2_shift(c[C_LINE_BYTES]);
  w.sh_sets = step_common::pow2_shift(c[C_NSETS]);
  w.sh_win = step_common::pow2_shift(c[C_WIN]);
  sec.mark(step_common::S_LOAD);

  // ---- phase 1: this DPU's steps while it runs ----
  int stop = 0;
  bool run_end = false;
  if (live) {
    volatile unsigned long long* ring =
        args.ring + static_cast<size_t>(d) * args.ring_k;
    for (stop = 0; stop < K; ++stop) {
      if (!dpu_running(u, w, c)) break;
      sec.start();
      Window pre;
      const uint32_t bits = plan<R_SMEM>(u, w, args, &pre);
      prefetch_slot0(pre, w);
      if (lane == 0)
        ring[stop] = (static_cast<unsigned long long>(args.base + stop + 1)
                      << 8) | bits;
      sec.mark(step_common::S_PLAN);
      step_dpu<R_SMEM>(u, w, args, true, stop, pre, sec);
    }
    run_end = stop == K && dpu_running(u, w, c);
    if (!run_end && lane == 0) {  // it will not run again
      __threadfence();
      *reinterpret_cast<volatile long long*>(args.prog + d) = kStopped;
    }
  }

  // ---- G and the predicate: one vote over the launch ----
  sec.start();
  const int vote = vote_max(live ? 2 * stop + run_end : 0, args.partial);
  const int G = vote >> 1;
  sec.mark(step_common::S_VOTE);

  // ---- phase 2 ----
  if (live) {
    for (int t = stop; t < G; ++t) {
      sec.start();
      step_dpu<R_SMEM>(u, w, args, false, t, none, sec);
    }
  }

  // ---- the state, WRAM and the atomics back ----
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

// Stepwise route, the plan launch of step t < K: each running DPU ORs
// its issue plan's wide bits and kGo into wide[t].  At t == K (after the
// launch's last step) each running DPU ORs kGo into wide[K] instead.
__global__ void __launch_bounds__(DPB * 32)
cycle_plan_kernel(const Args args, int t) {
  extern __shared__ int32_t smem[];
  Warp w;
  Dpu u;
  if (!load_dpu(args, smem, w, u) || !dpu_running(u, w, args.c)) return;
  if (t == args.c[C_K]) {
    if (w.lane == 0) atomicOr(args.wide + t, kGo);
    return;
  }
  const uint32_t bits = plan<R_STEPWISE>(u, w, args);
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
  if (running) plan<R_STEPWISE>(u, w, args);
  Window none;
  none.ok = none.valid = false;
  Sections sec;
  step_dpu<R_STEPWISE>(u, w, args, running, t, none, sec);
  store_dpu(args, w, u);
}

// Stepwise route, after the launch's steps: the predicate (wide[K]) into
// flag[parity], and wide cleared for the next launch.  One warp.
__global__ void cycle_flag_kernel(const Args args) {
  const int K = args.c[C_K];
  const uint32_t go = __ldcg(args.wide + K);
  __syncwarp();
  if (threadIdx.x == 0) {
    args.flag[args.parity] = go != 0;
    __threadfence_system();
  }
  for (int t = threadIdx.x; t <= K; t += 32) args.wide[t] = 0;
}

size_t smem_bytes(int dpb, int T) {
  return static_cast<size_t>(dpb) * (T * NREGS + MAX_SLOTS * 3) * 4;
}

}  // namespace

// A launch the runtime refused: the error, taken out of the runtime's
// last-error slot so that the next launch does not report it again.
static int refused(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

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
         && args->c[C_SS] <= MAX_SLOTS && args->c[C_K] >= 1
         && (args->parity & ~1) == 0;
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
    if (e != cudaSuccess) return refused(e);
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
  if (e == cudaSuccess) {
    cycle_plan_kernel<<<grid, dpb * 32, smem, s>>>(*args, K);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    cycle_flag_kernel<<<1, 32, 0, s>>>(*args);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

// The resident_smem route's shared memory a block (bytes) for T tasklets,
// W WRAM words and A atomic words.
int cycle_step_smem_bytes(int T, int W, int A) {
  const size_t b = smem_route_bytes(T, W, A);
  return b > static_cast<size_t>(INT_MAX) ? INT_MAX : static_cast<int>(b);
}

// What the current device allows the resident_smem kernel, into out[5]:
// SMs, the dynamic shared memory a block may opt in to, the shared memory
// of an SM, what a block takes besides its dynamic shared memory (the
// runtime's reservation and the kernel's static shared memory), and the
// kernel's blocks an SM holds with no dynamic shared memory (registers,
// the block limit).  Returns minus the cudaError_t on failure, else 0.
int cycle_step_card_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  int reserved = 0;
  cudaFuncAttributes attr{};
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
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, cycle_step_smem_kernel);
  out[3] = reserved + static_cast<int>(attr.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 4, cycle_step_smem_kernel, 32, 0);
  return e == cudaSuccess ? 0 : -static_cast<int>(e);
}

// Let the resident_smem kernel take `bytes` of dynamic shared memory (once
// for each larger size).
static cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      cycle_step_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// Launch K steps over args->c[C_D] DPUs on the resident_smem route, one
// DPU a block: an ordinary launch for one DPU, else a cooperative one
// (refused unless every block is resident).  Returns the cudaError_t as
// int.
int cycle_step_launch_smem(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  if (!args_ok(args) || args->ring == nullptr
      || args->ring_k < args->c[C_K])
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = args->c[C_D];
  const size_t smem = smem_route_bytes(args->c[C_T], args->c[C_W],
                                       args->c[C_A]);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return refused(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 1) {
    cycle_step_smem_kernel<<<1, 32, smem, s>>>(*args);
  } else {
    Args copy = *args;
    void* params[] = {&copy};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(cycle_step_smem_kernel), dim3(D),
        dim3(32), params, smem, s);
    if (e != cudaSuccess) return refused(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
