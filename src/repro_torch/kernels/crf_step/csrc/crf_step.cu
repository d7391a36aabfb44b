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
//   SRF[r]; MRAM stays in device memory, read and written one burst of
//   hbm_lanes words a bank operand;
// * each command: the operands decoded from its code (kind in the top
//   byte, index below), the three-access open-row timing (a, then b, then
//   the destination, each BANK operand a hit or a miss plus the burst
//   transfer), the writeback by destination kind (a bank write drops the
//   columns past the end of MRAM; a read clamps them), JUMP's single loop
//   counter, the counters;
// * the banks depend on each other only through `go` (some bank runs): a
//   bank past max_cycles that is not DONE keeps executing while another
//   bank runs.  A launch is two ordinary kernels: crf_run_kernel steps
//   each bank while it runs, up to K commands, and votes 2 * (steps it
//   ran) + (still running) into vote[parity]; crf_tail_kernel reads G =
//   vote >> 1, the first step at which no bank ran, and gives each bank
//   that stopped earlier its steps up to G (a bank that is not DONE
//   executes them), then writes the predicate into flag[parity] and
//   clears the other parity's vote for the next launch.
//
// What bounds it: a command moves at most 3 x hbm_lanes words of MRAM a
// bank; the chain of a command (decode, three reads, writeback) is a few
// dozen dependent instructions and L2 accesses, so latency, not bytes.
//
// Integer arithmetic wraps through uint32_t; float32 counters use
// __fadd_rn / __fmul_rn.  Built by repro_torch/kernels/build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -shared, plain C interface)
// and called through ctypes.
#include <cuda_runtime.h>

#include <cstdint>

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
  const int32_t* image;  // (P, 8): op, dst, a, b, target, 3 pad words
  int32_t* stop;         // (D,): steps each bank ran in this launch's phase 1
  int32_t* vote;         // (2,): max over banks of 2 * stop + still running
  // (2,) in pinned host memory the card writes: the termination predicate
  // after a launch of parity p in flag[p]
  int32_t* flag;
  int32_t parity;        // which vote and flag this launch uses
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

// One command of this bank with go = true (some bank runs).
__device__ void step_bank(Bank& b, const Args& args) {
  const int* c = args.c;
  const int lane = b.lane, W = b.W;
  const int4 in = __ldg(reinterpret_cast<const int4*>(
      args.image + clampi(b.pc, 0, b.P - 1) * 8));
  const int op = in.x, dst = in.y, a = in.z, bb = in.w;
  const int tgt = __ldg(args.image + clampi(b.pc, 0, b.P - 1) * 8 + 4);
  const bool run_m = b.status == RUN;
  const bool is_mov = op == MOV || op == FILL;
  const bool is_compute = is_mov || op == ADD || op == MUL || op == MAC;
  const bool uses_b = op == ADD || op == MUL || op == MAC;

  const int va = read_op(b, a), vb = read_op(b, bb), vd = read_op(b, dst);
  const int res = is_mov ? va
                  : op == ADD ? wadd(va, vb)
                  : op == MUL ? wmul(va, vb) : wadd(vd, wmul(va, vb));

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

// Phase 1: each warp steps its bank while the bank runs, at most K steps.
__global__ void __launch_bounds__(DPB * 32) crf_run_kernel(const Args args) {
  Bank b;
  if (!load_bank(args, b)) return;
  const int K = args.c[C_K];
  int stop = 0;
  while (stop < K && bank_running(b, args.c)) {
    step_bank(b, args);
    ++stop;
  }
  const bool run_end = stop == K && bank_running(b, args.c);
  store_bank(args, b);
  if (b.lane == 0) {
    args.stop[b.d] = stop;
    atomicMax(args.vote + args.parity, 2 * stop + run_end);
  }
}

// Phase 2: go was true up to step G; each bank that stopped earlier takes
// its steps up to G (one that is not DONE still executes).  Then the
// predicate, and the other parity's vote cleared.
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
  for (int t = __ldcg(args.stop + d); t < G; ++t) step_bank(b, args);
  store_bank(args, b);
}

}  // namespace

extern "C" {

// Layout checks the Python side makes before it builds a launch.
int crf_step_dpus_per_block() { return DPB; }
int crf_step_n_leaves() { return N_LEAVES; }
int crf_step_n_config() { return N_CFG; }
int crf_step_args_bytes() { return static_cast<int>(sizeof(Args)); }

// Launch K commands (args->c[C_K]) of args->c[C_D] banks on `stream`: the
// run kernel and the tail kernel, DPB banks (warps) a block.  Returns the
// first cudaError_t as int.  (`args` points at a struct Args.)
int crf_step_launch(const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  const int D = args->c[C_D], W = args->c[C_W];
  if (D < 1 || W < 1 || W > 32 || args->c[C_K] < 1 || args->c[C_P] < 1
      || (args->parity & ~1) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dpb = D < DPB ? D : DPB;
  const unsigned grid = (D + dpb - 1) / dpb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  crf_run_kernel<<<grid, dpb * 32, 0, s>>>(*args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  crf_tail_kernel<<<grid, dpb * 32, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
