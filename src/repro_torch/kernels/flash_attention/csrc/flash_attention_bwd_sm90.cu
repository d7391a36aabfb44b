// The backward pass of blockwise (flash) attention on Hopper's tensor cores
// (wgmma), bf16 in and out, f32 accumulation: given q, k, v, the forward's
// output o, its per-row log-sum-exp lse and the output's gradient do, it
// computes dq, dk and dv, with GQA (query head h reads KV head
// h / (H / KV)), causal, bidirectional and sliding-window masks, Dk != Dv
// and S ragged to the tiles.  Dk and Dv: multiples of 16 up to 256.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// jax.value_and_grad differentiates the jnp blocked_attention
// (repro/models/attention.py) instead.  The plain version is autograd of
// ../ref.py::flash_attention_ref; flash_attention_bwd.cu (scalar FMAs)
// computes the same function and keeps float32.  Per visible (query i,
// key j), with s = q_i . k_j and c = Dk^-0.5:
//   P_ij  = exp(c s_ij - lse_i)  (0 where masked)    D_i = sum_e do_ie o_ie
//   dP_ij = do_i . v_j           dS_ij = P_ij (dP_ij - D_i)
//   dv_j += P_ij do_i            dq_i += c dS_ij k_j      dk_j += c dS_ij q_i
// One departure, rounding only: P and dS are rounded to bf16 as the A
// operands of the dv, dq and dk products (the forward already rounds P for
// P V); every sum stays in f32.
//
// What bounds it on an H100: at llama3-8b's training shape (B 1, S 4,096,
// H 32, KV 8, D 128, causal) the five useful products (S, dP, dv, dq, dk)
// over the causal half are 3.44e11 FLOPs, 0.347 ms at the bf16 tensor rate
// (989 TFLOP/s); the traffic, ~0.2 GB, takes ~0.06 ms.  Two kernels, no
// atomics (two runs give the same bits), recompute S and dP: seven
// products executed, 0.49 ms at that rate.  So every product is a wgmma
// and every operand reaches shared memory by TMA (the forward's 4-d tensor
// maps, 128-byte swizzled boxes 64 columns wide, zero fill past S and D),
// one producer thread streaming tiles through an mbarrier ring:
// * flash_bwd_dq_sm90, one CTA per (128-row query tile, head, batch), two
//   consumer warpgroups of 64 rows: D of its rows (from o and do, written
//   with lse for the other kernel), then over the visible KV tiles (kBC
//   rows; causal tiles heaviest first) S = Q K^T and dP = dO V^T (both
//   operands in shared memory, K-major as TMA leaves them), dS in
//   registers, dQ += dS K (A from registers, K read MN-major through the
//   descriptor's transpose bit: no transposed copy);
// * flash_bwd_dkdv_sm90, one CTA per (64-row KV tile, KV head, batch),
//   looping over the G query heads of the KV head and their visible query
//   tiles (heaviest KV tiles first), its two consumer warpgroups two
//   products each: warpgroup 0 S^T = K Q^T, P^T in registers, dV += P^T
//   dO; warpgroup 1 dP^T = V dO^T, dS^T, dK += dS^T Q (A from registers,
//   dO and Q MN-major), P^T passing from the one to the other through two
//   f32 shared-memory buffers (named barriers full / empty each).  The sum
//   over the G heads stays in the CTA's registers, in a fixed order.
// Registers: ptxas gives a thread of these 384-thread kernels 168 (the
// launch bound), and a warpgroup's 64 x N f32 tile takes N / 2 a thread.
// dq: dQ (Dk / 2) + S and dP (kBC / 2 each) + dS in bf16 (kBC / 8), with
// kBC 64, or 32 at Dk 192, 16 at 256: at most 148.  dkdv: dV (Dv / 2) or
// dK (Dk / 2) + S^T or dP^T (kBR / 2) + P^T or dS^T in bf16 (kBR / 8),
// with kBR query rows a tile, 64, or 32 at a width of 256: at most 152.
// (Both warpgroups holding dK and dV of their own 64 KV rows took 192 at
// D 128: spilled, wgmma serialized, 3x slower.)
// Shared memory: dq holds Q and dO of 128 rows and 2-3 stages of K and V;
// dkdv holds K and V, 2-3 stages of Q, dO and the rows' (lse, D), and the
// two P^T buffers.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3, -Xptxas -v), called through ctypes.
#include <cstdint>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;         // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBQ = 128;              // dq: query rows a CTA
constexpr int kMaxSmem = 232448;      // 227 KB per block on sm_90
constexpr int kSlack = 2048;          // barriers + 1024-byte alignment
constexpr float kLog2e = 1.4426950408889634f;

// ---- tile sizes (padded widths dk, dv: multiples of 64) --------------------
// ptxas allots a thread of these 384-thread kernels 168 registers, so every
// tile below keeps a consumer's accumulators within ~150 of them.

// KV rows a tile of the dq kernel: dQ takes dk / 2 registers, S and dP
// kbc / 2 each
__host__ __device__ constexpr int dq_bc(int dk) {
  return dk <= 128 ? 64 : dk <= 192 ? 32 : 16;
}
__host__ __device__ constexpr int dq_smem(int dk, int dv, int stages) {
  return 2 * (dk + dv) * (kBQ + stages * dq_bc(dk)) + kSlack;
}
__host__ __device__ constexpr int dq_stages(int dk, int dv) {
  return dq_smem(dk, dv, 3) <= kMaxSmem ? 3 : 2;
}

// the dkdv kernel's KV rows a CTA (both warpgroups' rows) and query rows
// a tile: the dK warpgroup holds dk / 2 registers of dK and kbr / 2 of
// dP^T, the dV warpgroup dv / 2 and kbr / 2 of S^T
constexpr int kKVRows = 64;
__host__ __device__ constexpr int kv_br(int dk, int dv) {
  return (dk > dv ? dk : dv) <= 192 ? 64 : 32;
}
__host__ __device__ constexpr int kv_smem(int dk, int dv, int stages) {
  return 2 * (dk + dv) * (kKVRows + stages * kv_br(dk, dv)) +
         stages * 2 * kv_br(dk, dv) * 4 + 2 * kv_br(dk, dv) * 256 + kSlack;
}
__host__ __device__ constexpr int kv_stages(int dk, int dv) {
  return kv_smem(dk, dv, 3) <= kMaxSmem ? 3 : 2;
}

__device__ __forceinline__ bool visible(int q, int key, int S, int causal,
                                        int window) {
  return q < S && key < S && (!causal || key <= q) &&
         (window <= 0 || q - key < window);
}

// a bf16x8 dot in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u),
               __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// k-slice kk (16 columns) of a K-major tile of `rows` rows: box kk / 4, 32
// bytes a slice along the swizzled 128-byte rows, 8-row groups 1024 apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
// k-slice kk (16 rows) of a tile of `rows` rows read MN-major: boxes of 64
// columns `rows` x 128 bytes apart (LBO), 8-row groups 1024 apart (SBO)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + kk * 16 * 128, rows * 128, 1024);
}

// an accumulator's 64 x N tile (N / 2 a thread) as N / 16 A operands of
// k-slices of 16 columns (accumulator registers 8 kk .. 8 kk + 7 are
// already in the A operand's layout)
template <int N>
__device__ __forceinline__ void to_a(const float (&acc)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[kk][u] = pack_bf16(acc[8 * kk + 2 * u], acc[8 * kk + 2 * u + 1]);
}

// this thread's part of a 64 x N f32 accumulator, times `mul`, in bf16
// into rows row0 + 8 e of a (rows x ld) tensor, columns < ncol
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           bf16* out, int64_t ld, int row,
                                           int nrow, int ncol, int col,
                                           float mul) {
#pragma unroll
  for (int j = 0; j < N / 2; j += 2) {
    const int r = row + 8 * ((j / 2) % 2), c = 8 * (j / 4) + col;
    if (r < nrow && c < ncol)
      *reinterpret_cast<uint32_t*>(out + r * ld + c) =
          pack_bf16(acc[j] * mul, acc[j + 1] * mul);
  }
}

// ---- 1. dq ---------------------------------------------------------------

// grid (B H, ceil(S / kBQ)).  rows (B H, 2, spad) f32: each row's lse
// times log2 e, then D (0 past S), written here for the dkdv kernel.
template <int kDK, int kDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ rows,
                  bf16* __restrict__ dq, int S, int H, int KV, int Dk,
                  int Dv, int causal, int window, float scale, int spad) {
  constexpr int kBC = dq_bc(kDK);
  constexpr int kStages = dq_stages(kDK, kDV);
  constexpr uint32_t kQBytes = 2 * kBQ * kDK, kOBytes = 2 * kBQ * kDV;
  constexpr uint32_t kKBytes = 2 * kBC * kDK, kVBytes = 2 * kBC * kDV;
  extern __shared__ uint8_t smem[];
  // barriers, then the tiles at the next 1024-byte boundary: Q, dO, then
  // the K/V stages (stage s: K at s_kv + s (K + V), V after it)
  const uint32_t bars = smem_u32(smem);
  const uint32_t full_q = bars;
  const uint32_t full = bars + 8;                 // + 8 s
  const uint32_t empty = full + 8 * kStages;      // + 8 s
  const uint32_t s_q = (empty + 8 * kStages + 1023) & ~1023u;
  const uint32_t s_do = s_q + kQBytes;
  const uint32_t s_kv = s_do + kOBytes;

  const int nq = gridDim.y, nk = (S + kBC - 1) / kBC;
  // causal: the last query tiles see the most keys, so they go first
  const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const int h = blockIdx.x % H, b = blockIdx.x / H, g = h / (H / KV);
  const int hi = causal ? min((q0 + kBQ - 1) / kBC + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / kBC : 0;
  const int n = hi - lo;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer: Q and dO once, then the K/V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(full_q, kQBytes + kOBytes);
#pragma unroll
      for (int c = 0; c < kDK / kBox; ++c)
        tma_load(s_q + c * kBQ * 128, &tm_q, full_q, c * kBox, h, q0, b);
#pragma unroll
      for (int c = 0; c < kDV / kBox; ++c)
        tma_load(s_do + c * kBQ * 128, &tm_do, full_q, c * kBox, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const uint32_t s_k = s_kv + s * (kKBytes + kVBytes);
        const uint32_t s_v = s_k + kKBytes;
        const int k0 = (lo + i) * kBC;
        if (i >= kStages)
          mbar_wait_bounded(empty + 8 * s, (i / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, kKBytes + kVBytes);
#pragma unroll
        for (int c = 0; c < kDK / kBox; ++c)
          tma_load(s_k + c * kBC * 128, &tm_k, full + 8 * s, c * kBox, g, k0,
                   b);
#pragma unroll
        for (int c = 0; c < kDV / kBox; ++c)
          tma_load(s_v + c * kBC * 128, &tm_v, full + 8 * s, c * kBox, g, k0,
                   b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = warp / 4;
  // this thread's two rows of the accumulators (wgmma's D layout: warp w
  // of the warpgroup holds rows 16 w .. 16 w + 15; register 4 j + e holds
  // row lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2)
  const int rr = 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int r_lo = q0 + 64 * wg;     // the warpgroup's first row
  const int row0 = r_lo + rr, row1 = row0 + 8;
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  // D = rowsum(do o) of rows row0 and row1: the row's quad splits the
  // columns in 16-byte pieces; lse in base 2
  float d0 = 0.f, d1 = 0.f;
  for (int c = 8 * (lane % 4); c < Dv; c += 32) {
    const int64_t at0 =
        ((static_cast<int64_t>(b) * S + row0) * H + h) * Dv + c;
    const int64_t at1 = at0 + 8ll * H * Dv;
    if (row0 < S)
      d0 = dot8(*reinterpret_cast<const uint4*>(o + at0),
                *reinterpret_cast<const uint4*>(dout + at0), d0);
    if (row1 < S)
      d1 = dot8(*reinterpret_cast<const uint4*>(o + at1),
                *reinterpret_cast<const uint4*>(dout + at1), d1);
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  const float l0 = row0 < S ? lse[bh * S + row0] * kLog2e : 0.f;
  const float l1 = row1 < S ? lse[bh * S + row1] * kLog2e : 0.f;
  if (lane % 4 == 0) {
    rows[bh * 2 * spad + row0] = l0;
    rows[bh * 2 * spad + row1] = l1;
    rows[(bh * 2 + 1) * spad + row0] = d0;
    rows[(bh * 2 + 1) * spad + row1] = d1;
  }

  const float scale_log2 = scale * kLog2e;
  const uint32_t a_q = s_q + 64 * wg * 128, a_do = s_do + 64 * wg * 128;
  float acc[kDK / 2];
#pragma unroll
  for (int j = 0; j < kDK / 2; ++j) acc[j] = 0.f;
  float sacc[kBC / 2], pacc[kBC / 2];
  uint32_t da[kBC / 16][4];
  mbar_wait_bounded(full_q, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const uint32_t s_k = s_kv + s * (kKBytes + kVBytes);
    const uint32_t s_v = s_k + kKBytes;
    const int k0 = (lo + i) * kBC;
    mbar_wait_bounded(full + 8 * s, (i / kStages) & 1);
    // S = Q K^T, dP = dO V^T
    fence_regs(sacc);
    fence_regs(pacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDK / 16; ++kk)
      wgmma_ss(sacc, kmajor(a_q, kBQ, kk), kmajor(s_k, kBC, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kDV / 16; ++kk)
      wgmma_ss(pacc, kmajor(a_do, kBQ, kk), kmajor(s_v, kBC, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);
    // dS = P (dP - D), P = 2^(s c log2 e - lse log2 e), 0 where masked
    const auto ds = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kBC / 2; ++j) {
        const int r = (j / 2) % 2;
        float p = ex2(fmaf(sacc[j], scale_log2, -(r ? l1 : l0)));
        if (decltype(masked)::value &&
            !visible(r ? row1 : row0, k0 + 8 * (j / 4) + col + j % 2, S,
                     causal, window))
          p = 0.f;
        sacc[j] = p * (pacc[j] - (r ? d1 : d0));
      }
    };
    if (k0 + kBC > S || r_lo + 64 > S || (causal && k0 + kBC - 1 > r_lo) ||
        (window > 0 && r_lo + 63 - k0 >= window))
      ds(std::true_type());
    else
      ds(std::false_type());
    to_a<kBC>(sacc, da);
    // dQ += dS K
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk)
      wgmma_rs(acc, da[kk], mnmajor(s_k, kBC, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  store_rows<kDK>(acc, dq + static_cast<int64_t>(b) * S * H * Dk + h * Dk,
                  static_cast<int64_t>(H) * Dk, row0, S, Dk, col, scale);
}

// ---- 2. dk, dv -----------------------------------------------------------

// grid (B KV, ceil(S / kBC)).  rows as the dq kernel left it.
template <int kDK, int kDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ rows, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, int KV, int Dk,
                    int Dv, int causal, int window, float scale, int spad) {
  constexpr int kBC = kKVRows;
  constexpr int kBR = kv_br(kDK, kDV);
  constexpr int kStages = kv_stages(kDK, kDV);
  constexpr uint32_t kKBytes = 2 * kBC * kDK, kVBytes = 2 * kBC * kDV;
  constexpr uint32_t kQBytes = 2 * kBR * kDK, kOBytes = 2 * kBR * kDV;
  constexpr uint32_t kRowBytes = 2 * kBR * 4;
  extern __shared__ uint8_t smem[];
  // barriers, then K, V, the stages (stage s: Q at s_ring + s (Q + dO),
  // dO after it), then each stage's (lse, D) rows
  const uint32_t bars = smem_u32(smem);
  const uint32_t full_kv = bars;
  const uint32_t full = bars + 8;                 // + 8 s
  const uint32_t empty = full + 8 * kStages;      // + 8 s
  const uint32_t s_k = (empty + 8 * kStages + 1023) & ~1023u;
  const uint32_t s_v = s_k + kKBytes;
  const uint32_t s_ring = s_v + kVBytes;
  const uint32_t s_rows = s_ring + kStages * (kQBytes + kOBytes);
  const uint32_t s_p = s_rows + kStages * kRowBytes;  // 2 P^T buffers
  // named barriers (0 is __syncthreads'): P^T buffer b full, empty
  constexpr int kPFull = 1, kPEmpty = 3;

  const int G = H / KV;
  const int nqt = (S + kBR - 1) / kBR;
  // causal: the first KV tiles are seen by the most queries and go first
  const int k0 = blockIdx.y * kBC;
  const int g = blockIdx.x % KV, b = blockIdx.x / KV;
  const int first = causal ? k0 / kBR : 0;
  const int last =
      window > 0 ? min((k0 + kBC - 1 + window - 1) / kBR, nqt - 1) : nqt - 1;
  const int per = last - first + 1;   // query tiles of each head
  const int n = G * per;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer: K and V once, then Q, dO and the rows of each (head, query
    // tile) through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(full_kv, kKBytes + kVBytes);
#pragma unroll
      for (int c = 0; c < kDK / kBox; ++c)
        tma_load(s_k + c * kBC * 128, &tm_k, full_kv, c * kBox, g, k0, b);
#pragma unroll
      for (int c = 0; c < kDV / kBox; ++c)
        tma_load(s_v + c * kBC * 128, &tm_v, full_kv, c * kBox, g, k0, b);
      for (int t = 0; t < n; ++t) {
        const int h = g * G + t / per, q0 = (first + t % per) * kBR;
        const int s = t % kStages;
        const uint32_t s_q = s_ring + s * (kQBytes + kOBytes);
        const uint32_t s_do = s_q + kQBytes;
        const uint32_t s_r = s_rows + s * kRowBytes;
        const float* r = rows + (static_cast<int64_t>(b) * H + h) * 2 * spad;
        if (t >= kStages)
          mbar_wait_bounded(empty + 8 * s, (t / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, kQBytes + kOBytes + kRowBytes);
#pragma unroll
        for (int c = 0; c < kDK / kBox; ++c)
          tma_load(s_q + c * kBR * 128, &tm_q, full + 8 * s, c * kBox, h, q0,
                   b);
#pragma unroll
        for (int c = 0; c < kDV / kBox; ++c)
          tma_load(s_do + c * kBR * 128, &tm_do, full + 8 * s, c * kBox, h,
                   q0, b);
        bulk_load(s_r, r + q0, kBR * 4, full + 8 * s);
        bulk_load(s_r + kBR * 4, r + spad + q0, kBR * 4, full + 8 * s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = warp / 4;
  const int rr = 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const int64_t ld = static_cast<int64_t>(KV);
  bf16* dk_out = dk + static_cast<int64_t>(b) * S * KV * Dk + g * Dk;
  bf16* dv_out = dv + static_cast<int64_t>(b) * S * KV * Dv + g * Dv;

  // kV: warpgroup 0 (S^T, P^T, dV += P^T dO); else warpgroup 1 (dP^T,
  // dS^T, dK += dS^T Q).  P^T passes from the one to the other through
  // buffer t % 2, f32, register j of thread i at j * 128 + i (both
  // warpgroups hold the same elements in the same registers).
  const auto consume = [&](auto role) {
    constexpr bool kV = decltype(role)::value;
    constexpr int kAcc = kV ? kDV / 2 : kDK / 2;
    float acc[kAcc], sacc[kBR / 2];
    uint32_t pa[kBR / 16][4];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    mbar_wait_bounded(full_kv, 0);
    for (int t = 0; t < n; ++t) {
      const int q0 = (first + t % per) * kBR;
      const int s = t % kStages;
      const uint32_t s_q = s_ring + s * (kQBytes + kOBytes);
      const uint32_t s_do = s_q + kQBytes;
      const float* lr = reinterpret_cast<const float*>(
          smem + (s_rows - bars) + s * kRowBytes);
      float* pbuf = reinterpret_cast<float*>(smem + (s_p - bars)) +
                    (t % 2) * (kBR / 2) * 128 + threadIdx.x % 128;
      mbar_wait_bounded(full + 8 * s, (t / kStages) & 1);
      // S^T = K Q^T, or dP^T = V dO^T, into sacc
      fence_regs(sacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < (kV ? kDK : kDV) / 16; ++kk)
        wgmma_ss(sacc, kmajor(kV ? s_k : s_v, kBC, kk),
                 kmajor(kV ? s_q : s_do, kBR, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sacc);
      if constexpr (kV) {
        // P^T (the columns are the query rows), handed over
        const auto probs = [&](auto masked) {
#pragma unroll
          for (int j4 = 0; j4 < kBR / 8; ++j4) {
            // registers 4 j4 .. 4 j4 + 3: columns c, c + 1 of two rows
            const int c = 8 * j4 + col;
            const float2 l2 = *reinterpret_cast<const float2*>(lr + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 4 * j4 + e;
              float p =
                  ex2(fmaf(sacc[j], scale_log2, -(e % 2 ? l2.y : l2.x)));
              if (decltype(masked)::value &&
                  !visible(q0 + c + e % 2, k0 + rr + 8 * (e / 2), S, causal,
                           window))
                p = 0.f;
              sacc[j] = p;
            }
          }
        };
        if (q0 + kBR > S || k0 + 64 > S || (causal && k0 + 63 > q0) ||
            (window > 0 && q0 + kBR - 1 - k0 >= window))
          probs(std::true_type());
        else
          probs(std::false_type());
        bar_sync(kPEmpty + t % 2, 256);
#pragma unroll
        for (int j = 0; j < kBR / 2; ++j) pbuf[j * 128] = sacc[j];
        bar_arrive(kPFull + t % 2, 256);
      } else {
        // dS^T = P^T (dP^T - D)
        bar_sync(kPFull + t % 2, 256);
#pragma unroll
        for (int j4 = 0; j4 < kBR / 8; ++j4) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(lr + kBR + 8 * j4 + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * j4 + e;
            sacc[j] = pbuf[j * 128] * (sacc[j] - (e % 2 ? d2.y : d2.x));
          }
        }
        if (t + 2 < n) bar_arrive(kPEmpty + t % 2, 256);
      }
      // dV += P^T dO, or dK += dS^T Q
      to_a<kBR>(sacc, pa);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBR / 16; ++kk)
        wgmma_rs(acc, pa[kk], mnmajor(kV ? s_do : s_q, kBR, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if constexpr (kV)
      store_rows<kDV>(acc, dv_out, ld * Dv, k0 + rr, S, Dv, col, 1.f);
    else
      store_rows<kDK>(acc, dk_out, ld * Dk, k0 + rr, S, Dk, col, scale);
  };
  if (wg == 0) {
    consume(std::true_type());
  } else {
    // both P^T buffers start empty (one arrival for each of warpgroup 0's
    // first two waits: no arrival is left over at the end)
    for (int b2 = 0; b2 < 2 && b2 < n; ++b2) bar_arrive(kPEmpty + b2, 256);
    consume(std::false_type());
  }
}

// ---- launch --------------------------------------------------------------

struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* rows;
  void *dq, *dk, *dv;
  int B, S, H, KV, Dk, Dv, causal, window;
  float scale;
  int parts;
  cudaStream_t stream;
};

// rows of the (lse, D) scratch a (batch, head): whole dq tiles
int pad_rows(int S) { return (S + kBQ - 1) / kBQ * kBQ; }

template <int kDK, int kDV>
int launch(const Call& c) {
  constexpr int kBCq = dq_bc(kDK), kBCk = kKVRows;
  constexpr int kBR = kv_br(kDK, kDV);
  constexpr int kSmemQ = dq_smem(kDK, kDV, dq_stages(kDK, kDV));
  constexpr int kSmemK = kv_smem(kDK, kDV, kv_stages(kDK, kDV));
  static_assert(kSmemQ <= kMaxSmem && kSmemK <= kMaxSmem,
                "tiles exceed shared memory");
  alignas(64) CUtensorMap tq, tdo, tk, tv, tk2, tv2, tq2, tdo2;
  if (!make_map(&tq, c.q, c.B, c.S, c.H, c.Dk, kBQ) ||
      !make_map(&tdo, c.dout, c.B, c.S, c.H, c.Dv, kBQ) ||
      !make_map(&tk, c.k, c.B, c.S, c.KV, c.Dk, kBCq) ||
      !make_map(&tv, c.v, c.B, c.S, c.KV, c.Dv, kBCq) ||
      !make_map(&tk2, c.k, c.B, c.S, c.KV, c.Dk, kBCk) ||
      !make_map(&tv2, c.v, c.B, c.S, c.KV, c.Dv, kBCk) ||
      !make_map(&tq2, c.q, c.B, c.S, c.H, c.Dk, kBR) ||
      !make_map(&tdo2, c.dout, c.B, c.S, c.H, c.Dv, kBR))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_sm90<kDK, kDV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_sm90<kDK, kDV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemK);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int spad = pad_rows(c.S);
  if (c.parts & 1) {
    flash_bwd_dq_sm90<kDK, kDV>
        <<<dim3(c.B * c.H, spad / kBQ), kThreads, kSmemQ, c.stream>>>(
            tq, tdo, tk, tv, static_cast<const bf16*>(c.o),
            static_cast<const bf16*>(c.dout), c.lse, c.rows,
            static_cast<bf16*>(c.dq), c.S, c.H, c.KV, c.Dk, c.Dv, c.causal,
            c.window, c.scale, spad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (c.parts & 2)
    flash_bwd_dkdv_sm90<kDK, kDV>
        <<<dim3(c.B * c.KV, (c.S + kBCk - 1) / kBCk), kThreads, kSmemK,
           c.stream>>>(tk2, tv2, tq2, tdo2, c.rows, static_cast<bf16*>(c.dk),
                       static_cast<bf16*>(c.dv), c.S, c.H, c.KV, c.Dk, c.Dv,
                       c.causal, c.window, c.scale, spad);
  return static_cast<int>(cudaGetLastError());
}

template <int kDK>
int launch_dv(const Call& c) {
  switch ((c.Dv + kBox - 1) / kBox) {
    case 1: return launch<kDK, 64>(c);
    case 2: return launch<kDK, 128>(c);
    case 3: return launch<kDK, 192>(c);
    default: return launch<kDK, 256>(c);
  }
}

}  // namespace

// Floats of the (lse, D) scratch the launch needs: (B H, 2, S rounded up
// to the dq kernel's 128-row tiles).
extern "C" int64_t flash_attention_bwd_sm90_scratch(int B, int H, int S) {
  return static_cast<int64_t>(B) * H * 2 * pad_rows(S);
}

// scale: Dk^-0.5 as the caller rounds it to float.  Contiguous bf16 q
// (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv), o and do (B,S,H,Dv), 16-byte
// aligned, the forward's lse (B,H,S) f32, the scratch `rows` (see
// flash_attention_bwd_sm90_scratch) and dq, dk, dv shaped as q, k, v; Dk
// and Dv multiples of 16 in [16, 256].  parts: 1 launches
// flash_bwd_dq_sm90 (which also fills the scratch), 2 flash_bwd_dkdv_sm90
// (which reads it), 3 both, in that order, on `stream`.  Returns the first
// CUDA error code (0 on success; cudaErrorInvalidValue for arguments the
// kernels do not take or a tensor map the driver refuses).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int Dk, int Dv, int causal,
    int window, float scale, int parts, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Dk <= 0 ||
      Dv <= 0 || Dk % 16 != 0 || Dv % 16 != 0 || Dk > 256 || Dv > 256 ||
      parts < 1 || parts > 3 || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(o) || misaligned(dout) || misaligned(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(rows), dq, dk, dv, B, S, H, KV, Dk, Dv,
               causal, window, scale, parts,
               static_cast<cudaStream_t>(stream)};
  switch ((Dk + kBox - 1) / kBox) {
    case 1: return launch_dv<64>(c);
    case 2: return launch_dv<128>(c);
    case 3: return launch_dv<192>(c);
    default: return launch_dv<256>(c);
  }
}
