// The mma.sync pieces both tensor-core SSD sources share (ssd_scan_tc.cu,
// the forward, and ssd_scan_bwd_tc.cu, the backward): tile constants,
// cp.async, ldmatrix, the bf16 m16n8k16 product, the bf16 hi + lo split of
// f32 operands, tile loads, and the C B^T kernel whose fmaf chain fixes the
// bf16 rounding of the intra-chunk weights.  Each source includes it into
// its own anonymous namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;            // rows of a chunk / query / key tile
constexpr int kPad = 8;           // bf16 a shared row is padded by (16 B)
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90

// Q rounded up to whole tiles: the length of the per-row arrays in
// shared memory (a ragged chunk's tiles read past Q)
__host__ __device__ __forceinline__ int tiled(int Q) {
  return (Q + kT - 1) / kT * kT;
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (src is then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) @ b (16x8, col); bf16 in, f32 accumulate.  Fragment
// of lane l, gid = l / 4, tig = l % 4: a {(gid, 2tig..+1), (gid+8, ..),
// (gid, 8+2tig..), (gid+8, 8+..)}; b {(k 2tig..+1, n gid), (k 8+2tig..)};
// d {(gid, 2tig), (gid, 2tig+1), (gid+8, 2tig), (gid+8, 2tig+1)}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (lo in the low half: the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
// (f0, f1) -> bf16x2 hi and the bf16x2 of what hi leaves over
__device__ __forceinline__ void split(float f0, float f1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(f0, f1);
  lo = pack(__fsub_rn(f0, lo_f(hi)), __fsub_rn(f1, hi_f(hi)));
}

// rows [0, nrow) x columns [0, ncol) of a row-major bf16 matrix (row
// stride ld elements) -> a kRows x kCols shared tile (row stride kCols +
// kPad), zeros elsewhere; ncol a multiple of 8.  One cp.async group's
// worth of copies (the caller commits).
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t ld, int nrow, int ncol) {
  constexpr int kChunks = kCols / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool ok = r < nrow && ch * 8 < ncol;
    cp_async16(dst + r * (kCols + kPad) + ch * 8,
               ok ? src + r * ld + ch * 8 : src, ok);
  }
}
// a kT-row tile
template <int kCols, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ld, int nrow, int ncol) {
  load_rows<kT, kCols, kThreads>(dst, src, ld, nrow, ncol);
}
// ---- C B^T ---------------------------------------------------------------

constexpr int kCbThreads = 256;   // 16 x 16, a 4 x 4 block of a tile each
constexpr int kLdT = kT + 4;      // f32 a transposed shared row is padded by

size_t cb_smem(int N) {
  return sizeof(float) * 2 * static_cast<size_t>(N) * kLdT;
}

// grid (ceil(Q / kT)^2, nc, B G): the (query tile, key tile) pair of chunk
// c for group g, key tile at or below the query tile.  cb (B, G, nc,
// tiled(Q), tiled(Q)) f32: C_q . B_k as one fmaf chain over n = 0..N-1,
// the plain version's f32 product in its order.  (A tensor-core product
// of the same bf16 operands sums in another order, and the bf16 rounding
// of the weights it feeds turns those last-bit differences into whole
// bf16 steps of w: past the 1e-2 tolerance where y cancels.)  Heads of a
// group share it: it is made once, not once per head.  C and B sit
// transposed in shared memory ([n][row], f32), so a thread reads its 4
// rows of each as one float4 an n.
__global__ void __launch_bounds__(kCbThreads)
ssd_chunk_cb(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
             float* __restrict__ cb, int S, int G, int N, int Q) {
  const int qtiles = (Q + kT - 1) / kT;
  const int qt = blockIdx.x / qtiles, kt = blockIdx.x % qtiles;
  if (kt > qt) return;
  const int c = blockIdx.y, b = blockIdx.z / G, g = blockIdx.z % G;
  const int nc = gridDim.y;
  const int c0 = c * Q, qe = min(Q, S - c0);
  const int q0 = qt * kT, k0 = kt * kT;
  extern __shared__ __align__(16) float fsmem[];
  float* Ct = fsmem;            // N x kLdT: Ct[n][r] = C[q0 + r][n]
  float* Bt = Ct + N * kLdT;    // N x kLdT: Bt[n][r] = B[k0 + r][n]
  const int64_t ldb = static_cast<int64_t>(G) * N;
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const bf16* Cg = Cm + row0 * ldb + static_cast<int64_t>(g) * N;
  const bf16* Bg = Bm + row0 * ldb + static_cast<int64_t>(g) * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // 8 bf16 (16 bytes) of one row a load; a warp's stores hit 32 rows
  for (int i = tid; i < kT * N / 8; i += kCbThreads) {
    const int r = i % kT, n = 8 * (i / kT);
    uint4 cv = make_uint4(0, 0, 0, 0), bv = cv;
    if (q0 + r < qe)
      cv = *reinterpret_cast<const uint4*>(Cg + (q0 + r) * ldb + n);
    if (k0 + r < qe)
      bv = *reinterpret_cast<const uint4*>(Bg + (k0 + r) * ldb + n);
    const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
    const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Ct[(n + 2 * e) * kLdT + r] = lo_f(cw[e]);
      Ct[(n + 2 * e + 1) * kLdT + r] = hi_f(cw[e]);
      Bt[(n + 2 * e) * kLdT + r] = lo_f(bw[e]);
      Bt[(n + 2 * e + 1) * kLdT + r] = hi_f(bw[e]);
    }
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float4 c4 = *reinterpret_cast<const float4*>(Ct + n * kLdT + 4 * ty);
    const float4 b4 = *reinterpret_cast<const float4*>(Bt + n * kLdT + 4 * tx);
    const float ca[4] = {c4.x, c4.y, c4.z, c4.w};
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ca[i], bb[j], acc[i][j]);
  }
  const int Qt = tiled(Q);
  float* out = cb + (static_cast<int64_t>(blockIdx.z) * nc + c) * Qt * Qt
               + static_cast<int64_t>(q0 + 4 * ty) * Qt + k0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(i) * Qt) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace
