// The backward pass of blockwise (flash) attention with GQA, causal,
// bidirectional and sliding-window masks, and Dk != Dv: given q, k, v, the
// forward's output o, its per-row log-sum-exp lse (m + log l of the scaled,
// masked scores, written by the forward kernels) and the output's gradient
// do, it computes dq, dk and dv, where query head h reads KV head
// h / (H / KV).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// jax.value_and_grad differentiates the jnp blocked_attention
// (repro/models/attention.py) instead.  On the card the forward is the
// hand-written kernel, so its gradient is this one (the plain version is
// autograd of ../ref.py::flash_attention_ref).  Per visible (query i, key
// j), with s = q_i . k_j * Dk^-0.5:
//   P_ij  = exp(s_ij - lse_i)               (0 where masked)
//   D_i   = sum_e do_ie o_ie
//   dv_j += P_ij do_i                        dP_ij = do_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i += Dk^-0.5 dS_ij k_j                dk_j += Dk^-0.5 dS_ij q_i
//
// Design (simple and right; making it fast is later work): two kernels,
// 256 threads a CTA, 64-row tiles of f32 in shared memory (rows padded to
// an odd stride), a 4 x 4 block of each 64 x 64 score tile and of each
// accumulator's rows a thread, scalar FMAs, f32 throughout:
// * flash_bwd_dq, one CTA per (query tile, head, batch): D for its rows
//   (written out for the other kernel), then over the visible KV tiles P,
//   dP and dS (dS through shared memory) and dq += dS k;
// * flash_bwd_dkdv, one CTA per (KV tile, KV head, batch): over the G
//   query heads that share the KV head and their visible query tiles, P
//   and dS (both through shared memory), dv += P^T do and dk += dS^T q.
//   The sum over the G heads stays in one CTA's registers, in a fixed
//   order: no atomics, and two runs give the same bits.
// The visited tiles are the forward's: causal stops at the diagonal, a
// window starts at its first key's tile.
// Those kernels hold whole rows of width Dk and Dv in shared memory and
// registers: they take Dk, Dv up to 192 where the rows fit.  Wider heads
// (recurrentgemma-9b's D 256 in float32, say) go to a second pair with the
// head dimensions cut, whose shared memory does not grow with them:
// * flash_bwd_dq_wide, one CTA per (query tile, head, batch, block of 128
//   dq columns): S summed over 64-wide Dk slices of q and k, dP over Dv
//   slices of do and v (each staged through shared memory in turn), then
//   dq's block += dS k[:, block];
// * flash_bwd_dkdv_wide, one CTA per (KV tile, KV head, batch, block of
//   128 columns of dk and of dv): P and dS as above, then dv's block +=
//   P^T do[:, block] and dk's block += dS^T q[:, block], over the G heads
//   of the KV head in one CTA, as above.
// Every block recomputes S and dP with the same arithmetic, so all see
// the same P and dS; block 0 of the dq kernel writes D.  No atomics.
//
// What bounds it on an H100: at llama3-8b's training shape (B 1, S 4,096,
// H 32, KV 8, D 128, causal, bf16) the work is ~3.4e11 FLOPs (S, dP, dq;
// S, dP, dv, dk over the causal half) and ~0.2 GB of traffic: the bf16
// tensor cores (989 TFLOP/s) would bound it at ~0.35 ms.  This kernel
// uses the CUDA cores (67 TFLOP/s f32 at most) on shared-memory operands,
// far from that bound; wgmma tiles are the way there.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3), called through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;                // rows of a query or KV tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kLdT = kB + 16;         // 64 x 64 tile row stride (floats)
constexpr int kMaxSmem = 232448;      // 227 KB per block on sm_90
constexpr int kWholeD = 192;          // widest whole-row Dk and Dv

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// both kernels hold four row tiles (two of width Dk, two of Dv), one or
// two 64 x 64 tiles and two per-row arrays
size_t smem_bytes(int dk, int dv) {
  return sizeof(float) * (2 * static_cast<size_t>(kB) * (dk + 1) +
                          2 * static_cast<size_t>(kB) * (dv + 1) +
                          2 * static_cast<size_t>(kB) * kLdT + 2 * kB);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal, int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// rows [0, kB) of a (B,S,heads,D) tensor from position s0, head hh, into
// a kB x (D + 1) f32 tile (zeros past S)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int s0, int hh, int S, int heads,
                                          int D) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D, s = s0 + r;
    dst[r * (D + 1) + d] =
        s < S ? to_f(src[((static_cast<int64_t>(b) * S + s) * heads + hh) * D +
                         d])
              : 0.f;
  }
}

// kJ: the wider of Dk and Dv, rounded up to a multiple of 16, over 16 (the
// accumulator columns a thread holds).
template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ dsum, T* __restrict__ dq, int S, int H,
             int KV, int Dk, int Dv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1, ldv = Dv + 1;
  float* Qs = smem;                 // kB x ldk
  float* dOs = Qs + kB * ldk;       // kB x ldv
  float* Ks = dOs + kB * ldv;       // kB x ldk
  float* Vs = Ks + kB * ldk;        // kB x ldv
  float* dSs = Vs + kB * ldv;       // kB x kLdT
  float* lse_s = dSs + kB * kLdT;   // kB
  float* D_s = lse_s + kB;          // kB

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;

  load_tile(Qs, q, b, q0, h, S, H, Dk);
  load_tile(dOs, dout, b, q0, h, S, H, Dv);
  __syncthreads();
  // D = rowsum(do o): warp w rows 8w .. 8w + 7, lanes over the columns
  for (int rr = 0; rr < kB / (kThreads / 32); ++rr) {
    const int r = warp * (kB / (kThreads / 32)) + rr, s = q0 + r;
    float acc = 0.f;
    if (s < S) {
      const T* orow = o + ((static_cast<int64_t>(b) * S + s) * H + h) * Dv;
      for (int e = lane; e < Dv; e += 32)
        acc = fmaf(dOs[r * ldv + e], to_f(orow[e]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      D_s[r] = acc;
      lse_s[r] = s < S ? lse[row0 + s] : 0.f;
      if (s < S) dsum[row0 + s] = acc;
    }
  }

  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  const int nk = (S + kB - 1) / kB;
  const int hi = causal ? min((q0 + kB - 1) / kB + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / kB : 0;
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, b, k0, g, S, KV, Dk);
    load_tile(Vs, v, b, k0, g, S, KV, Dv);
    __syncthreads();
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < Dk; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }
    for (int e = 0; e < Dv; ++e) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dOs[(ty + 16 * i) * ldv + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Vs[(tx + 16 * j) * ldv + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (visible(q0 + r, k0 + c, S, causal, window)) {
          const float p = expf(sc[i][j] * scale - lse_s[r]);
          ds = p * (dp[i][j] - D_s[r]);
        }
        dSs[r * kLdT + c] = ds;
      }
    }
    __syncthreads();
    // dq += dS k: rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < kB; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ty + 16 * i) * kLdT + c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float kb = d < Dk ? Ks[c * ldk + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kb, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    T* row = dq + ((static_cast<int64_t>(b) * S + s) * H + h) * Dk;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < Dk) row[d] = from_f<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
               int Dk, int Dv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1, ldv = Dv + 1;
  float* Qs = smem;                 // kB x ldk
  float* dOs = Qs + kB * ldk;       // kB x ldv
  float* Ks = dOs + kB * ldv;       // kB x ldk
  float* Vs = Ks + kB * ldk;        // kB x ldv
  float* Ps = Vs + kB * ldv;        // kB x kLdT (query rows x key columns)
  float* dSs = Ps + kB * kLdT;      // kB x kLdT
  float* lse_s = dSs + kB * kLdT;   // kB
  float* D_s = lse_s + kB;          // kB

  const int k0 = blockIdx.x * kB, g = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile(Ks, k, b, k0, g, S, KV, Dk);
  load_tile(Vs, v, b, k0, g, S, KV, Dv);

  // rows ty + 16 i of the KV tile, columns tx + 16 j
  float adk[4][kJ], adv[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the query tiles that see this KV tile
  const int nq = (S + kB - 1) / kB;
  const int first = causal ? k0 / kB : 0;
  const int last =
      window > 0 ? min((k0 + kB - 1 + window - 1) / kB, nq - 1) : nq - 1;
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;
    for (int it = first; it <= last; ++it) {
      const int q0 = it * kB;
      __syncthreads();  // the previous tile's readers are done
      load_tile(Qs, q, b, q0, h, S, H, Dk);
      load_tile(dOs, dout, b, q0, h, S, H, Dv);
      if (tid < kB) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[row0 + s] : 0.f;
        D_s[tid] = s < S ? dsum[row0 + s] : 0.f;
      }
      __syncthreads();
      // scores and dP: query rows ty + 16 i, key columns tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < Dk; ++d) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ldk + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
      }
      for (int e = 0; e < Dv; ++e) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dOs[(ty + 16 * i) * ldv + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = Vs[(tx + 16 * j) * ldv + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = 0.f;
          if (visible(q0 + r, k0 + c, S, causal, window))
            p = expf(sc[i][j] * scale - lse_s[r]);
          Ps[r * kLdT + c] = p;
          dSs[r * kLdT + c] = p * (dp[i][j] - D_s[r]);
        }
      }
      __syncthreads();
      // dv += P^T do, dk += dS^T q: key rows ty + 16 i, columns tx + 16 j
      for (int r = 0; r < kB; ++r) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[r * kLdT + ty + 16 * i];
          sa[i] = dSs[r * kLdT + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int c = tx + 16 * j;
          const float ob = c < Dv ? dOs[r * ldv + c] : 0.f;
          const float qb = c < Dk ? Qs[r * ldk + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pa[i], ob, adv[i][j]);
            adk[i][j] = fmaf(sa[i], qb, adk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const int64_t r = (static_cast<int64_t>(b) * S + s) * KV + g;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dk) dk[r * Dk + c] = from_f<T>(adk[i][j] * scale);
      if (c < Dv) dv[r * Dv + c] = from_f<T>(adv[i][j]);
    }
  }
}

// ---- any width: the head dimensions in slices and blocks ----------------

constexpr int kDS = 64;             // columns of a staged Dk or Dv slice
constexpr int kLdD = kDS + 1;       // slice row stride (floats)
constexpr int kWB = 128;            // output columns a CTA accumulates
constexpr int kLdB = kWB + 1;       // output-block tile row stride
constexpr int kJW = kWB / 16;       // of which a thread holds

size_t dq_wide_smem() {
  return sizeof(float) * (2 * static_cast<size_t>(kB) * kLdD +
                          static_cast<size_t>(kB) * kLdB +
                          static_cast<size_t>(kB) * kLdT + 2 * kB);
}

size_t dkdv_wide_smem() {
  return sizeof(float) * (2 * static_cast<size_t>(kB) * kLdD +
                          2 * static_cast<size_t>(kB) * kLdB +
                          2 * static_cast<size_t>(kB) * kLdT + 2 * kB);
}

// columns [c0, c0 + w) of rows [s0, s0 + kB) of a (B,S,heads,D) tensor,
// head hh, into a kB x ld f32 tile (zeros past S)
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, int ld, const T* src,
                                          int b, int s0, int hh, int S,
                                          int heads, int D, int c0, int w) {
  for (int i = threadIdx.x; i < kB * w; i += kThreads) {
    const int r = i / w, d = i % w, s = s0 + r;
    dst[r * ld + d] =
        s < S ? to_f(src[((static_cast<int64_t>(b) * S + s) * heads + hh) * D +
                         c0 + d])
              : 0.f;
  }
}

// sc += a b^T over D columns staged kDS at a time: a's rows [a0, a0 + kB)
// of (B,S,ha,D) head hha, b's rows [b0, b0 + kB) of (B,S,hb,D) head hhb;
// rows ty + 16 i of a, tx + 16 j of b.  Starts with a barrier (the
// staging tiles' previous readers are done).
template <typename T>
__device__ __forceinline__ void sliced_dot(
    float (&sc)[4][4], float* As, float* Bs, const T* a, int a0, int hha,
    int ha, const T* bm, int b0, int hhb, int hb, int b, int S, int D) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int d0 = 0; d0 < D; d0 += kDS) {
    const int w = min(kDS, D - d0);
    __syncthreads();
    load_cols(As, kLdD, a, b, a0, hha, S, ha, D, d0, w);
    load_cols(Bs, kLdD, bm, b, b0, hhb, S, hb, D, d0, w);
    __syncthreads();
    for (int d = 0; d < w; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = As[(ty + 16 * i) * kLdD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = Bs[(tx + 16 * j) * kLdD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(x[i], y[j], sc[i][j]);
    }
  }
}

// blockIdx.x = query tile * ndb + dq column block
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ dsum, T* __restrict__ dq, int S, int H,
                  int KV, int Dk, int Dv, int ndb, int causal, int window,
                  float scale) {
  extern __shared__ float smem[];
  float* As = smem;                 // kB x kLdD: q or do slice
  float* Bs = As + kB * kLdD;       // kB x kLdD: k or v slice
  float* Kb = Bs + kB * kLdD;       // kB x kLdB: k's block columns
  float* dSs = Kb + kB * kLdB;      // kB x kLdT
  float* lse_s = dSs + kB * kLdT;   // kB
  float* D_s = lse_s + kB;          // kB

  const int db = blockIdx.x % ndb, q0 = (blockIdx.x / ndb) * kB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int c0 = db * kWB, cw = min(kWB, Dk - c0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;

  // D = rowsum(do o), the other kernel's order: lanes over the columns
  for (int rr = 0; rr < kB / (kThreads / 32); ++rr) {
    const int r = warp * (kB / (kThreads / 32)) + rr, s = q0 + r;
    float acc = 0.f;
    if (s < S) {
      const int64_t off = ((static_cast<int64_t>(b) * S + s) * H + h) * Dv;
      for (int e = lane; e < Dv; e += 32)
        acc = fmaf(to_f(dout[off + e]), to_f(o[off + e]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      D_s[r] = acc;
      lse_s[r] = s < S ? lse[row0 + s] : 0.f;
      if (s < S && db == 0) dsum[row0 + s] = acc;
    }
  }

  float acc[4][kJW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJW; ++j) acc[i][j] = 0.f;

  const int nk = (S + kB - 1) / kB;
  const int hi = causal ? min((q0 + kB - 1) / kB + 1, nk) : nk;
  const int lo = window > 0 ? max(q0 - window + 1, 0) / kB : 0;
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kB;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    sliced_dot(sc, As, Bs, q, q0, h, H, k, k0, g, KV, b, S, Dk);
    sliced_dot(dp, As, Bs, dout, q0, h, H, v, k0, g, KV, b, S, Dv);
    // the previous tile's dq readers passed the slices' barriers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (visible(q0 + r, k0 + c, S, causal, window)) {
          const float p = expf(sc[i][j] * scale - lse_s[r]);
          ds = p * (dp[i][j] - D_s[r]);
        }
        dSs[r * kLdT + c] = ds;
      }
    }
    load_cols(Kb, kLdB, k, b, k0, g, S, KV, Dk, c0, cw);
    __syncthreads();
    for (int c = 0; c < kB; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ty + 16 * i) * kLdT + c];
#pragma unroll
      for (int j = 0; j < kJW; ++j) {
        const int d = tx + 16 * j;
        const float kb = d < cw ? Kb[c * kLdB + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kb, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    T* row = dq + ((static_cast<int64_t>(b) * S + s) * H + h) * Dk + c0;
#pragma unroll
    for (int j = 0; j < kJW; ++j) {
      const int d = tx + 16 * j;
      if (d < cw) row[d] = from_f<T>(acc[i][j] * scale);
    }
  }
}

// blockIdx.x = KV tile * nob + column block: dk's columns [ob kWB, +kWB)
// and dv's (either may be empty past its width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wide(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int H, int KV, int Dk, int Dv,
                    int nob, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* As = smem;                 // kB x kLdD: q or do slice
  float* Bs = As + kB * kLdD;       // kB x kLdD: k or v slice
  float* Qb = Bs + kB * kLdD;       // kB x kLdB: q's block columns
  float* dOb = Qb + kB * kLdB;      // kB x kLdB: do's block columns
  float* Ps = dOb + kB * kLdB;      // kB x kLdT (query rows x key columns)
  float* dSs = Ps + kB * kLdT;      // kB x kLdT
  float* lse_s = dSs + kB * kLdT;   // kB
  float* D_s = lse_s + kB;          // kB

  const int ob = blockIdx.x % nob, k0 = (blockIdx.x / nob) * kB;
  const int g = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int c0 = ob * kWB;
  const int kw = max(0, min(kWB, Dk - c0)), vw = max(0, min(kWB, Dv - c0));
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float adk[4][kJW], adv[4][kJW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJW; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int nq = (S + kB - 1) / kB;
  const int first = causal ? k0 / kB : 0;
  const int last =
      window > 0 ? min((k0 + kB - 1 + window - 1) / kB, nq - 1) : nq - 1;
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;
    for (int it = first; it <= last; ++it) {
      const int q0 = it * kB;
      // every reader of lse_s / D_s (the previous tile's P) passed the
      // barrier before its outer products
      if (tid < kB) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[row0 + s] : 0.f;
        D_s[tid] = s < S ? dsum[row0 + s] : 0.f;
      }
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      sliced_dot(sc, As, Bs, q, q0, h, H, k, k0, g, KV, b, S, Dk);
      sliced_dot(dp, As, Bs, dout, q0, h, H, v, k0, g, KV, b, S, Dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = 0.f;
          if (visible(q0 + r, k0 + c, S, causal, window))
            p = expf(sc[i][j] * scale - lse_s[r]);
          Ps[r * kLdT + c] = p;
          dSs[r * kLdT + c] = p * (dp[i][j] - D_s[r]);
        }
      }
      load_cols(Qb, kLdB, q, b, q0, h, S, H, Dk, c0, kw);
      load_cols(dOb, kLdB, dout, b, q0, h, S, H, Dv, c0, vw);
      __syncthreads();
      for (int r = 0; r < kB; ++r) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[r * kLdT + ty + 16 * i];
          sa[i] = dSs[r * kLdT + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kJW; ++j) {
          const int c = tx + 16 * j;
          const float ob_ = c < vw ? dOb[r * kLdB + c] : 0.f;
          const float qb = c < kw ? Qb[r * kLdB + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pa[i], ob_, adv[i][j]);
            adk[i][j] = fmaf(sa[i], qb, adk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const int64_t r = (static_cast<int64_t>(b) * S + s) * KV + g;
#pragma unroll
    for (int j = 0; j < kJW; ++j) {
      const int c = tx + 16 * j;
      if (c < kw) dk[r * Dk + c0 + c] = from_f<T>(adk[i][j] * scale);
      if (c < vw) dv[r * Dv + c0 + c] = from_f<T>(adv[i][j]);
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dsum, void* dq,
                void* dk, void* dv, int B, int S, int H, int KV, int Dk,
                int Dv, int causal, int window, float scale, int parts,
                cudaStream_t stream) {
  const size_t s1 = dq_wide_smem(), s2 = dkdv_wide_smem();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wide<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kB - 1) / kB;
  const int ndb = (Dk + kWB - 1) / kWB;
  const int nob = ((Dk > Dv ? Dk : Dv) + kWB - 1) / kWB;
  if (parts & 1) {
    flash_bwd_dq_wide<T><<<dim3(tiles * ndb, H, B), kThreads, s1, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), S, H,
        KV, Dk, Dv, ndb, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2)
    flash_bwd_dkdv_wide<T>
        <<<dim3(tiles * nob, KV, B), kThreads, s2, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
            static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, Dk, Dv, nob,
            causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

bool takes_whole_rows(int dk, int dv) {
  return dk <= kWholeD && dv <= kWholeD && smem_bytes(dk, dv) <= kMaxSmem;
}

template <typename T, int kJ>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int H, int KV, int Dk, int Dv,
           int causal, int window, float scale, int parts,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, kJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv<T, kJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kB - 1) / kB;
  if (parts & 1) {
    flash_bwd_dq<T, kJ><<<dim3(tiles, H, B), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), S, H,
        KV, Dk, Dv, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2)
    flash_bwd_dkdv<T, kJ><<<dim3(tiles, KV, B), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, Dk, Dv, causal,
        window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dsum, void* dq,
             void* dk, void* dv, int B, int S, int H, int KV, int Dk, int Dv,
             int causal, int window, float scale, int parts,
             cudaStream_t st) {
  if (!takes_whole_rows(Dk, Dv))
    return launch_wide<T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H,
                          KV, Dk, Dv, causal, window, scale, parts, st);
  const int w = Dk > Dv ? Dk : Dv;
  if (w <= 32)
    return launch<T, 2>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, KV,
                        Dk, Dv, causal, window, scale, parts, st);
  if (w <= 64)
    return launch<T, 4>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, KV,
                        Dk, Dv, causal, window, scale, parts, st);
  if (w <= 128)
    return launch<T, 8>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, KV,
                        Dk, Dv, causal, window, scale, parts, st);
  return launch<T, 12>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, KV,
                       Dk, Dv, causal, window, scale, parts, st);
}

}  // namespace

// scale: Dk^-0.5 as the caller rounds it to float.  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, o, do, dq, dk, dv alike).  Contiguous q (B,S,H,Dk),
// k (B,S,KV,Dk), v (B,S,KV,Dv), o and do (B,S,H,Dv), lse (B,H,S) f32 from
// the forward, the scratch dsum (B,H,S) f32, and dq, dk, dv shaped as q, k,
// v; any Dk, Dv >= 1.  parts: 1 launches the dq kernel (which also fills
// dsum), 2 the dk/dv kernel (which reads it), 3 both, in that order, on
// `stream`; returns the first CUDA error code (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int Dk, int Dv, int causal,
    int window, float scale, int dtype, int parts, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Dk <= 0 ||
      Dv <= 0 || parts < 1 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return launch_w<float>(q, k, v, o, dout, l, ds, dq, dk, dv, B, S, H, KV,
                           Dk, Dv, causal, window, scale, parts, st);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(q, k, v, o, dout, l, ds, dq, dk, dv, B, S,
                                   H, KV, Dk, Dv, causal, window, scale,
                                   parts, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
