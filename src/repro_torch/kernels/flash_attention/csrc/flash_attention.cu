// Blockwise (flash) attention with an f32 online softmax, GQA and sliding
// window: o[b, s, h, :] = softmax(q k^T * Dk^-0.5, masked) v, where query
// head h reads KV head h / (H / KV) in place (no repeat of KV heads).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (_flash_kernel, launched by flash_attention over a
// (B, H, S / bq) grid).  Same function: q scaled before the dot, masked
// scores set to -1e30 and p zeroed where masked, running max / sum / output
// in f32, output divided by max(l, 1e-30) and written in q's type.  Same
// visited KV tiles: causal attention stops at the diagonal tile (never
// loads a tile above it), and a window starts at the window's first tile.
//
// Design (simple and right; making it fast is later work): one CTA of 256
// threads per (64-row query tile, head, batch).  The query tile, one
// 64-row K tile and one V tile sit in shared memory as f32 (K and Q rows
// padded to an odd stride, so the 16 columns a warp reads fall in 16
// banks); the 64 x 64 score tile goes through shared memory for the
// row-wise softmax (one warp per 8 rows, shuffles for max and sum).  Each
// thread owns a 4 x 4 block of the score tile and a 4 x (Dv / 16) block of
// the output accumulator, in registers, and multiplies with scalar FMAs.
//
// Heads wider than those instances take (Dv above 256, or a Dk whose f32
// rows overflow the 227 KB of shared memory: Dk above 283 at Dv 256) go to
// flash_wide_kernel, the same tiling with the head dimensions cut: the
// scores are summed over 64-wide Dk slices of q and k staged through
// shared memory in turn (the same FMA order, d = 0 .. Dk - 1, as above),
// and the output is split into blocks of at most 256 Dv columns over the
// grid.  Each block recomputes the scores and the row statistics with the
// same arithmetic, so every block sees the same p and the same
// log-sum-exp; block 0 writes it.  Its shared memory does not grow with
// Dk or Dv (~117 KB), so it takes any width.
//
// What bounds it on an H100: at llama3-8b's prefill shape (B 4, S 1024,
// H 32, KV 8, Dk = Dv = 128, causal, bf16) the work is ~3.4e10 FLOPs and
// ~84 MB of traffic, so the tensor cores (989 TFLOP/s bf16) bound it at
// ~0.035 ms.  This kernel uses the CUDA cores (67 TFLOP/s f32 at most) and
// shared-memory operands, so it is far from that bound; wgmma and TMA
// tiles are the way there.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3), called through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;               // query rows per CTA
constexpr int kBK = 64;               // KV rows per tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kLdS = kBK + 16;        // score-tile row stride (floats)
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 232448;      // 227 KB per block on sm_90
constexpr int kWholeDV = 256;         // widest whole-row instance's Dv

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

size_t smem_bytes(int dk, int dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (dk + 1) +
                          static_cast<size_t>(kBK) * dv +
                          static_cast<size_t>(kBQ) * kLdS + 3 * kBQ);
}

// kDV: Dv rounded up to a multiple of 16 (the accumulator width / 16 per
// thread).  Dk and Dv are runtime, Dv <= kDV.
template <typename T, int kDV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int S, int H, int KV, int Dk, int Dv,
             int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1;
  float* Qs = smem;                      // kBQ x ldk, pre-scaled
  float* Ks = Qs + kBQ * ldk;            // kBK x ldk
  float* Vs = Ks + kBK * ldk;            // kBK x Dv
  float* Ss = Vs + kBK * Dv;             // kBQ x kLdS: scores, then p
  float* m_s = Ss + kBQ * kLdS;          // running max per row
  float* l_s = m_s + kBQ;                // running sum per row
  float* c_s = l_s + kBQ;                // this tile's correction per row

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < kBQ * Dk; i += kThreads) {
    const int r = i / Dk, d = i % Dk, s = q0 + r;
    Qs[r * ldk + d] =
        s < S ? to_f(q[((static_cast<int64_t>(b) * S + s) * H + h) * Dk + d]) *
                    scale
              : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  constexpr int kJ = kDV / 16;
  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  const int nk = (S + kBK - 1) / kBK;
  const int hi = causal ? min((q0 + kBQ + kBK - 1) / kBK, nk) : nk;
  const int lo = window > 0 ? max(q0 / kBK - (window + kBK - 1) / kBK, 0) : 0;

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * Dk; i += kThreads) {
      const int c = i / Dk, d = i % Dk, s = k0 + c;
      Ks[c * ldk + d] =
          s < S ? to_f(k[((static_cast<int64_t>(b) * S + s) * KV + g) * Dk + d])
                : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int c = i / Dv, e = i % Dv, s = k0 + c;
      Vs[c * Dv + e] =
          s < S ? to_f(v[((static_cast<int64_t>(b) * S + s) * KV + g) * Dv + e])
                : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j of the tile
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < Dk; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * kLdS + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w + 7, lane l columns l, l + 32
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const int qpos = q0 + r;
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kpos = k0 + c;
        bool a = kpos < S;
        if (causal) a = a && kpos <= qpos;
        if (window > 0) a = a && (qpos - kpos < window);
        ok[t] = a;
        sv[t] = a ? Ss[r * kLdS + c] : kNeg;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.f;
      Ss[r * kLdS + lane] = p0;
      Ss[r * kLdS + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ss[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int e = tx + 16 * j;
        const float vb = e < Dv ? Vs[c * Dv + e] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }
  __syncthreads();  // l_s is complete (also when no tile was visited)
  // the row's log-sum-exp of the scaled scores, for the backward pass
  if (lse != nullptr && tid < kBQ && q0 + tid < S)
    lse[(static_cast<int64_t>(b) * H + h) * S + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * S + s) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int e = tx + 16 * j;
      if (e < Dv) orow[e] = from_f<T>(acc[i][j] / den);
    }
  }
}

// ---- any width: Dk in slices, Dv in blocks over the grid ----------------

constexpr int kDS = 64;             // Dk columns of a staged slice
constexpr int kLdD = kDS + 1;       // slice row stride (floats)
constexpr int kWideDV = 256;        // most Dv columns a block accumulates

size_t wide_smem_bytes(int dvb) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * kLdD +
                          static_cast<size_t>(kBK) * dvb +
                          static_cast<size_t>(kBQ) * kLdS + 3 * kBQ);
}

// blockIdx.x = query tile * nvb + Dv block; the block's columns are
// [vb * dvb, vb * dvb + dvb) of Dv (fewer in the last); kDV >= dvb.
template <typename T, int kDV>
__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int S, int H, int KV, int Dk,
                  int Dv, int dvb, int nvb, int causal, int window,
                  float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // kBQ x kLdD: a Dk slice, scaled
  float* Ks = Qs + kBQ * kLdD;           // kBK x kLdD
  float* Vs = Ks + kBK * kLdD;           // kBK x dvb: the block's columns
  float* Ss = Vs + kBK * dvb;            // kBQ x kLdS: scores, then p
  float* m_s = Ss + kBQ * kLdS;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int vb = blockIdx.x % nvb;
  const int q0 = (blockIdx.x / nvb) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int e0 = vb * dvb, ew = min(dvb, Dv - e0);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  constexpr int kJ = kDV / 16;
  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  const int nk = (S + kBK - 1) / kBK;
  const int hi = causal ? min((q0 + kBQ + kBK - 1) / kBK, nk) : nk;
  const int lo = window > 0 ? max(q0 / kBK - (window + kBK - 1) / kBK, 0) : 0;

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d0 = 0; d0 < Dk; d0 += kDS) {
      const int dw = min(kDS, Dk - d0);
      __syncthreads();  // the previous slice's (and tile's) readers are done
      for (int i = tid; i < kBQ * dw; i += kThreads) {
        const int r = i / dw, d = i % dw, s = q0 + r;
        Qs[r * kLdD + d] =
            s < S ? to_f(q[((static_cast<int64_t>(b) * S + s) * H + h) * Dk +
                           d0 + d]) *
                        scale
                  : 0.f;
      }
      for (int i = tid; i < kBK * dw; i += kThreads) {
        const int c = i / dw, d = i % dw, s = k0 + c;
        Ks[c * kLdD + d] =
            s < S ? to_f(k[((static_cast<int64_t>(b) * S + s) * KV + g) * Dk +
                           d0 + d])
                  : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < dw; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * kLdD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * kLdD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
      }
    }
    // the previous tile's p v readers passed the slices' barriers: Ss and
    // Vs are free
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * kLdS + tx + 16 * j] = sc[i][j];
    for (int i = tid; i < kBK * ew; i += kThreads) {
      const int c = i / ew, e = i % ew, s = k0 + c;
      Vs[c * dvb + e] =
          s < S ? to_f(v[((static_cast<int64_t>(b) * S + s) * KV + g) * Dv +
                         e0 + e])
                : 0.f;
    }
    __syncthreads();

    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const int qpos = q0 + r;
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kpos = k0 + c;
        bool a = kpos < S;
        if (causal) a = a && kpos <= qpos;
        if (window > 0) a = a && (qpos - kpos < window);
        ok[t] = a;
        sv[t] = a ? Ss[r * kLdS + c] : kNeg;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.f;
      Ss[r * kLdS + lane] = p0;
      Ss[r * kLdS + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ss[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int e = tx + 16 * j;
        const float vv = e < ew ? Vs[c * dvb + e] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();
  if (vb == 0 && lse != nullptr && tid < kBQ && q0 + tid < S)
    lse[(static_cast<int64_t>(b) * H + h) * S + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * S + s) * H + h) * Dv + e0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int e = tx + 16 * j;
      if (e < ew) orow[e] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int kDV>
int launch_wide_at(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, int Dk, int Dv,
                   int dvb, int nvb, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(dvb);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T, kDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((S + kBQ - 1) / kBQ) * nvb, H, B);
  flash_wide_kernel<T, kDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KV, Dk, Dv,
      dvb, nvb, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dv split into the fewest blocks of at most kWideDV columns, of equal
// width rounded up to 16; the accumulator instance the narrowest that
// holds one.
template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, int Dk, int Dv,
                int causal, int window, float scale, cudaStream_t stream) {
  const int nvb = (Dv + kWideDV - 1) / kWideDV;
  const int dvb = ((Dv + nvb - 1) / nvb + 15) / 16 * 16;
  const int nb = (Dv + dvb - 1) / dvb;
  if (dvb <= 64)
    return launch_wide_at<T, 64>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, dvb,
                                 nb, causal, window, scale, stream);
  if (dvb <= 128)
    return launch_wide_at<T, 128>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, dvb,
                                  nb, causal, window, scale, stream);
  return launch_wide_at<T, kWideDV>(q, k, v, o, lse, B, S, H, KV, Dk, Dv,
                                    dvb, nb, causal, window, scale, stream);
}

// whether (Dk, Dv) takes a whole-row instance (else flash_wide_kernel)
bool takes_whole_rows(int dk, int dv) {
  return dv <= kWholeDV && smem_bytes(dk, dv) <= kMaxSmem;
}

template <typename T, int kDV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int Dk, int Dv, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, kDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, kDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KV, Dk, Dv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int KV, int Dk, int Dv,
              int causal, int window, float scale, cudaStream_t stream) {
  if (!takes_whole_rows(Dk, Dv))
    return launch_wide<T>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, causal,
                          window, scale, stream);
  if (Dv <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, causal,
                           window, scale, stream);
  if (Dv <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, causal,
                           window, scale, stream);
  if (Dv <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, causal,
                           window, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, B, S, H, KV, Dk, Dv, causal,
                           window, scale, stream);
}

}  // namespace

// Whether (Dk, Dv) takes flash_wide_kernel (1) or the whole-row instances
// (0).
extern "C" int flash_attention_wide(int dk, int dv) {
  return !takes_whole_rows(dk, dv);
}

// scale: Dk^-0.5 as the caller rounds it to float.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Contiguous
// (B,S,H,Dk), (B,S,KV,Dk), (B,S,KV,Dv), (B,S,H,Dv); any Dk, Dv >= 1.
// lse: null, or a float32 (B,H,S) that gets each row's log-sum-exp of its
// scaled, masked scores (m + log l), which the backward pass reads.
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int Dk, int Dv,
                                      int causal, int window, float scale,
                                      int dtype, void* lse, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Dk <= 0 ||
      Dv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dv<float>(q, k, v, o, static_cast<float*>(lse), B, S, H,
                            KV, Dk, Dv, causal, window, scale, st);
  if (dtype == 1)
    return launch_dv<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B,
                                    S, H, KV, Dk, Dv, causal, window, scale,
                                    st);
  return static_cast<int>(cudaErrorInvalidValue);
}
