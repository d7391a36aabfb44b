// The backward pass of the Mamba-2 SSD scan over a whole sequence: given
// x, dt, A, B, C, each chunk's incoming state (kept by the forward), the
// output's gradient dy and the final state's gradient, it computes dx,
// ddt, dA, and dB and dC per head (the caller sums them over a group's
// heads and dA over batch and chunks, from these per-block buffers).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// jax.value_and_grad differentiates the jnp ssd_chunked
// (repro/models/ssm.py).  On the card the forward is the hand-written
// kernel, so its gradient is this one (the plain version is autograd of
// ../ref.py::ssd_scan_ref).  Per chunk of Q rows, head h of group g, with
// the forward's seg = cumsum(dt A), e_q = e^seg_q, L_qk = e^(seg_q -
// seg_k), d_k = e^(total - seg_k), the incoming state s and the outgoing
// state's gradient dS':
//   dS (into the previous chunk) = e^total dS' + (C * bf16(e))^T dy
//   G_qk  = dy_q . x_k,   w_qk = C_q.B_k L_qk dt_k,  dcb_qk = G_qk L_qk dt_k
//                                                    (q >= k, else 0)
//   dx_k  = bf16(w)^T dy + d_k dt_k B_k dS'
//   dB_k  = dcb^T C + d_k dt_k x_k dS'^T           dC_q = dcb B + bf16(e_q) dy_q s^T
//   ddt_k = sum_q C_q.B_k L_qk G_qk + d_k B_k.(x_k dS'^T) + A da_k
//   dseg  = e C.(dy s^T) + rowsum(w G) - colsum(w G) - d dt B.(x dS'^T)
//           (+ the total's gradient e^total s.dS' + sum_k d_k dt_k B_k.(x_k
//           dS'^T) on the last row),  da = reverse cumsum of dseg,
//   dA    = sum over the chunk of da_k dt_k
// (bf16(.): the forward's rounding in bf16, the identity in f32).
//
// Design (simple and right; making it fast is later work):
// * ssd_bwd_state_pass, one CTA of 256 threads per (head, batch): walks the
//   chunks backwards carrying dS (an (N, P) f32 block in registers,
//   seeded by the final state's gradient), writing each chunk's dS' into
//   a (B, H, nc, N, P) scratch before adding the chunk's own term;
// * ssd_bwd_chunk, one CTA of 256 threads per (chunk, head, batch): seg
//   again (one running f32 sum, the forward's order), then two sweeps over
//   the 64 x 64 tiles on or below the diagonal.  Sweep 1 takes a key tile
//   at a time: its state terms (dS' in shared memory), then the query
//   tiles at or below it (C B^T and dy x^T, the weights through shared
//   memory), accumulating dx and dB in registers and the row and column
//   sums of w G into d(seg) in shared memory.  Sweep 2 takes a query tile
//   at a time: its state term (s in shared memory), then the key tiles at
//   or above it, accumulating dC.  One thread turns d(seg) into da, ddt and
//   the chunk's dA.  Every sum is in a fixed order: no atomics, and two
//   runs give the same bits.
// Products are scalar FMAs on f32 shared-memory tiles (rows padded to an
// odd stride).  The incoming states come as the scalar forward keeps them
// (f32) or as the tensor-core forward does (a bf16 hi + lo pair).
//
// What bounds it on an H100: at mamba2-130m's training shape (B 4, S 4,096,
// H 24, P 64, N 128, G 1, Q 256, bf16) the work is ~1.2e11 FLOPs (seven
// products a tile pair, four state products a chunk) and ~0.3 GB of
// traffic (the scratch's 50 MB each way included): the bf16 tensor cores
// would bound it at ~0.12 ms.  The scalar CUDA cores it runs on are far
// from that; mma tiles are the way there.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3), called through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;            // rows of a query / key tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kLdW = kT + 16;     // 64 x 64 tile row stride (floats)
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// a sum over the 16 threads of a half-warp (the tx of one ty)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t pass_smem(int n, int p, int q) {
  return sizeof(float) * (static_cast<size_t>(kT) * (n + 1) +
                          static_cast<size_t>(kT) * p + 2 * q);
}

size_t chunk_smem(int n, int p, int q) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kT) * (n + 1)     // C, B tiles
          + 2 * static_cast<size_t>(kT) * (p + 1)   // dy, x tiles
          + static_cast<size_t>(n) * (p + 1)        // dS', then s
          + 2 * static_cast<size_t>(kT) * kLdW      // w, dcb tiles
          + 2 * 16 * static_cast<size_t>(kT)        // column partials
          + 5 * static_cast<size_t>(q) + kThreads); // per-row arrays
}

// seg = cumsum(dt * A) of a chunk's qe rows by one running f32 sum (the
// forward's order), after dt_s holds them
__device__ __forceinline__ void chunk_seg(const float* dt_s, float* seg_s,
                                          int qe, float a) {
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < qe; ++i) {
      run = __fadd_rn(run, __fmul_rn(dt_s[i], a));
      seg_s[i] = run;
    }
  }
}

// ---- 1. the reverse state pass -------------------------------------------

// grid (H, B).  dSout (B, H, nc, N, P): the gradient of each chunk's
// outgoing state.  dfinal: the final state's gradient (B,H,N,P), or null.
template <typename T, int kNB, int kPB>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass(const float* __restrict__ dt, const float* __restrict__ A,
                   const T* __restrict__ Cm, const T* __restrict__ dy,
                   const float* __restrict__ dfinal,
                   float* __restrict__ dSout, int S, int H, int G, int N,
                   int P, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* Cs = smem;                  // kT x ldn, C * bf16(e^seg)
  float* Ys = Cs + kT * ldn;         // kT x P
  float* seg_s = Ys + kT * P;        // Q
  float* dt_s = seg_s + Q;           // Q
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nc = (S + Q - 1) / Q;
  const float a = A[h];
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  // rows n = ty + 16 i, columns p = tx + 16 j of dS
  float ds[kNB][kPB];
#pragma unroll
  for (int i = 0; i < kNB; ++i)
#pragma unroll
    for (int j = 0; j < kPB; ++j) {
      const int n = ty + 16 * i, p = tx + 16 * j;
      ds[i][j] = (dfinal != nullptr && n < N && p < P)
                     ? dfinal[bh * N * P + n * P + p]
                     : 0.f;
    }
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, qe = min(Q, S - c0);
    float* out = dSout + (bh * nc + c) * N * P;
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        const int n = ty + 16 * i, p = tx + 16 * j;
        if (n < N && p < P) out[n * P + p] = ds[i][j];
      }
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < qe; i += kThreads)
      dt_s[i] = dt[(static_cast<int64_t>(b) * S + c0 + i) * H + h];
    __syncthreads();
    chunk_seg(dt_s, seg_s, qe, a);
    __syncthreads();
    const float etot = expf(seg_s[qe - 1]);
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int j = 0; j < kPB; ++j) ds[i][j] *= etot;
    for (int r0 = 0; r0 < qe; r0 += kT) {
      __syncthreads();
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N, s = r0 + r;
        Cs[r * ldn + n] =
            s < qe ? to_f(Cm[((static_cast<int64_t>(b) * S + c0 + s) * G + g) *
                                 N + n]) *
                         round_t<T>(expf(seg_s[s]))
                   : 0.f;
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int r = i / P, p = i % P, s = r0 + r;
        Ys[r * P + p] =
            s < qe ? to_f(dy[((static_cast<int64_t>(b) * S + c0 + s) * H + h) *
                                 P + p])
                   : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kT; ++r) {
        float ca[kNB], yb[kPB];
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          const int n = ty + 16 * i;
          ca[i] = n < N ? Cs[r * ldn + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
          const int p = tx + 16 * j;
          yb[j] = p < P ? Ys[r * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int j = 0; j < kPB; ++j) ds[i][j] = fmaf(ca[i], yb[j], ds[i][j]);
      }
    }
  }
}

// ---- 2. the chunk-parallel gradients -------------------------------------

// a chunk's incoming state element i (of N P): f32, or bf16 hi + lo
template <bool kHiLo>
__device__ __forceinline__ float state_at(const void* st, int64_t bhc, int i,
                                          int NP) {
  if (kHiLo) {
    const bf16* s = static_cast<const bf16*>(st) + bhc * 2 * NP;
    return __bfloat162float(s[i]) + __bfloat162float(s[NP + i]);
  }
  return static_cast<const float*>(st)[bhc * NP + i];
}

// grid (nc, H, B).  dx (B,S,H,P) in T; ddt (B,S,H), dBh and dCh (B,S,H,N),
// dA_part (B, nc, H), all f32.
template <typename T, int kNB, int kPB, bool kHiLo>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const T* __restrict__ dy,
              const void* __restrict__ states,
              const float* __restrict__ dSout, T* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dBh,
              float* __restrict__ dCh, float* __restrict__ dA_part, int S,
              int H, int G, int N, int P, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldp = P + 1;
  float* Cs = smem;                  // kT x ldn
  float* Bs = Cs + kT * ldn;         // kT x ldn
  float* Ys = Bs + kT * ldn;         // kT x ldp (dy)
  float* Xs = Ys + kT * ldp;         // kT x ldp
  float* St = Xs + kT * ldp;         // N x ldp: dS', then s
  float* Ws = St + N * ldp;          // kT x kLdW: bf16(w) (query x key)
  float* Ds = Ws + kT * kLdW;        // kT x kLdW: dcb
  float* colM = Ds + kT * kLdW;      // 16 x kT column partials of w G
  float* colT = colM + 16 * kT;      // 16 x kT, of C.B L G
  float* seg_s = colT + 16 * kT;     // Q
  float* dt_s = seg_s + Q;           // Q
  float* dseg_s = dt_s + Q;          // Q
  float* ddt_s = dseg_s + Q;         // Q: ddt but A da
  float* R_s = ddt_s + Q;            // Q: d_k dt_k B_k.(x_k dS'^T)
  float* red = R_s + Q;              // kThreads

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int nc = gridDim.x;
  const int c0 = c * Q, qe = min(Q, S - c0);
  const int nt = (qe + kT - 1) / kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];
  const int64_t bhc = (static_cast<int64_t>(b) * H + h) * nc + c;

  for (int i = tid; i < Q; i += kThreads) {
    dt_s[i] = i < qe ? dt[(static_cast<int64_t>(b) * S + c0 + i) * H + h]
                     : 0.f;
    dseg_s[i] = ddt_s[i] = R_s[i] = 0.f;
  }
  for (int i = tid; i < N * P; i += kThreads)
    St[(i / P) * ldp + i % P] = dSout[bhc * N * P + i];
  __syncthreads();
  chunk_seg(dt_s, seg_s, qe, a);
  __syncthreads();
  const float total = seg_s[qe - 1];

  // 64-row tiles of (B,S,G,N) and (B,S,H,P) tensors from chunk row r0
  const auto load_bc = [&](float* dst, const T* src, int r0) {
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, n = i % N, s = r0 + r;
      dst[r * ldn + n] =
          s < qe ? to_f(src[((static_cast<int64_t>(b) * S + c0 + s) * G + g) *
                                N + n])
                 : 0.f;
    }
  };
  const auto load_hp = [&](float* dst, const T* src, int r0) {
    for (int i = tid; i < kT * P; i += kThreads) {
      const int r = i / P, p = i % P, s = r0 + r;
      dst[r * ldp + p] =
          s < qe ? to_f(src[((static_cast<int64_t>(b) * S + c0 + s) * H + h) *
                                P + p])
                 : 0.f;
    }
  };
  // cb (rows q0 + ty + 16 i, columns k0 + tx + 16 j) from Cs, Bs and
  // G = dy x^T from Ys, Xs
  const auto products = [&](float (&cb)[4][4], float (&gm)[4][4],
                            bool with_cb) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = gm[i][j] = 0.f;
    if (with_cb)
      for (int n = 0; n < N; ++n) {
        float ca[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(ca[i], bb[j], cb[i][j]);
      }
    for (int p = 0; p < P; ++p) {
      float ya[4], xb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ya[i] = Ys[(ty + 16 * i) * ldp + p];
#pragma unroll
      for (int j = 0; j < 4; ++j) xb[j] = Xs[(tx + 16 * j) * ldp + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gm[i][j] = fmaf(ya[i], xb[j], gm[i][j]);
    }
  };

  // ---- sweep 1: a key tile at a time: dx, dB, the column sums ----------
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    load_bc(Bs, Bm, k0);
    load_hp(Xs, x, k0);
    __syncthreads();
    // state terms of rows k = k0 + ty + 16 i: u = x dS'^T (into adb),
    // d_k dt_k B dS' (into adx)
    float adx[4][kPB], adb[4][kNB];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kPB; ++j) adx[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < kNB; ++j) adb[i][j] = 0.f;
    }
    for (int p = 0; p < P; ++p) {
      float xa[4], sb[kNB];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = Xs[(ty + 16 * i) * ldp + p];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        sb[j] = n < N ? St[n * ldp + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) adb[i][j] = fmaf(xa[i], sb[j], adb[i][j]);
    }
    for (int n = 0; n < N; ++n) {
      float ba[4], sb[kPB];
#pragma unroll
      for (int i = 0; i < 4; ++i) ba[i] = Bs[(ty + 16 * i) * ldn + n];
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        const int p = tx + 16 * j;
        sb[j] = p < P ? St[n * ldp + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j) adx[i][j] = fmaf(ba[i], sb[j], adx[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, k = k0 + r;
      const float dk = k < qe ? expf(total - seg_s[k]) : 0.f;
      const float dkdt = dk * (k < qe ? dt_s[k] : 0.f);
      float bu = 0.f;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        if (n < N) bu = fmaf(Bs[r * ldn + n], adb[i][j], bu);
        adb[i][j] *= dkdt;
      }
#pragma unroll
      for (int j = 0; j < kPB; ++j) adx[i][j] *= dkdt;
      bu = half_warp_sum(bu);
      if (tx == 0 && k < qe) {
        ddt_s[k] += dk * bu;
        R_s[k] = dkdt * bu;
      }
    }
    for (int qt = kt; qt < nt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // Cs, Ys, Ws, Ds and the partials are free
      load_bc(Cs, Cm, q0);
      load_hp(Ys, dy, q0);
      __syncthreads();
      float cb[4][4], gm[4][4];
      products(cb, gm, true);
      float rowm[4] = {0.f, 0.f, 0.f, 0.f};
      float cm[4] = {0.f, 0.f, 0.f, 0.f}, ct[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = k0 + tx + 16 * j;
          float w = 0.f, dcb = 0.f;
          if (kr <= qr && qr < qe) {
            const float L = expf(seg_s[qr] - seg_s[kr]);
            const float cbl = cb[i][j] * L;
            w = cbl * dt_s[kr];
            dcb = gm[i][j] * L * dt_s[kr];
            const float m = w * gm[i][j];
            rowm[i] += m;
            cm[j] += m;
            ct[j] = fmaf(cbl, gm[i][j], ct[j]);
          }
          Ws[(ty + 16 * i) * kLdW + tx + 16 * j] = round_t<T>(w);
          Ds[(ty + 16 * i) * kLdW + tx + 16 * j] = dcb;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = half_warp_sum(rowm[i]);
        const int qr = q0 + ty + 16 * i;
        if (tx == 0 && qr < qe) dseg_s[qr] += s;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        colM[ty * kT + tx + 16 * j] = cm[j];
        colT[ty * kT + tx + 16 * j] = ct[j];
      }
      __syncthreads();
      if (tid < kT && k0 + tid < qe) {
        float sm = 0.f, st = 0.f;
        for (int r = 0; r < 16; ++r) {
          sm += colM[r * kT + tid];
          st += colT[r * kT + tid];
        }
        dseg_s[k0 + tid] -= sm;
        ddt_s[k0 + tid] += st;
      }
      // dx += bf16(w)^T dy, dB += dcb^T C: key rows ty + 16 i
      for (int r = 0; r < kT; ++r) {
        float wa[4], da[4], yb[kPB], cc[kNB];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wa[i] = Ws[r * kLdW + ty + 16 * i];
          da[i] = Ds[r * kLdW + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
          const int p = tx + 16 * j;
          yb[j] = p < P ? Ys[r * ldp + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          const int n = tx + 16 * j;
          cc[j] = n < N ? Cs[r * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < kPB; ++j) adx[i][j] = fmaf(wa[i], yb[j], adx[i][j]);
#pragma unroll
          for (int j = 0; j < kNB; ++j) adb[i][j] = fmaf(da[i], cc[j], adb[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ty + 16 * i;
      if (k >= qe) continue;
      const int64_t row = (static_cast<int64_t>(b) * S + c0 + k) * H + h;
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        const int p = tx + 16 * j;
        if (p < P) dx[row * P + p] = from_f<T>(adx[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dBh[row * N + n] = adb[i][j];
      }
    }
  }

  // ---- sweep 2: a query tile at a time: dC, the inter-chunk d(seg) -----
  __syncthreads();
  float sdot = 0.f;  // s . dS', for the total's gradient
  for (int i = tid; i < N * P; i += kThreads) {
    const float s = state_at<kHiLo>(states, bhc, i, N * P);
    sdot = fmaf(s, dSout[bhc * N * P + i], sdot);
    St[(i / P) * ldp + i % P] = s;
  }
  red[tid] = sdot;
  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();
    load_bc(Cs, Cm, q0);
    load_hp(Ys, dy, q0);
    __syncthreads();
    // v = dy s^T (rows q0 + ty + 16 i, columns n = tx + 16 j)
    float adc[4][kNB];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j) adc[i][j] = 0.f;
    for (int p = 0; p < P; ++p) {
      float ya[4], sb[kNB];
#pragma unroll
      for (int i = 0; i < 4; ++i) ya[i] = Ys[(ty + 16 * i) * ldp + p];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        sb[j] = n < N ? St[n * ldp + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) adc[i][j] = fmaf(ya[i], sb[j], adc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, q = q0 + r;
      const float e = q < qe ? expf(seg_s[q]) : 0.f;
      const float er = round_t<T>(e);
      float cv = 0.f;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        if (n < N) cv = fmaf(Cs[r * ldn + n], adc[i][j], cv);
        adc[i][j] *= er;
      }
      cv = half_warp_sum(cv);
      if (tx == 0 && q < qe) dseg_s[q] += e * cv;
    }
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();
      load_bc(Bs, Bm, k0);
      load_hp(Xs, x, k0);
      __syncthreads();
      float cb[4][4], gm[4][4];
      products(cb, gm, false);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = k0 + tx + 16 * j;
          float dcb = 0.f;
          if (kr <= qr && qr < qe)
            dcb = gm[i][j] * expf(seg_s[qr] - seg_s[kr]) * dt_s[kr];
          Ds[(ty + 16 * i) * kLdW + tx + 16 * j] = dcb;
        }
      }
      __syncthreads();
      // dC += dcb B: query rows ty + 16 i
      for (int kk = 0; kk < kT; ++kk) {
        float da[4], bb[kNB];
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i] = Ds[(ty + 16 * i) * kLdW + kk];
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          const int n = tx + 16 * j;
          bb[j] = n < N ? Bs[kk * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNB; ++j) adc[i][j] = fmaf(da[i], bb[j], adc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q >= qe) continue;
      const int64_t row = (static_cast<int64_t>(b) * S + c0 + q) * H + h;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dCh[row * N + n] = adc[i][j];
      }
    }
  }
  __syncthreads();

  // ---- d(seg) -> da -> ddt, the chunk's dA ------------------------------
  if (tid == 0) {
    float sd = 0.f, rsum = 0.f;
    for (int i = 0; i < kThreads; ++i) sd += red[i];
    for (int k = 0; k < qe; ++k) rsum += R_s[k];
    const float dtot = expf(total) * sd + rsum;
    float run = 0.f, da_dt = 0.f;
    for (int k = qe - 1; k >= 0; --k) {
      run += dseg_s[k] - R_s[k] + (k == qe - 1 ? dtot : 0.f);
      ddt[(static_cast<int64_t>(b) * S + c0 + k) * H + h] =
          ddt_s[k] + run * a;
      da_dt = fmaf(run, dt_s[k], da_dt);
    }
    dA_part[(static_cast<int64_t>(b) * nc + c) * H + h] = da_dt;
  }
}

// ---- launch ---------------------------------------------------------------

struct Call {
  const void *x, *dt, *A, *Bm, *Cm, *dy, *states, *dfinal;
  float* dSout;
  void* dx;
  float *ddt, *dBh, *dCh, *dA_part;
  int B, S, H, G, N, P, Q, hilo, parts;
  cudaStream_t stream;
};

template <typename T, int kNB, int kPB, bool kHiLo>
int launch(const Call& k) {
  const size_t s1 = pass_smem(k.N, k.P, k.Q), s2 = chunk_smem(k.N, k.P, k.Q);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_state_pass<T, kNB, kPB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s1));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunk<T, kNB, kPB, kHiLo>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (k.parts & 1) {
    ssd_bwd_state_pass<T, kNB, kPB>
        <<<dim3(k.H, k.B), kThreads, s1, k.stream>>>(
            static_cast<const float*>(k.dt), static_cast<const float*>(k.A),
            static_cast<const T*>(k.Cm), static_cast<const T*>(k.dy),
            static_cast<const float*>(k.dfinal), k.dSout, k.S, k.H, k.G, k.N,
            k.P, k.Q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nc = (k.S + k.Q - 1) / k.Q;
  if (k.parts & 2)
    ssd_bwd_chunk<T, kNB, kPB, kHiLo>
        <<<dim3(nc, k.H, k.B), kThreads, s2, k.stream>>>(
            static_cast<const T*>(k.x), static_cast<const float*>(k.dt),
            static_cast<const float*>(k.A), static_cast<const T*>(k.Bm),
            static_cast<const T*>(k.Cm), static_cast<const T*>(k.dy),
            k.states, k.dSout, static_cast<T*>(k.dx), k.ddt, k.dBh, k.dCh,
            k.dA_part, k.S, k.H, k.G, k.N, k.P, k.Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kNB, int kPB>
int launch_s(const Call& k) {
  if (k.hilo) return launch<T, kNB, kPB, true>(k);
  return launch<T, kNB, kPB, false>(k);
}

template <typename T, int kNB>
int launch_p(const Call& k) {
  if (k.P <= 32) return launch_s<T, kNB, 2>(k);
  if (k.P <= 64) return launch_s<T, kNB, 4>(k);
  return launch_s<T, kNB, 8>(k);
}

template <typename T>
int launch_np(const Call& k) {
  if (k.N <= 32) return launch_p<T, 2>(k);
  return launch_p<T, 8>(k);
}

}  // namespace

// Shared memory the backward kernels need for (N, P, Q), in bytes (the
// larger of the two), and the limit.
extern "C" int64_t ssd_scan_bwd_smem_bytes(int n, int p, int q) {
  const size_t a = pass_smem(n, p, q), b = chunk_smem(n, p, q);
  return static_cast<int64_t>(a > b ? a : b);
}

extern "C" int64_t ssd_scan_bwd_smem_limit() { return kMaxSmem; }

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C, dy and dx; dt, A and every
// other buffer are float32).  Contiguous x (B,S,H,P), dt (B,S,H), A (H,),
// Bm/Cm (B,S,G,N), dy (B,S,H,P), the forward's chunk-start states: f32
// (B,H,nc,N,P) (hilo 0) or bf16 hi and lo (B,H,nc,2,N,P) (hilo 1, bf16
// only), dfinal (B,H,N,P) or null; the scratch dSout (B,H,nc,N,P); the
// outputs dx (B,S,H,P), ddt (B,S,H), dBh/dCh (B,S,H,N) per head and
// dA_part (B,nc,H).  nc = ceil(S / Q), Q <= S.  parts: 1 launches
// ssd_bwd_state_pass (which fills dSout), 2 ssd_bwd_chunk (which reads
// it), 3 both, in that order, on `stream`; returns the first CUDA error
// code (0 on success).
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* dy,
                                   const void* states, const void* dfinal,
                                   void* dSout, void* dx, void* ddt,
                                   void* dBh, void* dCh, void* dA_part,
                                   int B, int S, int H, int G, int N, int P,
                                   int Q, int dtype, int hilo, int parts,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      N > 128 || P <= 0 || P > 128 || Q <= 0 || Q > S ||
      (hilo && dtype != 1) || parts < 1 || parts > 3 ||
      ssd_scan_bwd_smem_bytes(N, P, Q) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Call k{x, dt, A, Bm, Cm, dy, states, dfinal,
         static_cast<float*>(dSout), dx, static_cast<float*>(ddt),
         static_cast<float*>(dBh), static_cast<float*>(dCh),
         static_cast<float*>(dA_part), B, S, H, G, N, P, Q, hilo, parts,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_np<float>(k);
  if (dtype == 1) return launch_np<bf16>(k);
  return static_cast<int>(cudaErrorInvalidValue);
}
