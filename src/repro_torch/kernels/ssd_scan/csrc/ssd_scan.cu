// Mamba-2 SSD (state-space duality) scan over a whole sequence, chunk by
// chunk, with the (N, P) state carried across chunks inside the kernel.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (_ssd_kernel, one chunk per launch, grid over batch x heads) and the
// host-side lax.scan of ssd_scan/ops.py::ssd_scan_op that carried the state
// from one chunk's launch to the next.  Per chunk of Q rows, for head h of
// group g = h / (H / G):
//   seg   = cumsum(dt * A)                  (sequential, in f32)
//   y     = (C * e^seg) @ s0                (inter-chunk)
//         + (tril(C B^T * e^(seg_q - seg_k) * dt_k)) @ x   (intra-chunk)
//   s0    = s0 * e^total + (B * e^(total - seg) * dt)^T @ x
// It reads the model's layout in place: x (B,S,H,P), dt (B,S,H) f32,
// A (H,) f32, B and C in group form (B,S,G,N) — the (B,S,H,N) expansion is
// never made.  A ragged last chunk is handled as the model's dt = 0
// padding would be: its missing rows add nothing and are not written.
// In bf16, e^seg (inter term) and the intra-chunk weights are rounded to
// bf16 before their products, as repro/models/ssm.py::ssd_chunked rounds
// them; in f32 that rounding is the identity.
//
// Design (simple and right; making it fast is later work): one CTA of 256
// threads per (head, batch).  It walks the chunks in order and keeps the
// state in shared memory.  The (Q, Q) weight matrix of a chunk does not fit
// shared memory at Q = 256 (256 KB in f32), so the intra-chunk term is
// tiled over 64-row query tiles and 64-row key tiles (only k-tiles <= the
// q-tile), with a 64 x 64 weight tile in shared memory.  Each thread owns
// a 4 x (P / 16) block of the output tile and an (N / 16) x (P / 16) block
// of the next state, in registers; products are scalar FMAs.
//
// Those instances hold the whole (N, P) state and the chunk's seg and dt
// in shared memory and a thread's share of the state in registers, so
// they take N, P up to 128 where it fits (chunk up to 5,952 at 128 x 128).
// Any other shape goes to ssd_wide_kernel, whose shared memory is fixed
// (~85 KB): each column of the state evolves on its own (s[:, p] meets
// only x[:, p]), so one CTA takes a (block of 64 P columns, head, batch)
// and keeps its columns of the state in the state output itself (device
// memory, in place); C B^T and C s are summed over 64-wide N slices
// staged through shared memory, and the state update is made one 64-row
// N block at a time.  seg comes from ssd_seg_kernel (ssd_seg.cuh), one
// launch before, into a (B, H, S) scratch; dt is read in place.  The
// arithmetic is the whole-row instances', term for term.
//
// What bounds it on an H100: at mamba2-130m's prefill shape (B 4, S 2048,
// H 24, P 64, N 128, G 1, Q 256, bf16 x/B/C) it moves ~58 MB (0.017 ms at
// 3.35 TB/s) and needs ~1e10 FLOPs (0.010 ms at the bf16 tensor rate), so
// bytes bound it.  One CTA per (b, h) gives only B * H = 96 CTAs on 132
// SMs, and scalar FMAs run far below the tensor rate: the kernel is bound
// by its own compute, far from either limit.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3), called through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

#include "ssd_seg.cuh"

constexpr int kT = 64;            // rows of a query / key tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kLdW = kT + 16;     // weight-tile row stride (floats)
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr int kWholeNP = 128;     // widest whole-state N and P

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
// round through T (the identity for float)
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

size_t smem_bytes(int n, int p, int q) {
  return sizeof(float) * (static_cast<size_t>(n) * p       // state
                          + 2 * static_cast<size_t>(kT) * (n + 1)  // C, B
                          + static_cast<size_t>(kT) * p    // x tile
                          + static_cast<size_t>(kT) * kLdW  // weights
                          + 2 * static_cast<size_t>(q));   // seg, dt
}

// N <= 16 * kNB, P <= 16 * kPB.
template <typename T, int kNB, int kPB>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, float* __restrict__ states, int S,
           int H, int G, int N, int P, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* St = smem;                 // N x P state
  float* Cs = St + N * P;           // kT x ldn
  float* Bs = Cs + kT * ldn;        // kT x ldn (B, or B * wk)
  float* Xs = Bs + kT * ldn;        // kT x P
  float* Ws = Xs + kT * P;          // kT x kLdW intra-chunk weights
  float* seg_s = Ws + kT * kLdW;    // Q
  float* dt_s = seg_s + Q;          // Q

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float a = A[h];

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.f;

  // element (s, c) of a (B,S,G,N) or (B,S,H,P) tensor
  auto bc_at = [&](const T* t, int s, int n) {
    return to_f(t[((static_cast<int64_t>(b) * S + s) * G + g) * N + n]);
  };
  auto x_at = [&](int s, int p) {
    return to_f(x[((static_cast<int64_t>(b) * S + s) * H + h) * P + p]);
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qe = min(Q, S - c0);  // rows of this chunk
    __syncthreads();                // the previous chunk is done
    if (states != nullptr) {        // the chunk's incoming state (backward)
      float* sc = states +
                  ((static_cast<int64_t>(b) * H + h) * ((S + Q - 1) / Q) +
                   c0 / Q) * N * P;
      for (int i = tid; i < N * P; i += kThreads) sc[i] = St[i];
    }
    for (int i = tid; i < qe; i += kThreads)
      dt_s[i] = dt[(static_cast<int64_t>(b) * S + c0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {  // jnp.cumsum's order: one running f32 sum
      float run = 0.f;
      for (int i = 0; i < qe; ++i) {
        run = __fadd_rn(run, __fmul_rn(dt_s[i], a));
        seg_s[i] = run;
      }
    }
    __syncthreads();
    const float total = seg_s[qe - 1];
    const int nt = (qe + kT - 1) / kT;

    // ---- outputs, one 64-row query tile at a time
    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // Cs / Bs / Xs / Ws are free
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N;
        Cs[r * ldn + n] = q0 + r < qe ? bc_at(Cm, c0 + q0 + r, n) : 0.f;
      }
      __syncthreads();
      float acc[4][kPB];
      float eseg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        eseg[i] = r < qe ? round_t<T>(expf(seg_s[r])) : 0.f;
#pragma unroll
        for (int j = 0; j < kPB; ++j) acc[i][j] = 0.f;
      }
      // inter-chunk: (C * e^seg) @ state
      for (int n = 0; n < N; ++n) {
        float ca[4], sb[kPB];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty + 16 * i) * ldn + n] * eseg[i];
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
          const int p = tx + 16 * j;
          sb[j] = p < P ? St[n * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kPB; ++j) acc[i][j] = fmaf(ca[i], sb[j], acc[i][j]);
      }
      // intra-chunk: key tiles at or below the query tile
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        __syncthreads();  // the previous key tile's readers are done
        for (int i = tid; i < kT * N; i += kThreads) {
          const int r = i / N, n = i % N;
          Bs[r * ldn + n] = k0 + r < qe ? bc_at(Bm, c0 + k0 + r, n) : 0.f;
        }
        for (int i = tid; i < kT * P; i += kThreads) {
          const int r = i / P, p = i % P;
          Xs[r * P + p] = k0 + r < qe ? x_at(c0 + k0 + r, p) : 0.f;
        }
        __syncthreads();
        float cb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kr = k0 + tx + 16 * j;
            float w = 0.f;
            if (kr <= qr && qr < qe)
              w = round_t<T>(cb[i][j] * expf(seg_s[qr] - seg_s[kr]) * dt_s[kr]);
            Ws[(ty + 16 * i) * kLdW + tx + 16 * j] = w;
          }
        }
        __syncthreads();
        for (int kk = 0; kk < kT; ++kk) {
          float wa[4], xb[kPB];
#pragma unroll
          for (int i = 0; i < 4; ++i) wa[i] = Ws[(ty + 16 * i) * kLdW + kk];
#pragma unroll
          for (int j = 0; j < kPB; ++j) {
            const int p = tx + 16 * j;
            xb[j] = p < P ? Xs[kk * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kPB; ++j) acc[i][j] = fmaf(wa[i], xb[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= qe) continue;
        T* yrow = y + ((static_cast<int64_t>(b) * S + c0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = from_f<T>(acc[i][j]);
        }
      }
    }

    // ---- state: s0 * e^total + (B * wk)^T @ x, wk = e^(total - seg) * dt
    float st[kNB][kPB];
    const float etot = expf(total);
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        const int p = tx + 16 * j;
        st[i][j] = (n < N && p < P) ? St[n * P + p] * etot : 0.f;
      }
    }
    for (int kt = 0; kt < nt; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N, kr = k0 + r;
        Bs[r * ldn + n] =
            kr < qe ? bc_at(Bm, c0 + kr, n) *
                          (expf(total - seg_s[kr]) * dt_s[kr])
                    : 0.f;
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int r = i / P, p = i % P;
        Xs[r * P + p] = k0 + r < qe ? x_at(c0 + k0 + r, p) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kT; ++kk) {
        float bb[kNB], xb[kPB];
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          const int n = ty + 16 * i;
          bb[i] = n < N ? Bs[kk * ldn + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
          const int p = tx + 16 * j;
          xb[j] = p < P ? Xs[kk * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int j = 0; j < kPB; ++j) st[i][j] = fmaf(bb[i], xb[j], st[i][j]);
      }
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        const int p = tx + 16 * j;
        if (n < N && p < P) St[n * P + p] = st[i][j];
      }
    }
  }
  __syncthreads();
  float* so = state_out + (static_cast<int64_t>(b) * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) so[i] = St[i];
}

// ---- any N, P and chunk: P in blocks over the grid, N in slices ---------

constexpr int kS = 64;             // columns of an N slice or a P block
constexpr int kLdS = kS + 1;       // slice row stride (floats)

size_t wide_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kT) * kLdS  // C, B
                          + static_cast<size_t>(kT) * kS      // x
                          + static_cast<size_t>(kS) * kS      // state
                          + static_cast<size_t>(kT) * kLdW);  // weights
}

// grid (P blocks, H, B).  state (B,H,N,P) f32 holds this CTA's columns of
// the running state (zeroed here) and ends as the final state; seg
// (B,H,S) from ssd_seg_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_wide_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                T* __restrict__ y, float* state, float* __restrict__ states,
                const float* __restrict__ seg, int S, int H, int G, int N,
                int P, int Q) {
  extern __shared__ float smem[];
  float* Cs = smem;                 // kT x kLdS: C rows, an N slice
  float* Bs = Cs + kT * kLdS;       // kT x kLdS: B (or B * wk) rows
  float* Xs = Bs + kT * kLdS;       // kT x kS: x rows, the CTA's columns
  float* Ss = Xs + kT * kS;         // kS x kS: a slice of the state
  float* Ws = Ss + kS * kS;         // kT x kLdW intra-chunk weights

  const int p0 = blockIdx.x * kS, pw = min(kS, P - p0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float* st = state + bh * N * P + p0;    // row n at st[n * P]
  const float* sg = seg + bh * S;

  auto bc_at = [&](const T* t, int s, int n) {
    return to_f(t[((static_cast<int64_t>(b) * S + s) * G + g) * N + n]);
  };
  auto x_at = [&](int s, int p) {
    return to_f(x[((static_cast<int64_t>(b) * S + s) * H + h) * P + p0 + p]);
  };
  auto dt_at = [&](int s) {
    return dt[(static_cast<int64_t>(b) * S + s) * H + h];
  };

  for (int i = tid; i < N * pw; i += kThreads) st[(i / pw) * P + i % pw] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qe = min(Q, S - c0);  // rows of this chunk
    __syncthreads();  // the state's last writes are visible
    if (states != nullptr) {  // the chunk's incoming state (backward)
      float* sc = states +
                  ((bh * ((S + Q - 1) / Q) + c0 / Q) * N) * P + p0;
      for (int i = tid; i < N * pw; i += kThreads) {
        const int n = i / pw, p = i % pw;
        sc[n * P + p] = st[n * P + p];
      }
    }
    const float* sgc = sg + c0;
    const float total = sgc[qe - 1];
    const int nt = (qe + kT - 1) / kT;

    // ---- outputs, one 64-row query tile at a time
    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * kT;
      float acc[4][4];
      float eseg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        eseg[i] = r < qe ? round_t<T>(expf(sgc[r])) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      // inter-chunk: (C * e^seg) @ state, over N slices
      for (int n0 = 0; n0 < N; n0 += kS) {
        const int nw = min(kS, N - n0);
        __syncthreads();  // Cs / Ss readers are done
        for (int i = tid; i < kT * nw; i += kThreads) {
          const int r = i / nw, n = i % nw;
          Cs[r * kLdS + n] = q0 + r < qe ? bc_at(Cm, c0 + q0 + r, n0 + n) : 0.f;
        }
        for (int i = tid; i < kS * kS; i += kThreads) {
          const int n = i / kS, p = i % kS;
          Ss[i] = n < nw && p < pw ? st[(n0 + n) * P + p] : 0.f;
        }
        __syncthreads();
        for (int n = 0; n < nw; ++n) {
          float ca[4], sb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty + 16 * i) * kLdS + n] * eseg[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) sb[j] = Ss[n * kS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ca[i], sb[j], acc[i][j]);
        }
      }
      // intra-chunk: key tiles at or below the query tile
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        float cb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
        for (int n0 = 0; n0 < N; n0 += kS) {
          const int nw = min(kS, N - n0);
          __syncthreads();  // Cs / Bs (and Ws / Xs) readers are done
          for (int i = tid; i < kT * nw; i += kThreads) {
            const int r = i / nw, n = i % nw;
            Cs[r * kLdS + n] =
                q0 + r < qe ? bc_at(Cm, c0 + q0 + r, n0 + n) : 0.f;
            Bs[r * kLdS + n] =
                k0 + r < qe ? bc_at(Bm, c0 + k0 + r, n0 + n) : 0.f;
          }
          __syncthreads();
          for (int n = 0; n < nw; ++n) {
            float ca[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty + 16 * i) * kLdS + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * kLdS + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(ca[i], bb[j], cb[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kr = k0 + tx + 16 * j;
            float w = 0.f;
            if (kr <= qr && qr < qe)
              w = round_t<T>(cb[i][j] * expf(sgc[qr] - sgc[kr]) *
                             dt_at(c0 + kr));
            Ws[(ty + 16 * i) * kLdW + tx + 16 * j] = w;
          }
        }
        for (int i = tid; i < kT * kS; i += kThreads) {
          const int r = i / kS, p = i % kS;
          Xs[i] = k0 + r < qe && p < pw ? x_at(c0 + k0 + r, p) : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < kT; ++kk) {
          float wa[4], xb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wa[i] = Ws[(ty + 16 * i) * kLdW + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) xb[j] = Xs[kk * kS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wa[i], xb[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= qe) continue;
        T* yrow = y + ((static_cast<int64_t>(b) * S + c0 + r) * H + h) * P + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < pw) yrow[p] = from_f<T>(acc[i][j]);
        }
      }
    }

    // ---- state: s0 * e^total + (B * wk)^T @ x, wk = e^(total - seg) * dt,
    // one 64-row N block at a time, each thread its own elements in place
    const float etot = expf(total);
    for (int n0 = 0; n0 < N; n0 += kS) {
      const int nw = min(kS, N - n0);
      float sv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sv[i][j] = (n < nw && p < pw) ? st[(n0 + n) * P + p] * etot : 0.f;
        }
      }
      for (int kt = 0; kt < nt; ++kt) {
        const int k0 = kt * kT;
        __syncthreads();  // Bs / Xs readers (and the outputs' reads of
                          // the state) are done
        for (int i = tid; i < kT * nw; i += kThreads) {
          const int r = i / nw, n = i % nw, kr = k0 + r;
          Bs[r * kLdS + n] =
              kr < qe ? bc_at(Bm, c0 + kr, n0 + n) *
                            (expf(total - sgc[kr]) * dt_at(c0 + kr))
                      : 0.f;
        }
        for (int i = tid; i < kT * kS; i += kThreads) {
          const int r = i / kS, p = i % kS;
          Xs[i] = k0 + r < qe && p < pw ? x_at(c0 + k0 + r, p) : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < kT; ++kk) {
          float bb[4], xb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = ty + 16 * i;
            bb[i] = n < nw ? Bs[kk * kLdS + n] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) xb[j] = Xs[kk * kS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sv[i][j] = fmaf(bb[i], xb[j], sv[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (n < nw && p < pw) st[(n0 + n) * P + p] = sv[i][j];
        }
      }
    }
  }
}

template <typename T>
int launch_wide(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* state, void* states,
                void* seg, int B, int S, int H, int G, int N, int P, int Q,
                cudaStream_t stream) {
  const size_t smem = wide_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = launch_seg(static_cast<const float*>(dt),
                     static_cast<const float*>(A), static_cast<float*>(seg),
                     B, S, H, Q, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_wide_kernel<T><<<dim3((P + kS - 1) / kS, H, B), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), static_cast<float*>(state),
      static_cast<float*>(states), static_cast<const float*>(seg), S, H, G,
      N, P, Q);
  return static_cast<int>(cudaGetLastError());
}

// whether (N, P, Q) takes the whole-state instances
bool takes_whole_state(int n, int p, int q) {
  return n <= kWholeNP && p <= kWholeNP && smem_bytes(n, p, q) <= kMaxSmem;
}

template <typename T, int kNB, int kPB>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* states, int B, int S,
           int H, int G, int N, int P, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, P, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, kNB, kPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T, kNB, kPB><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), static_cast<float*>(states), S, H, G, N,
      P, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kNB>
int launch_p(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, void* states, int B, int S,
             int H, int G, int N, int P, int Q, cudaStream_t stream) {
  if (P <= 32)
    return launch<T, kNB, 2>(x, dt, A, Bm, Cm, y, state, states, B, S,
                             H, G, N, P, Q, stream);
  if (P <= 64)
    return launch<T, kNB, 4>(x, dt, A, Bm, Cm, y, state, states, B, S,
                             H, G, N, P, Q, stream);
  return launch<T, kNB, 8>(x, dt, A, Bm, Cm, y, state, states, B, S,
                             H, G, N, P, Q, stream);
}

template <typename T>
int launch_np(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* state, void* states, int B,
              int S, int H, int G, int N, int P, int Q, cudaStream_t stream) {
  if (N <= 32)
    return launch_p<T, 2>(x, dt, A, Bm, Cm, y, state, states, B, S, H,
                          G, N, P, Q, stream);
  return launch_p<T, 8>(x, dt, A, Bm, Cm, y, state, states, B, S, H,
                          G, N, P, Q, stream);
}

}  // namespace

// Bytes of f32 scratch a launch at (B, S, H, N, P, Q) needs (the head-
// tiled kernel's seg), 0 for the whole-state instances.
extern "C" int64_t ssd_scan_work_bytes(int B, int S, int H, int N, int P,
                                       int Q) {
  if (takes_whole_state(N, P, Q)) return 0;
  return static_cast<int64_t>(sizeof(float)) * B * H * S;
}

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y; dt, A and the state
// are float32).  Contiguous x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
// (B,S,G,N), y (B,S,H,P), state (B,H,N,P); Q the chunk (<= S); any N, P,
// Q >= 1.  states: null, or a float32 (B,H,nc,N,P), nc = ceil(S / Q),
// that gets each chunk's incoming state (the backward pass reads them).
// work: ssd_scan_work_bytes of scratch (null when that is 0).  Launches on
// `stream` and returns the CUDA error code (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, void* states, void* work, int B,
                               int S, int H, int G, int N, int P, int Q,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      P <= 0 || Q <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes_whole_state(N, P, Q)) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
      return launch_wide<float>(x, dt, A, Bm, Cm, y, state, states, work, B,
                                S, H, G, N, P, Q, st);
    return launch_wide<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, states,
                                      work, B, S, H, G, N, P, Q, st);
  }
  if (dtype == 0)
    return launch_np<float>(x, dt, A, Bm, Cm, y, state, states, B, S, H, G, N,
                            P, Q, st);
  return launch_np<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, states, B, S,
                                  H, G, N, P, Q, st);
}
