// Mamba-2 SSD (state-space duality) scan over a whole sequence on Hopper's
// tensor cores, chunk-parallel: the bf16 route of the SSD scan.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (_ssd_kernel, one chunk per launch over a batch x heads grid) with the
// host-side lax.scan of repro/kernels/ssd_scan/ops.py::ssd_scan_op that
// carried the state from one chunk's launch to the next.  It computes
// what ../ref.py::ssd_scan_ref computes (repro/models/ssm.py::ssd_chunked):
// per chunk of Q rows, for head h of group g = h / (H / G),
//   seg   = cumsum(dt * A)                             (f32, in order)
//   y     = (C * bf16(e^seg)) @ s_in                   (inter-chunk)
//         + bf16(tril(C B^T * e^(seg_q - seg_k) * dt_k)) @ x  (intra)
//   s_out = s_in * e^total + (B * e^(total - seg) * dt)^T @ x
// in the model's layout: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B and C
// in group form (B,S,G,N).  A ragged last chunk keeps the dt = 0 padding's
// meaning: its missing rows add nothing and are not written.
//
// Design: the SSD algorithm's own steps, each a launch with many CTAs
// (the scalar kernel ssd_scan.cu walks the chunks of one (head, batch) in
// one CTA: 96 CTAs at mamba2-130m's shape, scalar FMAs):
// 1. ssd_chunk_cb, one CTA per (64 x 64 tile on or below the diagonal,
//    chunk, group x batch): C B^T of the group, once for all its heads;
// 2. ssd_chunk_state, one CTA per (chunk, head, batch): seg as one running
//    f32 sum (jnp.cumsum's order, by one thread), then the chunk's own
//    state dS_c = (B * wk)^T @ x, an (N, P) f32 tile, into a scratch of
//    (B, H, nc, N, P) f32;
// 3. ssd_state_pass, one thread per 4 state elements of one (head,
//    batch): s_c = s_{c-1} * e^total_c + dS_c in chunk order, the
//    reference's operations in its order, writing each chunk's incoming
//    state, split into bf16 hi + lo, and the final state;
// 4. ssd_chunk_scan, one CTA per (64-row query tile, chunk, head, batch):
//    the inter-chunk product, then the key tiles at or below the query
//    tile: the masked decayed weights from C B^T, rounded to bf16 straight
//    into the A fragments of their product with x.  The inter-chunk
//    operands and then, over them, the intra-chunk ones share one
//    shared-memory region (4 CTAs an SM at mamba2-130m's widths).
// Products run as mma.sync m16n8k16 (bf16 in, f32 accumulate) from
// ldmatrix'd shared-memory tiles; C B^T and x tiles come in by cp.async,
// double buffered.  The reference rounds x and the intra-chunk weights to
// bf16, so w @ x is exact on bf16 tensor cores.  The two products with an
// f32 operand, (B * wk)^T @ x and C @ s_in, split it into bf16 hi + lo
// (x - hi rounded again): two products, about 16 significant bits,
// against TF32's 11.  C B^T is not on the tensor cores: its last bits
// decide how w rounds to bf16 (ssd_chunk_cb), so it is one fmaf chain in
// the plain version's order, on the FP32 units (2% of the scan's FLOPs at
// G = 1, once per group).
//
// What bounds it on an H100: at mamba2-130m's prefill shape (B 4, S
// 2048, H 24, P 64, N 128, G 1, Q 256) the scan's own inputs and outputs
// are ~58 MB (0.017 ms at 3.35 TB/s) and ~1e10 FLOPs (0.010 ms at the
// bf16 tensor rate): bytes.  The launches add their scratch: each
// chunk's own state (25 MB f32) written and read, its incoming state (25
// MB as bf16 hi + lo) written and read once per query tile, C B^T (8 MB
// f32) written once and read by every head of the group, and C and x
// tiles read again by several CTAs, most of it out of the 50 MB L2.
// Measured (PERF.md), ssd_chunk_scan takes most of the time, and its
// key-tile loop waits on its loads (two cp.async stages, little work a
// stage): CTAs that took two heads and read C and C B^T once for both
// were slower, so it is not L2's bandwidth that bounds it.
// N and P are compiled as 32, 64 or 128 (zero padded above the true
// width, a multiple of 16).
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3), called through ctypes.  Built with
// -DSSD_TC_TIMING (tools/ssd_tc_profile.py), ssd_chunk_state and
// ssd_chunk_scan record each CTA's SM and the %globaltimer at the ends of
// their phases, for ssd_scan_tc_timing_copy; the library does not.
#include <cstdint>

#include "mma_common.cuh"

namespace {

constexpr int kScanThreads = 128; // ssd_chunk_scan: a warp per 16 rows
constexpr int kPassThreads = 256;

#ifdef SSD_TC_TIMING
// per CTA: [0] start, [1..k] the ends of its phases, [7] its SM; the
// chunk-scan CTAs first, the chunk-state CTAs from kTimingState on
constexpr int kTimingRows = 1 << 16, kTimingState = 1 << 15;
__device__ unsigned long long g_timing[kTimingRows][8];
__device__ __forceinline__ void timing_mark(int base, int k) {
  if (threadIdx.x != 0) return;
  const int cta = base + blockIdx.x
                  + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (cta >= kTimingRows) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_timing[cta][k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_timing[cta][7] = sm;
  }
}
#define SSD_MARK(base, k) timing_mark(base, k)
#else
#define SSD_MARK(base, k)
#endif

// ---- 1. chunk states ------------------------------------------------------

template <int kN, int kP>
size_t state_smem(int Q) {
  return sizeof(bf16) * 2 * kT * ((kN + kPad) + (kP + kPad))
         + sizeof(float) * 3 * static_cast<size_t>(tiled(Q));
}

// grid (nc, H, B).  seg_out (B, H, nc, 2, Q): the chunk's seg (rows past
// the ragged end at its total), then its dt (0 past the end), for the
// later launches; dS (B, H, nc, N, P): the chunk's own state.
template <int kN, int kP>
__global__ void __launch_bounds__(kN * 2)
ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                float* __restrict__ dS, float* __restrict__ seg_out, int S,
                int H, int G, int N, int P, int Q) {
  constexpr int kThreads = kN * 2;  // a warp per 16 rows of N
  constexpr int kLdB = kN + kPad, kLdX = kP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);   // 2 stages of kT x kLdB
  bf16* Xs = Bs + 2 * kT * kLdB;              // 2 stages of kT x kLdX
  float* seg_s = reinterpret_cast<float*>(Xs + 2 * kT * kLdX);  // tiled(Q)
  float* dt_s = seg_s + tiled(Q);             // dt (0 past qe)
  float* wk_s = dt_s + tiled(Q);              // wk (0 past qe)

  SSD_MARK(kTimingState, 0);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * Q;
  const int qe = min(Q, S - c0);              // rows of this chunk
  const int nt = (qe + kT - 1) / kT;
  const int64_t ldb = static_cast<int64_t>(G) * N;
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const bf16* Bg = Bm + (static_cast<int64_t>(b) * S + c0) * ldb
                   + static_cast<int64_t>(g) * N;
  const bf16* Xg = x + (static_cast<int64_t>(b) * S + c0) * ldx
                   + static_cast<int64_t>(h) * P;
  const float* dtg = dt + (static_cast<int64_t>(b) * S + c0) * H + h;

  load_tile<kN, kThreads>(Bs, Bg, ldb, qe, N);
  load_tile<kP, kThreads>(Xs, Xg, ldx, qe, P);
  cp_commit();

  for (int i = tid; i < tiled(Q); i += kThreads)
    dt_s[i] = i < qe ? dtg[static_cast<int64_t>(i) * H] : 0.f;
  __syncthreads();
  if (tid == 0) {  // jnp.cumsum's order: one running f32 sum
    constexpr int kRun = 16;  // dt * A of 16 rows in registers, then adds
    const float a = A[h];
    float run = 0.f;
    for (int i0 = 0; i0 < tiled(Q); i0 += kRun) {
      float v[kRun];
#pragma unroll
      for (int e = 0; e < kRun; ++e) v[e] = __fmul_rn(dt_s[i0 + e], a);
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if (i0 + e < qe) run = __fadd_rn(run, v[e]);
        seg_s[i0 + e] = run;
      }
    }
  }
  __syncthreads();
  const float total = seg_s[qe - 1];
  float* seg_g = seg_out + ((static_cast<int64_t>(b) * H + h) * nc + c) * 2
                               * Q;
  for (int i = tid; i < tiled(Q); i += kThreads) {
    const float sg = seg_s[i];
    if (i < Q) {
      seg_g[i] = sg;
      seg_g[Q + i] = dt_s[i];
    }
    wk_s[i] = i < qe ? __fmul_rn(expf(__fsub_rn(total, sg)), dt_s[i]) : 0.f;
  }
  __syncthreads();

  SSD_MARK(kTimingState, 1);
  // dS = (B * wk)^T @ x: this warp's 16 rows of N, all of P
  const int m0 = warp * 16, tig = lane & 3;
  float acc[kP / 8][4];
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {  // the next 64 rows into the other stage
      const int r0 = (kt + 1) * kT;
      load_tile<kN, kThreads>(Bs + ((kt + 1) & 1) * kT * kLdB,
                              Bg + r0 * ldb, ldb, qe - r0, N);
      load_tile<kP, kThreads>(Xs + ((kt + 1) & 1) * kT * kLdX,
                              Xg + r0 * ldx, ldx, qe - r0, P);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Bt = Bs + (kt & 1) * kT * kLdB;
    const bf16* Xt = Xs + (kt & 1) * kT * kLdX;
    const float* wkt = wk_s + kt * kT;
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      // A (m = n, k = q) is B^T: B's tile [q][n] through ldmatrix.trans
      uint32_t araw[4], ahi[4], alo[4];
      ldsm_x4_t(araw, Bt + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdB
                          + m0 + ((lane >> 3) & 1) * 8);
      const int k = ks * 16 + 2 * tig;
      const float w0 = wkt[k], w1 = wkt[k + 1];
      const float w2 = wkt[k + 8], w3 = wkt[k + 9];
      split(__fmul_rn(lo_f(araw[0]), w0), __fmul_rn(hi_f(araw[0]), w1),
            ahi[0], alo[0]);
      split(__fmul_rn(lo_f(araw[1]), w0), __fmul_rn(hi_f(araw[1]), w1),
            ahi[1], alo[1]);
      split(__fmul_rn(lo_f(araw[2]), w2), __fmul_rn(hi_f(araw[2]), w3),
            ahi[2], alo[2]);
      split(__fmul_rn(lo_f(araw[3]), w2), __fmul_rn(hi_f(araw[3]), w3),
            ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < kP / 16; ++j) {
        uint32_t bx[4];  // x's tile [q][p]: two 8-column n-tiles
        ldsm_x4_t(bx, Xt + (ks * 16 + (lane & 15)) * kLdX + j * 16
                          + (lane >> 4) * 8);
        mma(acc[2 * j], ahi, bx[0], bx[1]);
        mma(acc[2 * j], alo, bx[0], bx[1]);
        mma(acc[2 * j + 1], ahi, bx[2], bx[3]);
        mma(acc[2 * j + 1], alo, bx[2], bx[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  SSD_MARK(kTimingState, 2);
  float* out = dS + ((static_cast<int64_t>(b) * H + h) * nc + c) * N * P;
  const int r = m0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kP / 8; ++j) {
    const int col = j * 8 + 2 * tig;
    if (col >= P) continue;
    if (r < N)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(r) * P + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (r + 8 < N)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(r + 8) * P
                                 + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ---- 2. state passing -----------------------------------------------------

// grid (ceil(N P / 4 / kPassThreads), B H).  dS (B, H, nc, N, P): each
// chunk's own state; s_in (B, H, nc, 2, N, P) bf16: each chunk's incoming
// state split into hi, then lo; state (B, H, N, P): the final state.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ dS, const float* __restrict__ seg,
               bf16* __restrict__ s_in, float* __restrict__ state, int S,
               int N, int P, int Q, int nc) {
  const int bh = blockIdx.y;
  const int i4 = blockIdx.x * kPassThreads + threadIdx.x;
  const int n4 = N * P / 4;
  if (i4 >= n4) return;
  const float4* d = reinterpret_cast<const float4*>(
                        dS + static_cast<int64_t>(bh) * nc * N * P) + i4;
  uint2* out = reinterpret_cast<uint2*>(
                   s_in + static_cast<int64_t>(bh) * nc * 2 * N * P) + i4;
  const float* sg = seg + static_cast<int64_t>(bh) * nc * 2 * Q;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 next = d[0];
  for (int c = 0; c < nc; ++c) {
    const float4 ds = next;
    if (c + 1 < nc) next = d[static_cast<int64_t>(c + 1) * n4];
    uint2 hi, lo;
    split(s.x, s.y, hi.x, lo.x);
    split(s.z, s.w, hi.y, lo.y);
    out[static_cast<int64_t>(2 * c) * n4] = hi;
    out[static_cast<int64_t>(2 * c + 1) * n4] = lo;
    const int qe = min(Q, S - c * Q);
    const float e = expf(sg[static_cast<int64_t>(c) * 2 * Q + qe - 1]);
    s.x = __fadd_rn(__fmul_rn(s.x, e), ds.x);
    s.y = __fadd_rn(__fmul_rn(s.y, e), ds.y);
    s.z = __fadd_rn(__fmul_rn(s.z, e), ds.z);
    s.w = __fadd_rn(__fmul_rn(s.w, e), ds.w);
  }
  reinterpret_cast<float4*>(state + static_cast<int64_t>(bh) * N * P)[i4] = s;
}

// ---- 4. chunk outputs -----------------------------------------------------

constexpr int kLdCb = kT + 4;     // f32 a shared C B^T row is padded by

// Shared memory of ssd_chunk_scan: the inter-chunk product's operands (C
// and s_in's hi and lo) and then, over them, the intra-chunk product's
// (two stages of C B^T and x), then seg and dt.
template <int kN, int kP>
__host__ __device__ constexpr size_t scan_phase1() {
  return sizeof(bf16) * (kT * (kN + kPad) + 2 * kN * (kP + kPad));
}
template <int kN, int kP>
__host__ __device__ constexpr size_t scan_phase2() {
  return 2 * (sizeof(float) * kT * kLdCb + sizeof(bf16) * kT * (kP + kPad));
}
template <int kN, int kP>
size_t scan_smem(int Q) {
  constexpr size_t a = scan_phase1<kN, kP>(), b = scan_phase2<kN, kP>();
  return (a > b ? a : b) + sizeof(float) * 2 * static_cast<size_t>(tiled(Q));
}

// grid (nc * ceil(Q / kT), H, B): query tile qt of chunk c.  s_in as
// ssd_state_pass leaves it, seg as ssd_chunk_state leaves it, cb as
// ssd_chunk_cb leaves it.
// (4 CTAs an SM at P <= 64: at most 128 registers)
template <int kN, int kP>
__global__ void __launch_bounds__(kScanThreads, kP <= 64 ? 4 : 2)
ssd_chunk_scan(const bf16* __restrict__ x, const bf16* __restrict__ Cm,
               const float* __restrict__ cb, const bf16* __restrict__ s_in,
               const float* __restrict__ seg, bf16* __restrict__ y, int S,
               int H, int G, int N, int P, int Q, int nc) {
  constexpr int kLdN = kN + kPad, kLdP = kP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  // phase 1
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // kT x kLdN
  bf16* Shi = Cs + kT * kLdN;                 // kN x kLdP
  bf16* Slo = Shi + kN * kLdP;                // kN x kLdP
  // phase 2, over phase 1
  float* CBs = reinterpret_cast<float*>(smem);  // 2 stages of kT x kLdCb
  bf16* Xs = reinterpret_cast<bf16*>(CBs + 2 * kT * kLdCb);  // 2 x kT x kLdP
  // rows [0, rows) of the chunk's seg and dt (tiled(Q) long)
  constexpr size_t kPh1 = scan_phase1<kN, kP>(), kPh2 = scan_phase2<kN, kP>();
  float* seg_s = reinterpret_cast<float*>(smem + (kPh1 > kPh2 ? kPh1 : kPh2));
  float* dt_s = seg_s + tiled(Q);

  SSD_MARK(0, 0);
  const int qtiles = (Q + kT - 1) / kT;
  const int c = blockIdx.x / qtiles, qt = blockIdx.x % qtiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * Q;
  const int qe = min(Q, S - c0);
  const int q0 = qt * kT;
  if (q0 >= qe) return;  // past the ragged end: no row to write
  const int rows = min(qe, q0 + kT);  // rows [0, rows) are read
  const int Qt = tiled(Q);
  const int64_t ldb = static_cast<int64_t>(G) * N;
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * S + c0;
  const bf16* Cg = Cm + row0 * ldb + static_cast<int64_t>(g) * N;
  const bf16* Xg = x + row0 * ldx + static_cast<int64_t>(h) * P;
  const float* CBg = cb + ((static_cast<int64_t>(b) * G + g) * nc + c) * Qt
                              * Qt + static_cast<int64_t>(q0) * Qt;

  // this query tile's 64 rows of C B^T at key tile kt, into a stage
  auto load_cb = [&](float* dst, int kt) {
    for (int i = tid; i < kT * (kT / 4); i += kScanThreads) {
      const int r = i / (kT / 4), ch = i % (kT / 4);
      cp_async16(dst + r * kLdCb + ch * 4, CBg + r * Qt + kt * kT + ch * 4,
                 true);
    }
  };
  const int64_t bhc = (static_cast<int64_t>(b) * H + h) * nc + c;
  // the incoming state's hi and lo (N x P each), zero past N and P
  const bf16* sg = s_in + bhc * 2 * N * P;
  load_tile<kN, kScanThreads>(Cs, Cg + q0 * ldb, ldb, qe - q0, N);
  load_rows<kN, kP, kScanThreads>(Shi, sg, P, N, P);
  load_rows<kN, kP, kScanThreads>(Slo, sg + N * P, P, N, P);
  cp_commit();

  for (int i = tid; i < rows; i += kScanThreads) {
    seg_s[i] = seg[bhc * 2 * Q + i];
    dt_s[i] = seg[bhc * 2 * Q + Q + i];
  }
  cp_wait<0>();  // C and the state have landed
  __syncthreads();
  SSD_MARK(0, 1);

  const int m0 = warp * 16, tig = lane & 3;
  const int r_lo = q0 + m0 + (lane >> 2), r_hi = r_lo + 8;  // chunk rows
  float acc[kP / 8][4];
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // inter-chunk: (C @ s_in) scaled by bf16(e^seg) a row
#pragma unroll
  for (int ks = 0; ks < kN / 16; ++ks) {
    uint32_t ac[4];
    ldsm_x4(ac, Cs + (m0 + (lane & 15)) * kLdN + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kP / 16; ++j) {
      uint32_t bh[4], bl[4];
      const int off = (ks * 16 + (lane & 15)) * kLdP + j * 16
                      + (lane >> 4) * 8;
      ldsm_x4_t(bh, Shi + off);
      ldsm_x4_t(bl, Slo + off);
      mma(acc[2 * j], ac, bh[0], bh[1]);
      mma(acc[2 * j], ac, bl[0], bl[1]);
      mma(acc[2 * j + 1], ac, bh[2], bh[3]);
      mma(acc[2 * j + 1], ac, bl[2], bl[3]);
    }
  }
  {
    const float e_lo = r_lo < qe ? round_bf16(expf(seg_s[r_lo])) : 0.f;
    const float e_hi = r_hi < qe ? round_bf16(expf(seg_s[r_hi])) : 0.f;
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      acc[j][0] = __fmul_rn(acc[j][0], e_lo);
      acc[j][1] = __fmul_rn(acc[j][1], e_lo);
      acc[j][2] = __fmul_rn(acc[j][2], e_hi);
      acc[j][3] = __fmul_rn(acc[j][3], e_hi);
    }
  }
  SSD_MARK(0, 2);
  __syncthreads();  // phase 1's operands are read: phase 2 goes over them
  load_cb(CBs, 0);
  load_tile<kP, kScanThreads>(Xs, Xg, ldx, qe, P);
  cp_commit();

  // intra-chunk: key tiles 0..qt
  for (int kt = 0; kt <= qt; ++kt) {
    if (kt + 1 <= qt) {
      const int r0 = (kt + 1) * kT;
      load_cb(CBs + ((kt + 1) & 1) * kT * kLdCb, kt + 1);
      load_tile<kP, kScanThreads>(Xs + ((kt + 1) & 1) * kT * kLdP,
                                  Xg + r0 * ldx, ldx, qe - r0, P);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* CBt = CBs + (kt & 1) * kT * kLdCb;
    const bf16* Xt = Xs + (kt & 1) * kT * kLdP;

    // w = bf16(C B^T * e^(seg_q - seg_k) * dt_k) on and below the
    // diagonal, made in the layout of w @ x's A fragments
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t aw[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = kk * 16 + half * 8 + 2 * tig;  // key in the tile
        const int k0 = kt * kT + col;                  // key in the chunk
        const float2 cb_lo = *reinterpret_cast<const float2*>(
            CBt + (m0 + (lane >> 2)) * kLdCb + col);
        const float2 cb_hi = *reinterpret_cast<const float2*>(
            CBt + (m0 + (lane >> 2) + 8) * kLdCb + col);
        const float cbv[4] = {cb_lo.x, cb_lo.y, cb_hi.x, cb_hi.y};
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = e < 2 ? r_lo : r_hi, kr = k0 + (e & 1);
          const int qc = min(qr, rows - 1), kc = min(kr, rows - 1);
          const float v = __fmul_rn(
              __fmul_rn(cbv[e], expf(__fsub_rn(seg_s[qc], seg_s[kc]))),
              dt_s[kc]);
          w[e] = (kr <= qr && qr < qe) ? v : 0.f;
        }
        aw[2 * half] = pack(w[0], w[1]);
        aw[2 * half + 1] = pack(w[2], w[3]);
      }
#pragma unroll
      for (int j = 0; j < kP / 16; ++j) {
        uint32_t bx[4];
        ldsm_x4_t(bx, Xt + (kk * 16 + (lane & 15)) * kLdP + j * 16
                          + (lane >> 4) * 8);
        mma(acc[2 * j], aw, bx[0], bx[1]);
        mma(acc[2 * j + 1], aw, bx[2], bx[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  SSD_MARK(0, 3);
#pragma unroll
  for (int j = 0; j < kP / 8; ++j) {
    const int col = j * 8 + 2 * tig;
    if (col >= P) continue;
    if (r_lo < qe)
      *reinterpret_cast<uint32_t*>(y + ((row0 + r_lo) * H + h) * P + col) =
          pack(acc[j][0], acc[j][1]);
    if (r_hi < qe)
      *reinterpret_cast<uint32_t*>(y + ((row0 + r_hi) * H + h) * P + col) =
          pack(acc[j][2], acc[j][3]);
  }
  SSD_MARK(0, 4);
}

// ---- launch ---------------------------------------------------------------

struct Call {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* state;
  float* dS;
  bf16* s_in;
  float* seg;
  float* cb;
  int B, S, H, G, N, P, Q, nc;
  cudaStream_t stream;
};

template <int kN, int kP>
int smem_need(int Q) {
  const size_t a = state_smem<kN, kP>(Q), b = scan_smem<kN, kP>(Q);
  return static_cast<int>(a > b ? a : b);
}

template <int kN, int kP>
int launch(const Call& k) {
  const size_t s0 = cb_smem(k.N), s1 = state_smem<kN, kP>(k.Q);
  const size_t s3 = scan_smem<kN, kP>(k.Q);
  if (s1 > kMaxSmem || s3 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s0));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_state<kN, kP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s1));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_scan<kN, kP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s3));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int qtiles = (k.Q + kT - 1) / kT;
  ssd_chunk_cb<<<dim3(qtiles * qtiles, k.nc, k.B * k.G), kCbThreads, s0,
                 k.stream>>>(k.Bm, k.Cm, k.cb, k.S, k.G, k.N, k.Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_state<kN, kP>
      <<<dim3(k.nc, k.H, k.B), kN * 2, s1, k.stream>>>(
          k.x, k.dt, k.A, k.Bm, k.dS, k.seg, k.S, k.H, k.G, k.N, k.P, k.Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n4 = k.N * k.P / 4;
  ssd_state_pass<<<dim3((n4 + kPassThreads - 1) / kPassThreads, k.B * k.H),
                   kPassThreads, 0, k.stream>>>(k.dS, k.seg, k.s_in,
                                                k.state, k.S, k.N, k.P, k.Q,
                                                k.nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_scan<kN, kP>
      <<<dim3(k.nc * qtiles, k.H, k.B), kScanThreads, s3, k.stream>>>(
          k.x, k.Cm, k.cb, k.s_in, k.seg, k.y, k.S, k.H, k.G, k.N, k.P, k.Q,
          k.nc);
  return static_cast<int>(cudaGetLastError());
}

template <int kN>
int launch_p(const Call& k) {
  if (k.P <= 32) return launch<kN, 32>(k);
  if (k.P <= 64) return launch<kN, 64>(k);
  return launch<kN, 128>(k);
}

bool widths_ok(int N, int P) {
  return N > 0 && N <= 128 && N % 16 == 0 && P > 0 && P <= 128
         && P % 16 == 0;
}

}  // namespace

extern "C" {

// The most shared memory a block of the scan takes for (N, P, Q), in
// bytes (-1 for widths it does not take), and the card's limit.
int64_t ssd_scan_tc_smem_bytes(int N, int P, int Q) {
  if (!widths_ok(N, P) || Q < 1) return -1;
  const int kn = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int kp = P <= 32 ? 32 : P <= 64 ? 64 : 128;
  // the largest of the nine instances' two kernels is (kn, kp)'s
  int need = 0;
#define SSD_TC_CASE(a, b) \
  if (kn == a && kp == b) need = smem_need<a, b>(Q);
  SSD_TC_CASE(32, 32) SSD_TC_CASE(32, 64) SSD_TC_CASE(32, 128)
  SSD_TC_CASE(64, 32) SSD_TC_CASE(64, 64) SSD_TC_CASE(64, 128)
  SSD_TC_CASE(128, 32) SSD_TC_CASE(128, 64) SSD_TC_CASE(128, 128)
#undef SSD_TC_CASE
  return need;
}

int64_t ssd_scan_tc_smem_limit() { return kMaxSmem; }

#ifdef SSD_TC_TIMING
// The timing marks of the last launch into dst (8 x 2^16 uint64).
int ssd_scan_tc_timing_copy(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_timing, sizeof(g_timing)));
}
#endif

// bfloat16 x, B, C and y; float32 dt, A, the state and the scratch.
// Contiguous x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N), y
// (B,S,H,P), state (B,H,N,P) and the scratch: dS (B,H,nc,N,P) f32, s_in
// (B,H,nc,2,N,P) bf16, seg (B,H,nc,2,Q) f32 and cb (B,G,nc,Qt,Qt) f32
// with nc = ceil(S / Q), Qt = Q rounded up to a multiple of 64; x, Bm, Cm
// 16-byte aligned; N and P multiples of 16 up to 128; Q the chunk (<= S).
// Four launches on `stream`; returns the first CUDA error code (0 on
// success).
int ssd_scan_tc_launch(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state,
                       void* dS, void* s_in, void* seg, void* cb, int B,
                       int S, int H, int G, int N, int P, int Q,
                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0
      || Q > S || !widths_ok(N, P))
    return static_cast<int>(cudaErrorInvalidValue);
  Call k{static_cast<const bf16*>(x),  static_cast<const float*>(dt),
         static_cast<const float*>(A), static_cast<const bf16*>(Bm),
         static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
         static_cast<float*>(state),   static_cast<float*>(dS),
         static_cast<bf16*>(s_in),     static_cast<float*>(seg),
         static_cast<float*>(cb),
         B, S, H, G, N, P, Q, (S + Q - 1) / Q,
         static_cast<cudaStream_t>(stream)};
  if (N <= 32) return launch_p<32>(k);
  if (N <= 64) return launch_p<64>(k);
  return launch_p<128>(k);
}

}  // extern "C"
