// The backward pass of the Mamba-2 SSD scan on Hopper's tensor cores
// (mma.sync), chunk-parallel: the bf16 route of the SSD backward.  Given
// x, dt, A, B, C, each chunk's incoming state (as the tensor-core forward
// keeps it, a bf16 hi + lo pair), the output's gradient dy and the final
// state's gradient (optional), it computes dx, ddt, dA, and dB and dC per
// head (the caller sums them over a group's heads and dA over batch and
// chunks, from these per-block buffers).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// jax.value_and_grad differentiates the jnp ssd_chunked
// (repro/models/ssm.py).  The plain version is autograd of
// ../ref.py::ssd_scan_ref; ../ref.py::ssd_scan_bwd_chunked mirrors this
// decomposition in plain torch; ssd_scan_bwd.cu (scalar FMAs, one CTA
// walking the chunks of a head) computes the same function and keeps
// float32.  Per chunk of Q rows, head h of group g, with the forward's seg
// = cumsum(dt A), e_q = e^seg_q, L_qk = e^(seg_q - seg_k), d_k =
// e^(total - seg_k), the incoming state s and the outgoing state's
// gradient dS':
//   U     = (C * bf16(e))^T dy,  dS (into the previous chunk) = e^total dS' + U
//   G_qk  = dy_q . x_k,  w_qk = C_q.B_k L_qk dt_k,  dcb_qk = G_qk L_qk dt_k
//                                                    (q >= k, else 0)
//   dx_k  = bf16(w)^T dy + d_k dt_k B_k dS'
//   dB_k  = dcb^T C + d_k dt_k dS' x_k
//   dC_q  = dcb B + bf16(e_q) s dy_q
//   ddt_k = sum_q C_q.B_k L_qk G_qk + d_k B_k.(dS' x_k) + A da_k
//   dseg  = e C.(s dy) + rowsum(w G) - colsum(w G) - R,  R_k = d_k dt_k
//           B_k.(dS' x_k) (+ e^total s.dS' + sum_k R_k on the last row),
//   da    = reverse cumsum of dseg,  dA = sum over the chunk of da_k dt_k
// (bf16(.): the forward's rounding).
//
// Design: the forward's decomposition (ssd_scan_tc.cu) run backwards, six
// launches with many CTAs each instead of one CTA walking the chunks:
// 1. ssd_chunk_cb (mma_common.cuh), the forward's kernel: C B^T once per
//    group, one fmaf chain in the plain version's order, so that bf16(w)
//    here rounds as the forward's did;
// 2. ssd_bwd_chunk_state, one CTA per (chunk, head, batch): seg as the
//    forward makes it (one running f32 sum; written for the later
//    launches with dt), then the chunk's own state gradient U, an (N, P)
//    f32 tile on mma;
// 3. ssd_bwd_state_pass, one thread per 4 state elements of one (head,
//    batch): dS' of every chunk from the last, dS'_{c-1} = e^total_c dS'_c
//    + U_c, written as a bf16 hi + lo pair;
// 4. ssd_bwd_keys, one CTA per (64-row key tile, chunk, head, batch): the
//    state terms (B dS' and dS' x, both operands on mma, dS' as hi + lo),
//    then over the query tiles at or below the diagonal G^T = x dy^T on
//    mma, bf16(w)^T and dcb^T made in registers in the layout of the A
//    fragments of dx += bf16(w)^T dy and dB += dcb^T C (dcb as hi + lo),
//    and the column sums of w G and C.B L G per key row;
// 5. ssd_bwd_queries, one CTA per (64-row query tile, chunk, head,
//    batch): the state term s dy (s as hi + lo), then over the key tiles
//    G = dy x^T, dcb in the layout of dC += dcb B's A fragments, the row
//    sums of w G;
// 6. ssd_bwd_finish, one CTA per (chunk, head, batch): s.dS', then
//    d(seg) -> da by a block-wide reverse scan (warp shuffles), ddt and
//    the chunk's dA.
// Every sum is in a fixed order: no atomics, and two runs give the same
// bits.  Products run as mma.sync m16n8k16 (bf16 in, f32 accumulate) from
// ldmatrix'd shared-memory tiles, loaded by cp.async, double buffered; the
// f32 operands (dcb, dS', s) are split into bf16 hi + lo (about 16
// significant bits), and C * bf16(e) is exact as hi + lo.
//
// What bounds it on an H100: at mamba2-130m's training shape (B 4, S
// 4,096, H 24, P 64, N 128, G 1, Q 256) the work is 7.2e10 FLOPs (0.072
// ms at the bf16 tensor rate) and ~0.2 GB of inputs and outputs (0.06 ms):
// operations.  The launches add their scratch (U and dS', 50 MB each, C
// B^T, 17 MB) and recompute G in two kernels.  N and P are compiled as
// 32, 64 or 128 (zero padded above the true width, a multiple of 16).
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3, -Xptxas -v), called through ctypes.
#include <cstdint>

#include "mma_common.cuh"

namespace {

constexpr int kTileThreads = 128;  // ssd_bwd_keys, _queries: a warp a 16 rows
constexpr int kPassThreads = 256;
constexpr int kFinishThreads = 256;
constexpr int kLdCb = kT + 4;      // f32 a shared C B^T row is padded by

// ---- 2. chunk state gradients ---------------------------------------------

template <int kN, int kP>
size_t state_smem(int Q) {
  return sizeof(bf16) * 2 * kT * ((kN + kPad) + (kP + kPad))
         + sizeof(float) * 3 * static_cast<size_t>(tiled(Q));
}

// grid (nc, H, B).  seg_out (B, H, nc, 2, Q): the chunk's seg (rows past
// the ragged end at its total), then its dt (0 past the end); U (B, H, nc,
// N, P): (C * bf16(e^seg))^T dy of chunks 1 .. nc - 1 (chunk 0's would be
// the initial state's gradient: not made).
template <int kN, int kP>
__global__ void __launch_bounds__(kN * 2)
ssd_bwd_chunk_state(const bf16* __restrict__ dy, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Cm,
                    float* __restrict__ U, float* __restrict__ seg_out, int S,
                    int H, int G, int N, int P, int Q) {
  constexpr int kThreads = kN * 2;  // a warp per 16 rows of N
  constexpr int kLdC = kN + kPad, kLdY = kP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // 2 stages of kT x kLdC
  bf16* Ys = Cs + 2 * kT * kLdC;              // 2 stages of kT x kLdY
  float* seg_s = reinterpret_cast<float*>(Ys + 2 * kT * kLdY);  // tiled(Q)
  float* dt_s = seg_s + tiled(Q);             // dt (0 past qe)
  float* e_s = dt_s + tiled(Q);               // bf16(e^seg) (0 past qe)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * Q;
  const int qe = min(Q, S - c0);
  const int nt = (qe + kT - 1) / kT;
  const int64_t ldc = static_cast<int64_t>(G) * N;
  const int64_t ldy = static_cast<int64_t>(H) * P;
  const bf16* Cg = Cm + (static_cast<int64_t>(b) * S + c0) * ldc
                   + static_cast<int64_t>(g) * N;
  const bf16* Yg = dy + (static_cast<int64_t>(b) * S + c0) * ldy
                   + static_cast<int64_t>(h) * P;
  const float* dtg = dt + (static_cast<int64_t>(b) * S + c0) * H + h;

  if (c > 0) {
    load_tile<kN, kThreads>(Cs, Cg, ldc, qe, N);
    load_tile<kP, kThreads>(Ys, Yg, ldy, qe, P);
    cp_commit();
  }
  for (int i = tid; i < tiled(Q); i += kThreads)
    dt_s[i] = i < qe ? dtg[static_cast<int64_t>(i) * H] : 0.f;
  __syncthreads();
  if (tid == 0) {  // the forward's seg, bit for bit: one running f32 sum
    constexpr int kRun = 16;
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
  float* seg_g = seg_out + ((static_cast<int64_t>(b) * H + h) * nc + c) * 2
                               * Q;
  for (int i = tid; i < tiled(Q); i += kThreads) {
    const float sg = seg_s[i];
    if (i < Q) {
      seg_g[i] = sg;
      seg_g[Q + i] = dt_s[i];
    }
    e_s[i] = i < qe ? round_bf16(expf(sg)) : 0.f;
  }
  if (c == 0) return;
  __syncthreads();

  // U = (C * bf16(e))^T @ dy: this warp's 16 rows of N, all of P
  const int m0 = warp * 16, tig = lane & 3;
  float acc[kP / 8][4];
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {  // the next 64 rows into the other stage
      const int r0 = (kt + 1) * kT;
      load_tile<kN, kThreads>(Cs + ((kt + 1) & 1) * kT * kLdC,
                              Cg + r0 * ldc, ldc, qe - r0, N);
      load_tile<kP, kThreads>(Ys + ((kt + 1) & 1) * kT * kLdY,
                              Yg + r0 * ldy, ldy, qe - r0, P);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Ct = Cs + (kt & 1) * kT * kLdC;
    const bf16* Yt = Ys + (kt & 1) * kT * kLdY;
    const float* et = e_s + kt * kT;
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      // A (m = n, k = q) is C^T: C's tile [q][n] through ldmatrix.trans,
      // times bf16(e) a row (exact in f32), as hi + lo
      uint32_t araw[4], ahi[4], alo[4];
      ldsm_x4_t(araw, Ct + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdC
                          + m0 + ((lane >> 3) & 1) * 8);
      const int k = ks * 16 + 2 * tig;
      const float w0 = et[k], w1 = et[k + 1];
      const float w2 = et[k + 8], w3 = et[k + 9];
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
        uint32_t by[4];  // dy's tile [q][p]: two 8-column n-tiles
        ldsm_x4_t(by, Yt + (ks * 16 + (lane & 15)) * kLdY + j * 16
                          + (lane >> 4) * 8);
        mma(acc[2 * j], ahi, by[0], by[1]);
        mma(acc[2 * j], alo, by[0], by[1]);
        mma(acc[2 * j + 1], ahi, by[2], by[3]);
        mma(acc[2 * j + 1], alo, by[2], by[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  float* out = U + ((static_cast<int64_t>(b) * H + h) * nc + c) * N * P;
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

// ---- 3. the reverse state pass --------------------------------------------

// grid (ceil(N P / 4 / kPassThreads), B H).  U and seg as
// ssd_bwd_chunk_state leaves them; dfinal (B, H, N, P) or null; dSp (B,
// H, nc, 2, N, P) bf16: the gradient of each chunk's outgoing state split
// into hi, then lo.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass(const float* __restrict__ U, const float* __restrict__ seg,
                   const float* __restrict__ dfinal, bf16* __restrict__ dSp,
                   int S, int N, int P, int Q, int nc) {
  const int bh = blockIdx.y;
  const int i4 = blockIdx.x * kPassThreads + threadIdx.x;
  const int n4 = N * P / 4;
  if (i4 >= n4) return;
  const float4* u = reinterpret_cast<const float4*>(
                        U + static_cast<int64_t>(bh) * nc * N * P) + i4;
  uint2* out = reinterpret_cast<uint2*>(
                   dSp + static_cast<int64_t>(bh) * nc * 2 * N * P) + i4;
  const float* sg = seg + static_cast<int64_t>(bh) * nc * 2 * Q;
  float4 s = dfinal == nullptr
                 ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : reinterpret_cast<const float4*>(
                       dfinal + static_cast<int64_t>(bh) * N * P)[i4];
  float4 next = nc > 1 ? u[static_cast<int64_t>(nc - 1) * n4]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    uint2 hi, lo;
    split(s.x, s.y, hi.x, lo.x);
    split(s.z, s.w, hi.y, lo.y);
    out[static_cast<int64_t>(2 * c) * n4] = hi;
    out[static_cast<int64_t>(2 * c + 1) * n4] = lo;
    if (c == 0) break;
    const float4 us = next;
    if (c > 1) next = u[static_cast<int64_t>(c - 1) * n4];
    const int qe = min(Q, S - c * Q);
    const float e = expf(sg[static_cast<int64_t>(c) * 2 * Q + qe - 1]);
    s.x = __fadd_rn(__fmul_rn(s.x, e), us.x);
    s.y = __fadd_rn(__fmul_rn(s.y, e), us.y);
    s.z = __fadd_rn(__fmul_rn(s.z, e), us.z);
    s.w = __fadd_rn(__fmul_rn(s.w, e), us.w);
  }
}

// ---- 4, 5. the chunk gradients --------------------------------------------

// Shared memory of ssd_bwd_keys (ssd_bwd_queries alike, its roles
// swapped): the fixed tile (x_k; dy_q), then the state terms' operands
// (B_k and dS' hi, lo; C_q and s hi, lo) and, over them, two stages of the
// other side's tiles (C_q, dy_q and C B^T; B_k, x_k and C B^T), then seg
// and dt.
template <int kN, int kP>
__host__ __device__ constexpr size_t tile_fixed() {
  return sizeof(bf16) * kT * (kP + kPad);
}
template <int kN, int kP>
__host__ __device__ constexpr size_t tile_phase1() {
  return sizeof(bf16) * (kT * (kN + kPad) + 2 * kN * (kP + kPad));
}
template <int kN, int kP>
__host__ __device__ constexpr size_t tile_stage() {
  return sizeof(bf16) * kT * ((kN + kPad) + (kP + kPad))
         + sizeof(float) * kT * kLdCb;
}
template <int kN, int kP>
__host__ __device__ constexpr size_t tile_union() {
  return tile_phase1<kN, kP>() > 2 * tile_stage<kN, kP>()
             ? tile_phase1<kN, kP>()
             : 2 * tile_stage<kN, kP>();
}
template <int kN, int kP>
size_t tile_smem(int Q) {
  return tile_fixed<kN, kP>() + tile_union<kN, kP>()
         + sizeof(float) * 2 * static_cast<size_t>(tiled(Q));
}

// the chunk's geometry for a 1-d grid of (tile, chunk, head, batch)
struct Block {
  int t, c, h, b, g, c0, qe, nt, Qt;
  int64_t row0, bhc;
};
__device__ __forceinline__ Block block_of(int B, int H, int G, int S, int Q,
                                          int nc) {
  Block k;
  const int rest = nc * H * B;
  k.t = blockIdx.x / rest;
  const int r = blockIdx.x % rest;
  k.c = r % nc;
  k.h = (r / nc) % H;
  k.b = r / (nc * H);
  k.g = k.h / (H / G);
  k.c0 = k.c * Q;
  k.qe = min(Q, S - k.c0);
  k.nt = (k.qe + kT - 1) / kT;
  k.Qt = tiled(Q);
  k.row0 = static_cast<int64_t>(k.b) * S + k.c0;
  k.bhc = (static_cast<int64_t>(k.b) * H + k.h) * nc + k.c;
  return k;
}

// seg and dt of the chunk (tiled(Q) long; 0 past Q)
__device__ __forceinline__ void load_seg(float* seg_s, float* dt_s,
                                         const float* seg, int64_t bhc,
                                         int Q) {
  const float* sg = seg + bhc * 2 * Q;
  for (int i = threadIdx.x; i < tiled(Q); i += kTileThreads) {
    seg_s[i] = i < Q ? sg[i] : 0.f;
    dt_s[i] = i < Q ? sg[Q + i] : 0.f;
  }
}

// rows q0 .. q0 + 63, columns k0 .. k0 + 63 of the chunk's C B^T into a
// kT x kLdCb f32 tile
__device__ __forceinline__ void load_cb(float* dst, const float* cbg, int Qt,
                                        int q0, int k0) {
  for (int i = threadIdx.x; i < kT * (kT / 4); i += kTileThreads) {
    const int r = i / (kT / 4), ch = i % (kT / 4);
    cp_async16(dst + r * kLdCb + ch * 4,
               cbg + static_cast<int64_t>(q0 + r) * Qt + k0 + ch * 4, true);
  }
}

// the forward's intra-chunk weight w_qk and the products' shared factor
// L_qk dt_k (both 0 unless k <= q < qe): the forward's operations in its
// order, so that bf16(w) is the forward's
__device__ __forceinline__ void weight(float cbv, int q, int k, int qe,
                                       const float* seg_s, const float* dt_s,
                                       float& w, float& ldt, float& l) {
  const int qc = min(q, qe - 1), kc = min(k, qe - 1);
  l = expf(__fsub_rn(seg_s[qc], seg_s[kc]));
  const bool ok = k <= q && q < qe;
  w = ok ? __fmul_rn(__fmul_rn(cbv, l), dt_s[kc]) : 0.f;
  ldt = ok ? l * dt_s[kc] : 0.f;
  l = ok ? l : 0.f;
}

// half `half` of a k-slice's A fragment (n-tile 2 kk + half of an m16n8
// accumulator, its four values v) as bf16, or as bf16 hi + lo
__device__ __forceinline__ void frag_pack(uint32_t (&a)[4], int half,
                                          const float (&v)[4]) {
  a[2 * half] = pack(v[0], v[1]);
  a[2 * half + 1] = pack(v[2], v[3]);
}
__device__ __forceinline__ void frag_split(uint32_t (&hi)[4],
                                           uint32_t (&lo)[4], int half,
                                           const float (&v)[4]) {
  split(v[0], v[1], hi[2 * half], lo[2 * half]);
  split(v[2], v[3], hi[2 * half + 1], lo[2 * half + 1]);
}

// a sum over the 4 threads of a row's quad
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// part (B, H, nc, 4, tiled(Q)) f32, per chunk row: [0] -colsum(w G) - R
// and [1] colsum(C.B L G) + d B.(dS' x) and [2] R (ssd_bwd_keys), [3]
// rowsum(w G) + e C.(s dy) (ssd_bwd_queries)
constexpr int kParts = 4;

// grid (ceil(Q / kT) nc H B): key tile t of (chunk, head, batch).  dx
// (B,S,H,P) bf16 and dBh (B,S,H,N) f32 of the tile's rows, part [0..2].
template <int kN, int kP>
__global__ void __launch_bounds__(kTileThreads)
ssd_bwd_keys(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const float* __restrict__ cb, const float* __restrict__ seg,
             const bf16* __restrict__ dSp, bf16* __restrict__ dx,
             float* __restrict__ dBh, float* __restrict__ part, int B, int S,
             int H, int G, int N, int P, int Q, int nc) {
  constexpr int kLdN = kN + kPad, kLdP = kP + kPad;
  constexpr size_t kStage = tile_stage<kN, kP>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);          // kT x kLdP
  unsigned char* un = smem + tile_fixed<kN, kP>();
  bf16* Bs = reinterpret_cast<bf16*>(un);            // phase 1: kT x kLdN
  bf16* Dhi = Bs + kT * kLdN;                        // kN x kLdP
  bf16* Dlo = Dhi + kN * kLdP;                       // kN x kLdP
  // phase 2, stage s at un + s kStage: C_q, dy_q, C B^T
  const auto Cs = [&](int s) {
    return reinterpret_cast<bf16*>(un + s * kStage);
  };
  const auto Ys = [&](int s) { return Cs(s) + kT * kLdN; };
  const auto CBs = [&](int s) {
    return reinterpret_cast<float*>(Ys(s) + kT * kLdP);
  };
  float* seg_s = reinterpret_cast<float*>(un + tile_union<kN, kP>());
  float* dt_s = seg_s + tiled(Q);

  const Block k = block_of(B, H, G, S, Q, nc);
  if (k.t >= k.nt) return;
  const int k0 = k.t * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3, m0 = warp * 16;
  const int64_t ldb = static_cast<int64_t>(G) * N;
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const bf16* Bg = Bm + k.row0 * ldb + static_cast<int64_t>(k.g) * N;
  const bf16* Cg = Cm + k.row0 * ldb + static_cast<int64_t>(k.g) * N;
  const bf16* Xg = x + k.row0 * ldx + static_cast<int64_t>(k.h) * P;
  const bf16* Yg = dy + k.row0 * ldx + static_cast<int64_t>(k.h) * P;
  const float* cbg =
      cb + ((static_cast<int64_t>(k.b) * G + k.g) * nc + k.c) * k.Qt * k.Qt;
  const bf16* dsp = dSp + k.bhc * 2 * N * P;

  load_tile<kP, kTileThreads>(Xs, Xg + k0 * ldx, ldx, k.qe - k0, P);
  load_tile<kN, kTileThreads>(Bs, Bg + k0 * ldb, ldb, k.qe - k0, N);
  load_rows<kN, kP, kTileThreads>(Dhi, dsp, P, N, P);
  load_rows<kN, kP, kTileThreads>(Dlo, dsp + N * P, P, N, P);
  cp_commit();
  load_seg(seg_s, dt_s, seg, k.bhc, Q);
  cp_wait<0>();
  __syncthreads();
  const float total = seg_s[k.qe - 1];
  // this thread's two key rows (chunk rows)
  const int kr[2] = {k0 + m0 + gid, k0 + m0 + gid + 8};

  // the state terms: adx = B_k dS' (16 x P), adb = dS' x_k as rows (16 x N)
  float adx[kP / 8][4], adb[kN / 8][4];
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adx[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adb[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kN / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, Bs + (m0 + (lane & 15)) * kLdN + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kP / 16; ++j) {
      // dS' [n][p] as B (k = n): ldmatrix.trans
      uint32_t bh[4], bl[4];
      const int off = (ks * 16 + (lane & 15)) * kLdP + j * 16
                      + (lane >> 4) * 8;
      ldsm_x4_t(bh, Dhi + off);
      ldsm_x4_t(bl, Dlo + off);
      mma(adx[2 * j], a, bh[0], bh[1]);
      mma(adx[2 * j], a, bl[0], bl[1]);
      mma(adx[2 * j + 1], a, bh[2], bh[3]);
      mma(adx[2 * j + 1], a, bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int ks = 0; ks < kP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, Xs + (m0 + (lane & 15)) * kLdP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kN / 16; ++j) {
      // dS' [n][p] as B (k = p): ldmatrix
      uint32_t bh[4], bl[4];
      const int off = (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdP
                      + ks * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4(bh, Dhi + off);
      ldsm_x4(bl, Dlo + off);
      mma(adb[2 * j], a, bh[0], bh[1]);
      mma(adb[2 * j], a, bl[0], bl[1]);
      mma(adb[2 * j + 1], a, bh[2], bh[3]);
      mma(adb[2 * j + 1], a, bl[2], bl[3]);
    }
  }
  // B_k . (dS' x_k) a row; then both state terms times d_k dt_k
  float bu[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int n = j * 8 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t bb = *reinterpret_cast<const uint32_t*>(
          Bs + (m0 + gid + 8 * r) * kLdN + n);
      bu[r] = fmaf(lo_f(bb), adb[j][2 * r], bu[r]);
      bu[r] = fmaf(hi_f(bb), adb[j][2 * r + 1], bu[r]);
    }
  }
  float ddt[2], R[2], colm[2] = {0.f, 0.f}, colt[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bu[r] = quad_sum(bu[r]);
    const float d = kr[r] < k.qe ? expf(total - seg_s[kr[r]]) : 0.f;
    const float ddk = d * dt_s[kr[r]];
    ddt[r] = d * bu[r];
    R[r] = ddk * bu[r];
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      adx[j][2 * r] *= ddk;
      adx[j][2 * r + 1] *= ddk;
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      adb[j][2 * r] *= ddk;
      adb[j][2 * r + 1] *= ddk;
    }
  }
  __syncthreads();  // phase 1's operands are read: the stages go over them

  const auto load_stage = [&](int qt) {
    const int s = (qt - k.t) & 1, q0 = qt * kT;
    load_tile<kN, kTileThreads>(Cs(s), Cg + q0 * ldb, ldb, k.qe - q0, N);
    load_tile<kP, kTileThreads>(Ys(s), Yg + q0 * ldx, ldx, k.qe - q0, P);
    load_cb(CBs(s), cbg, k.Qt, q0, k0);
    cp_commit();
  };
  load_stage(k.t);
  for (int qt = k.t; qt < k.nt; ++qt) {
    if (qt + 1 < k.nt) {
      load_stage(qt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int s = (qt - k.t) & 1, q0 = qt * kT;
    const bf16* Ct = Cs(s);
    const bf16* Yt = Ys(s);
    const float* CBt = CBs(s);
    // G^T = x_k dy_q^T: this warp's 16 key rows x 64 query columns
    float gt[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Xs + (m0 + (lane & 15)) * kLdP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kT / 16; ++j) {
        uint32_t bb[4];  // dy_q [q][p] as B (k = p)
        ldsm_x4(bb, Yt + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdP
                        + ks * 16 + ((lane >> 3) & 1) * 8);
        mma(gt[2 * j], a, bb[0], bb[1]);
        mma(gt[2 * j + 1], a, bb[2], bb[3]);
      }
    }
    // a k-slice of 16 queries at a time: bf16(w)^T and dcb^T (hi + lo) in
    // its A fragments, the column sums of w G and C.B L G a key row, then
    // dx += bf16(w)^T dy_q and dB += dcb^T C_q
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t aw[4], ah[4], al[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jn = 2 * kk + half;
        float w[4], dc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, key = kr[r];
          const int q = q0 + jn * 8 + 2 * tig + (e & 1);
          const float cbv = CBt[(q - q0) * kLdCb + key - k0];
          float ldt, l;
          weight(cbv, q, key, k.qe, seg_s, dt_s, w[e], ldt, l);
          dc[e] = gt[jn][e] * ldt;
          colm[r] = fmaf(w[e], gt[jn][e], colm[r]);
          colt[r] = fmaf(cbv * l, gt[jn][e], colt[r]);
        }
        frag_pack(aw, half, w);
        frag_split(ah, al, half, dc);
      }
#pragma unroll
      for (int j = 0; j < kP / 16; ++j) {
        uint32_t bb[4];  // dy_q [q][p] as B (k = q): ldmatrix.trans
        ldsm_x4_t(bb, Yt + (kk * 16 + (lane & 15)) * kLdP + j * 16
                          + (lane >> 4) * 8);
        mma(adx[2 * j], aw, bb[0], bb[1]);
        mma(adx[2 * j + 1], aw, bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < kN / 16; ++j) {
        uint32_t bb[4];  // C_q [q][n] as B (k = q)
        ldsm_x4_t(bb, Ct + (kk * 16 + (lane & 15)) * kLdN + j * 16
                          + (lane >> 4) * 8);
        mma(adb[2 * j], ah, bb[0], bb[1]);
        mma(adb[2 * j], al, bb[0], bb[1]);
        mma(adb[2 * j + 1], ah, bb[2], bb[3]);
        mma(adb[2 * j + 1], al, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    colm[r] = quad_sum(colm[r]);
    colt[r] = quad_sum(colt[r]);
    const int q = kr[r];
    if (q >= k.qe) continue;
    const int64_t row = (k.row0 + q) * H + k.h;
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      const int col = j * 8 + 2 * tig;
      if (col < P)
        *reinterpret_cast<uint32_t*>(dx + row * P + col) =
            pack(adx[j][2 * r], adx[j][2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = j * 8 + 2 * tig;
      if (col < N)
        *reinterpret_cast<float2*>(dBh + row * N + col) =
            make_float2(adb[j][2 * r], adb[j][2 * r + 1]);
    }
    if (tig == 0) {
      float* pr = part + k.bhc * kParts * k.Qt + q;
      pr[0] = -colm[r] - R[r];
      pr[k.Qt] = colt[r] + ddt[r];
      pr[2 * k.Qt] = R[r];
    }
  }
}

// grid (ceil(Q / kT) nc H B): query tile ceil(Q / kT) - 1 - t (the
// heaviest first) of (chunk, head, batch).  s_in: the forward's incoming
// states (B, H, nc, 2, N, P) bf16 hi, lo.  dCh (B,S,H,N) f32 of the
// tile's rows, part [3].
template <int kN, int kP>
__global__ void __launch_bounds__(kTileThreads)
ssd_bwd_queries(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                const float* __restrict__ cb, const float* __restrict__ seg,
                const bf16* __restrict__ s_in, float* __restrict__ dCh,
                float* __restrict__ part, int B, int S, int H, int G, int N,
                int P, int Q, int nc) {
  constexpr int kLdN = kN + kPad, kLdP = kP + kPad;
  constexpr size_t kStage = tile_stage<kN, kP>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ys = reinterpret_cast<bf16*>(smem);          // kT x kLdP
  unsigned char* un = smem + tile_fixed<kN, kP>();
  bf16* Cs = reinterpret_cast<bf16*>(un);            // phase 1: kT x kLdN
  bf16* Shi = Cs + kT * kLdN;                        // kN x kLdP
  bf16* Slo = Shi + kN * kLdP;                       // kN x kLdP
  // phase 2, stage s at un + s kStage: B_k, x_k, C B^T
  const auto Bs = [&](int s) {
    return reinterpret_cast<bf16*>(un + s * kStage);
  };
  const auto Xs = [&](int s) { return Bs(s) + kT * kLdN; };
  const auto CBs = [&](int s) {
    return reinterpret_cast<float*>(Xs(s) + kT * kLdP);
  };
  float* seg_s = reinterpret_cast<float*>(un + tile_union<kN, kP>());
  float* dt_s = seg_s + tiled(Q);

  const Block k = block_of(B, H, G, S, Q, nc);
  const int qt = k.Qt / kT - 1 - k.t;
  if (qt >= k.nt) return;
  const int q0 = qt * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3, m0 = warp * 16;
  const int64_t ldb = static_cast<int64_t>(G) * N;
  const int64_t ldx = static_cast<int64_t>(H) * P;
  const bf16* Bg = Bm + k.row0 * ldb + static_cast<int64_t>(k.g) * N;
  const bf16* Cg = Cm + k.row0 * ldb + static_cast<int64_t>(k.g) * N;
  const bf16* Xg = x + k.row0 * ldx + static_cast<int64_t>(k.h) * P;
  const bf16* Yg = dy + k.row0 * ldx + static_cast<int64_t>(k.h) * P;
  const float* cbg =
      cb + ((static_cast<int64_t>(k.b) * G + k.g) * nc + k.c) * k.Qt * k.Qt;
  const bf16* sp = s_in + k.bhc * 2 * N * P;

  load_tile<kP, kTileThreads>(Ys, Yg + q0 * ldx, ldx, k.qe - q0, P);
  load_tile<kN, kTileThreads>(Cs, Cg + q0 * ldb, ldb, k.qe - q0, N);
  load_rows<kN, kP, kTileThreads>(Shi, sp, P, N, P);
  load_rows<kN, kP, kTileThreads>(Slo, sp + N * P, P, N, P);
  cp_commit();
  load_seg(seg_s, dt_s, seg, k.bhc, Q);
  cp_wait<0>();
  __syncthreads();
  const int qr[2] = {q0 + m0 + gid, q0 + m0 + gid + 8};

  // the state term: adc = dy_q s^T (16 x N), s [n][p] as B (k = p)
  float adc[kN / 8][4];
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, Ys + (m0 + (lane & 15)) * kLdP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kN / 16; ++j) {
      uint32_t bh[4], bl[4];
      const int off = (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdP
                      + ks * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4(bh, Shi + off);
      ldsm_x4(bl, Slo + off);
      mma(adc[2 * j], a, bh[0], bh[1]);
      mma(adc[2 * j], a, bl[0], bl[1]);
      mma(adc[2 * j + 1], a, bh[2], bh[3]);
      mma(adc[2 * j + 1], a, bl[2], bl[3]);
    }
  }
  // e_q C_q . (s dy_q) into d(seg); the state term times bf16(e_q)
  float rowm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cv = 0.f;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const uint32_t cc = *reinterpret_cast<const uint32_t*>(
          Cs + (m0 + gid + 8 * r) * kLdN + j * 8 + 2 * tig);
      cv = fmaf(lo_f(cc), adc[j][2 * r], cv);
      cv = fmaf(hi_f(cc), adc[j][2 * r + 1], cv);
    }
    const float e = qr[r] < k.qe ? expf(seg_s[qr[r]]) : 0.f;
    rowm[r] = e * quad_sum(cv);
    const float er = round_bf16(e);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      adc[j][2 * r] *= er;
      adc[j][2 * r + 1] *= er;
    }
  }
  float wg[2] = {0.f, 0.f};  // row sums of w G
  __syncthreads();  // phase 1's operands are read: the stages go over them

  const auto load_stage = [&](int kt) {
    const int s = kt & 1, k0 = kt * kT;
    load_tile<kN, kTileThreads>(Bs(s), Bg + k0 * ldb, ldb, k.qe - k0, N);
    load_tile<kP, kTileThreads>(Xs(s), Xg + k0 * ldx, ldx, k.qe - k0, P);
    load_cb(CBs(s), cbg, k.Qt, q0, k0);
    cp_commit();
  };
  load_stage(0);
  for (int kt = 0; kt <= qt; ++kt) {
    if (kt + 1 <= qt) {
      load_stage(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1, k0 = kt * kT;
    const bf16* Bt = Bs(s);
    const bf16* Xt = Xs(s);
    const float* CBt = CBs(s);
    // G = dy_q x_k^T: this warp's 16 query rows x 64 key columns
    float gm[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gm[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Ys + (m0 + (lane & 15)) * kLdP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kT / 16; ++j) {
        uint32_t bb[4];  // x_k [k][p] as B (k = p)
        ldsm_x4(bb, Xt + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdP
                        + ks * 16 + ((lane >> 3) & 1) * 8);
        mma(gm[2 * j], a, bb[0], bb[1]);
        mma(gm[2 * j + 1], a, bb[2], bb[3]);
      }
    }
    // a k-slice of 16 keys at a time: dcb (hi + lo) in its A fragments,
    // the row sums of w G, then dC += dcb B_k
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jn = 2 * kk + half;
        float dc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, q = qr[r];
          const int key = k0 + jn * 8 + 2 * tig + (e & 1);
          const float cbv = CBt[(q - q0) * kLdCb + key - k0];
          float w, ldt, l;
          weight(cbv, q, key, k.qe, seg_s, dt_s, w, ldt, l);
          dc[e] = gm[jn][e] * ldt;
          wg[r] = fmaf(w, gm[jn][e], wg[r]);
        }
        frag_split(ah, al, half, dc);
      }
#pragma unroll
      for (int j = 0; j < kN / 16; ++j) {
        uint32_t bb[4];  // B_k [k][n] as B (k = k): ldmatrix.trans
        ldsm_x4_t(bb, Bt + (kk * 16 + (lane & 15)) * kLdN + j * 16
                          + (lane >> 4) * 8);
        mma(adc[2 * j], ah, bb[0], bb[1]);
        mma(adc[2 * j], al, bb[0], bb[1]);
        mma(adc[2 * j + 1], ah, bb[2], bb[3]);
        mma(adc[2 * j + 1], al, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = quad_sum(wg[r]);
    const int q = qr[r];
    if (q >= k.qe) continue;
    const int64_t row = (k.row0 + q) * H + k.h;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = j * 8 + 2 * tig;
      if (col < N)
        *reinterpret_cast<float2*>(dCh + row * N + col) =
            make_float2(adc[j][2 * r], adc[j][2 * r + 1]);
    }
    if (tig == 0) part[(k.bhc * kParts + 3) * k.Qt + q] = rowm[r] + m;
  }
}

// ---- 6. d(seg) -> da, ddt, dA ---------------------------------------------

// a sum over the block in a fixed order (every thread gets it)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kFinishThreads / 32; ++w) t += red[w];
  return t;
}

// grid (nc, H, B).  s_in and dSp: each chunk's incoming state and its
// outgoing state's gradient (bf16 hi, lo); part as ssd_bwd_keys and
// ssd_bwd_queries leave it.  ddt (B,S,H) and dA_part (B, nc, H) f32.
__global__ void __launch_bounds__(kFinishThreads)
ssd_bwd_finish(const float* __restrict__ A, const float* __restrict__ seg,
               const bf16* __restrict__ s_in, const bf16* __restrict__ dSp,
               const float* __restrict__ part, float* __restrict__ ddt,
               float* __restrict__ dA_part, int S, int H, int N, int P, int Q) {
  __shared__ float red[kFinishThreads / 32];
  __shared__ float wsum[kFinishThreads / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * Q, qe = min(Q, S - c0), Qt = tiled(Q);
  const int64_t bhc = (static_cast<int64_t>(b) * H + h) * nc + c;
  const int NP = N * P;
  const float* sg = seg + bhc * 2 * Q;
  const float* pr = part + bhc * kParts * Qt;

  // s . dS' (each as hi + lo)
  const uint32_t* s2 = reinterpret_cast<const uint32_t*>(s_in + bhc * 2 * NP);
  const uint32_t* d2 = reinterpret_cast<const uint32_t*>(dSp + bhc * 2 * NP);
  float sd = 0.f;
  for (int i = tid; i < NP / 2; i += kFinishThreads) {
    const uint32_t sh = s2[i], sl = s2[NP / 2 + i];
    const uint32_t dh = d2[i], dl = d2[NP / 2 + i];
    sd = fmaf(lo_f(sh) + lo_f(sl), lo_f(dh) + lo_f(dl), sd);
    sd = fmaf(hi_f(sh) + hi_f(sl), hi_f(dh) + hi_f(dl), sd);
  }
  sd = block_sum(sd, red);

  // this thread's rows [i0, i1) of d(seg)
  constexpr int kMaxRows = 8;  // Q up to 2,048
  const int per = (qe + kFinishThreads - 1) / kFinishThreads;
  const int i0 = min(tid * per, qe), i1 = min(i0 + per, qe);
  float dseg[kMaxRows];
  float rsum = 0.f, own = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    const int i = i0 + j;
    dseg[j] = i < i1 ? pr[i] + pr[3 * Qt + i] : 0.f;
    rsum += i < i1 ? pr[2 * Qt + i] : 0.f;
  }
  rsum = block_sum(rsum, red);
  const float dtotal = fmaf(expf(sg[qe - 1]), sd, rsum);
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (i0 + j == qe - 1 && i0 + j < i1) dseg[j] += dtotal;
    own += dseg[j];
  }
  // the sum of the rows after this thread's: a reverse scan of the
  // threads' sums (within the warp by shuffles, then across warps)
  float suf = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, suf, off);
    if (lane + off < 32) suf += v;
  }
  __syncthreads();
  if (lane == 0) wsum[warp] = suf;
  __syncthreads();
  float after = suf - own;
  for (int w = warp + 1; w < kFinishThreads / 32; ++w) after += wsum[w];
  const float a = A[h];
  float run = after, dadt = 0.f;
#pragma unroll
  for (int j = kMaxRows - 1; j >= 0; --j) {
    const int i = i0 + j;
    if (i >= i1) continue;
    run += dseg[j];
    ddt[(static_cast<int64_t>(b) * S + c0 + i) * H + h] =
        fmaf(a, run, pr[Qt + i]);
    dadt = fmaf(run, sg[Q + i], dadt);
  }
  dadt = block_sum(dadt, red);
  if (tid == 0) dA_part[(static_cast<int64_t>(b) * nc + c) * H + h] = dadt;
}

// ---- launch ---------------------------------------------------------------

// the scratch, carved from one buffer: C B^T (B, G, nc, Qt, Qt) f32, seg
// (B, H, nc, 2, Q) f32, U (B, H, nc, N, P) f32, dS' (B, H, nc, 2, N, P)
// bf16, part (B, H, nc, 4, Qt) f32; each at a 256-byte boundary
struct Scratch {
  size_t cb, seg, u, dsp, part, bytes;
};
Scratch scratch_of(int B, int S, int H, int G, int N, int P, int Q) {
  const size_t nc = (S + Q - 1) / Q, Qt = tiled(Q);
  const auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  Scratch s;
  s.cb = 0;
  s.seg = s.cb + up(4 * B * G * nc * Qt * Qt);
  s.u = s.seg + up(4 * B * H * nc * 2 * Q);
  s.dsp = s.u + up(4 * B * H * nc * N * P);
  s.part = s.dsp + up(2 * B * H * nc * 2 * N * P);
  s.bytes = s.part + up(4 * B * H * nc * kParts * Qt);
  return s;
}

struct Call {
  const bf16 *x, *Bm, *Cm, *dy, *s_in;
  const float *dt, *A, *dfinal;
  unsigned char* scratch;
  bf16* dx;
  float *ddt, *dBh, *dCh, *dA_part;
  int B, S, H, G, N, P, Q, nc, parts;
  cudaStream_t stream;
};

template <int kN, int kP>
size_t smem_need(int Q) {
  const size_t a = state_smem<kN, kP>(Q), b = tile_smem<kN, kP>(Q);
  return a > b ? a : b;
}

template <int kN, int kP>
int launch(const Call& k) {
  const size_t s0 = cb_smem(k.N), s1 = state_smem<kN, kP>(k.Q);
  const size_t s2 = tile_smem<kN, kP>(k.Q);
  if (s1 > kMaxSmem || s2 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s0));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunk_state<kN, kP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s1));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_keys<kN, kP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_queries<kN, kP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Scratch sc = scratch_of(k.B, k.S, k.H, k.G, k.N, k.P, k.Q);
  float* cb = reinterpret_cast<float*>(k.scratch + sc.cb);
  float* seg = reinterpret_cast<float*>(k.scratch + sc.seg);
  float* U = reinterpret_cast<float*>(k.scratch + sc.u);
  bf16* dSp = reinterpret_cast<bf16*>(k.scratch + sc.dsp);
  float* part = reinterpret_cast<float*>(k.scratch + sc.part);
  const int qtiles = (k.Q + kT - 1) / kT;
  const int tiles = qtiles * k.nc * k.H * k.B;
  const auto check = [&]() { return cudaGetLastError(); };
  if (k.parts & 1) {
    ssd_chunk_cb<<<dim3(qtiles * qtiles, k.nc, k.B * k.G), kCbThreads, s0,
                   k.stream>>>(k.Bm, k.Cm, cb, k.S, k.G, k.N, k.Q);
    if ((e = check()) != cudaSuccess) return static_cast<int>(e);
  }
  if (k.parts & 2) {
    ssd_bwd_chunk_state<kN, kP><<<dim3(k.nc, k.H, k.B), kN * 2, s1,
                                  k.stream>>>(k.dy, k.dt, k.A, k.Cm, U, seg,
                                              k.S, k.H, k.G, k.N, k.P, k.Q);
    if ((e = check()) != cudaSuccess) return static_cast<int>(e);
  }
  if (k.parts & 4) {
    const int n4 = k.N * k.P / 4;
    ssd_bwd_state_pass<<<dim3((n4 + kPassThreads - 1) / kPassThreads,
                              k.B * k.H),
                         kPassThreads, 0, k.stream>>>(U, seg, k.dfinal, dSp,
                                                      k.S, k.N, k.P, k.Q,
                                                      k.nc);
    if ((e = check()) != cudaSuccess) return static_cast<int>(e);
  }
  if (k.parts & 8) {
    ssd_bwd_keys<kN, kP><<<tiles, kTileThreads, s2, k.stream>>>(
        k.x, k.Bm, k.Cm, k.dy, cb, seg, dSp, k.dx, k.dBh, part, k.B, k.S,
        k.H, k.G, k.N, k.P, k.Q, k.nc);
    if ((e = check()) != cudaSuccess) return static_cast<int>(e);
  }
  if (k.parts & 16) {
    ssd_bwd_queries<kN, kP><<<tiles, kTileThreads, s2, k.stream>>>(
        k.x, k.Bm, k.Cm, k.dy, cb, seg, k.s_in, k.dCh, part, k.B, k.S, k.H,
        k.G, k.N, k.P, k.Q, k.nc);
    if ((e = check()) != cudaSuccess) return static_cast<int>(e);
  }
  if (k.parts & 32)
    ssd_bwd_finish<<<dim3(k.nc, k.H, k.B), kFinishThreads, 0, k.stream>>>(
        k.A, seg, k.s_in, dSp, part, k.ddt, k.dA_part, k.S, k.H, k.N, k.P,
        k.Q);
  return static_cast<int>(check());
}

template <int kN>
int launch_p(const Call& k) {
  if (k.P <= 32) return launch<kN, 32>(k);
  if (k.P <= 64) return launch<kN, 64>(k);
  return launch<kN, 128>(k);
}

bool shape_ok(int N, int P, int Q) {
  return N > 0 && N <= 128 && N % 16 == 0 && P > 0 && P <= 128
         && P % 16 == 0 && Q >= 1 && Q <= 2048;
}

}  // namespace

extern "C" {

// The most shared memory a block of the backward takes for (N, P, Q), in
// bytes (-1 for shapes it does not take), and the card's limit.
int64_t ssd_scan_bwd_tc_smem_bytes(int N, int P, int Q) {
  if (!shape_ok(N, P, Q)) return -1;
  const int kn = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int kp = P <= 32 ? 32 : P <= 64 ? 64 : 128;
  size_t need = 0;
#define SSD_BWD_TC_CASE(a, b) \
  if (kn == a && kp == b) need = smem_need<a, b>(Q);
  SSD_BWD_TC_CASE(32, 32) SSD_BWD_TC_CASE(32, 64) SSD_BWD_TC_CASE(32, 128)
  SSD_BWD_TC_CASE(64, 32) SSD_BWD_TC_CASE(64, 64) SSD_BWD_TC_CASE(64, 128)
  SSD_BWD_TC_CASE(128, 32) SSD_BWD_TC_CASE(128, 64) SSD_BWD_TC_CASE(128, 128)
#undef SSD_BWD_TC_CASE
  return static_cast<int64_t>(need);
}

int64_t ssd_scan_bwd_tc_smem_limit() { return kMaxSmem; }

// Bytes of the scratch a launch needs.
int64_t ssd_scan_bwd_tc_scratch_bytes(int B, int S, int H, int G, int N,
                                      int P, int Q) {
  return static_cast<int64_t>(scratch_of(B, S, H, G, N, P, Q).bytes);
}

// bfloat16 x, B, C, dy, dx and the incoming states; float32 dt, A, dfinal
// and the other outputs.  Contiguous x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
// (B,S,G,N), dy (B,S,H,P), the tensor-core forward's chunk-start states
// s_in (B,H,nc,2,N,P) hi and lo, dfinal (B,H,N,P) or null, the scratch
// (ssd_scan_bwd_tc_scratch_bytes, 256-byte aligned), and the outputs dx
// (B,S,H,P), ddt (B,S,H), dBh/dCh (B,S,H,N) per head and dA_part
// (B,nc,H); x, Bm, Cm, dy and s_in 16-byte aligned; N and P multiples of
// 16 up to 128; Q the chunk (<= S, at most 2,048); nc = ceil(S / Q).
// parts: a mask of the six launches (1 C B^T, 2 chunk states, 4 state
// pass, 8 keys, 16 queries, 32 finish; 63 all), made in that order on
// `stream`.  Returns the first CUDA error code (0 on success).
int ssd_scan_bwd_tc_launch(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* dy,
                           const void* s_in, const void* dfinal,
                           void* scratch, void* dx, void* ddt, void* dBh,
                           void* dCh, void* dA_part, int B, int S, int H,
                           int G, int N, int P, int Q, int parts,
                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q > S
      || !shape_ok(N, P, Q) || parts < 1 || parts > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  Call k{static_cast<const bf16*>(x),    static_cast<const bf16*>(Bm),
         static_cast<const bf16*>(Cm),   static_cast<const bf16*>(dy),
         static_cast<const bf16*>(s_in), static_cast<const float*>(dt),
         static_cast<const float*>(A),   static_cast<const float*>(dfinal),
         static_cast<unsigned char*>(scratch), static_cast<bf16*>(dx),
         static_cast<float*>(ddt),       static_cast<float*>(dBh),
         static_cast<float*>(dCh),       static_cast<float*>(dA_part),
         B, S, H, G, N, P, Q, (S + Q - 1) / Q, parts,
         static_cast<cudaStream_t>(stream)};
  if (N <= 32) return launch_p<32>(k);
  if (N <= 64) return launch_p<64>(k);
  return launch_p<128>(k);
}

}  // extern "C"
