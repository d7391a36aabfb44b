// Blockwise (flash) attention for Hopper tensor cores, bf16 in and out, f32
// online softmax, GQA and sliding window: o[b, s, h, :] = softmax(q k^T *
// Dk^-0.5, masked) v, where query head h reads KV head h / (H / KV) in place.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (_flash_kernel, launched by flash_attention) for bf16
// calls whose Dk and Dv are multiples of 16 up to 256; flash_attention.cu
// (scalar FMAs) keeps float32 and the other widths.  Same function: f32
// scores, masked scores set to -1e30 and p zeroed where masked, running max /
// sum / output in f32, output divided by max(l, 1e-30).  Same visited KV
// tiles: causal attention stops at the tile holding the query tile's last
// row, a window starts at the tile holding its first row's first key.  Two
// departures, both rounding only:
//   * the scores are scaled in f32 after the product (the Pallas kernel
//     scales q before it), and the softmax runs in base 2 (the scale times
//     log2 e folded into the exponent's FMA);
//   * p is rounded to bf16 as the A operand of the P V product (the Pallas
//     kernel keeps p in f32; l sums the f32 p): a relative error of at most
//     2^-9 on each weight.  Measured on an H100, the outputs stay within
//     0.52 of the 1e-2 bf16 tolerance (2 ulps of an output in [2, 4)).
//
// What bounds it on an H100: at llama3-8b's prefill shape (B 4, S 1024,
// H 32, KV 8, Dk = Dv = 128, causal) the work is 3.44e10 FLOPs and 83.9 MB of
// traffic: the bf16 tensor cores (989 TFLOP/s) bound it at 0.035 ms.  So
// both products run on the tensor cores (wgmma), every operand reaches
// shared memory by TMA, and the exp2s of the softmax (16 a clock per SM,
// half the tensor cores' time per tile) run beside the products:
//   * a persistent grid, one CTA of 384 threads per SM, takes the query
//     tiles of 128 rows of one (batch, head) in waves of one tile a CTA,
//     causal tiles heaviest first and every other wave in reverse order (so
//     the CTAs' loads even out); two consumer warpgroups own 64 rows each
//     and one producer thread issues every load;
//   * the producer streams Q (once a tile, as soon as the previous tile's
//     last S is computed) and K and V tiles of kBK rows through a ring of
//     stages by TMA with mbarrier completion, across tiles; K and V of a
//     stage are released apart (K once S is computed, V once P V is).  A 4-d
//     tensor map (D, heads, S, B) reads a head's rows in place in 128-byte
//     swizzled boxes 64 columns wide (a wider head loads as several boxes)
//     and zero-fills rows past S and columns past D;
//   * S = Q K^T is wgmma m64nBKk16 with both operands in shared memory
//     (K-major, as TMA leaves them); the online softmax stays in registers
//     (row max across the 4 threads of a row's quad by shuffles, maxima and
//     sums in 4 independent chains, the row sum reduced across the quad once
//     at the end), and only KV tiles that cross the diagonal, the window's
//     edge or S compute the mask (a separate instance of the loop);
//   * O += P V is wgmma m64nDvk16 with P from registers (the accumulator's
//     layout is the A operand's) and V read MN-major through the
//     descriptor's transpose bit, so V is never transposed in memory;
//   * each warpgroup pipelines its KV tiles: S of tile i is issued with
//     P V of tile i - 1, and the softmax of tile i runs while that P V is
//     on the tensor cores; the two warpgroups take turns to issue (named
//     barriers), so one's products run while the other computes its softmax;
//   * o / l goes to its own shared-memory tile in the TMA box layout and
//     leaves by TMA store, which clips rows past S and columns past Dv, while
//     the next tile starts.
// Widths: Dk and Dv are padded to multiples of 64 (the TMA box), at most
// 256.  The Q and O tiles and the stages share 227 KB: kBK is 128 where Dv
// <= 128 (registers: the 64 x Dv output accumulator takes Dv / 2 a thread,
// the 64 x kBK scores kBK / 2, of the consumers' 240) and two stages fit,
// else 64, else 32 (Dk = Dv = 256); three stages where they fit, else two
// (llama3-8b's 128 / 128: kBK 128, two stages).
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3), called through ctypes.  The tensor maps
// are encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library does not link libcuda.
// tools/flash_sm90_ablation.py alone defines FLASH_SM90_SKIP_{QK, PV,
// SOFTMAX, STORE, PINGPONG}, to time the kernel with one part left out.
#include <cstdint>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;              // query rows per CTA
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxStages = 3;         // K/V ring depth, where it fits
constexpr int kMaxSmem = 232448;      // 227 KB per block on sm_90
constexpr int kSlack = 2048;          // barriers + 1024-byte alignment
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int smem_bytes(int dk, int dv, int bk,
                                             int stages) {
  return 2 * (dk + dv) * (kBQ + stages * bk) + kSlack;
}

// KV rows per tile for padded widths (dk, dv): 128 where the output
// accumulator's registers and two stages fit, else 64, else 32.
__host__ __device__ constexpr int pick_bk(int dk, int dv) {
  return (dv <= 128 && smem_bytes(dk, dv, 128, 2) <= kMaxSmem) ? 128
         : smem_bytes(dk, dv, 64, 2) <= kMaxSmem                 ? 64
                                                                 : 32;
}

// K/V ring depth: three stages where they fit, else two.
__host__ __device__ constexpr int pick_stages(int dk, int dv, int bk) {
  return smem_bytes(dk, dv, bk, kMaxStages) <= kMaxSmem ? kMaxStages : 2;
}

// kDK, kDV: Dk and Dv padded to multiples of 64 (at most 256).
template <int kDK, int kDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_o,
                  float* __restrict__ lse, int B, int S, int H, int KV,
                  int causal, int window, float scale_log2) {
  constexpr int kBK = pick_bk(kDK, kDV);
  constexpr int kStages = pick_stages(kDK, kDV, kBK);
  constexpr uint32_t kQBytes = 2 * kBQ * kDK;
  constexpr uint32_t kOBytes = 2 * kBQ * kDV;
  constexpr uint32_t kKBytes = 2 * kBK * kDK;
  constexpr uint32_t kVBytes = 2 * kBK * kDV;
  extern __shared__ uint8_t smem[];
  // barriers first, then the tiles at the next 1024-byte boundary (the
  // 128-byte swizzle repeats every 8 rows of 128 bytes): Q, O, then the
  // K/V stages (stage s: K at s_kv + s (K + V), V after it)
  const uint32_t bars = smem_u32(smem);
  const uint32_t full_q = bars, empty_q = bars + 8;
  const uint32_t full_k = bars + 16;                     // + 8 s
  const uint32_t full_v = full_k + 8 * kStages;          // + 8 s
  const uint32_t empty_k = full_k + 16 * kStages;        // + 8 s
  const uint32_t empty_v = full_k + 24 * kStages;        // + 8 s
  const uint32_t s_q = (full_k + 32 * kStages + 1023) & ~1023u;
  const uint32_t s_o = s_q + kQBytes;
  const uint32_t s_kv = s_o + kOBytes;

  const int nq = (S + kBQ - 1) / kBQ, nk = (S + kBK - 1) / kBK;
  const int n_tiles = nq * B * H;
  // query tile t: the heaviest causal tiles first (so the last ones are
  // light), the heads of one KV group side by side; it visits the KV tiles
  // lo .. lo + n - 1 (causal: up to its last row's tile; a window: from its
  // first row's first key's tile)
  struct Tile {
    int q0, h, b, lo, n;
  };
  const auto tile = [&](int t) {
    Tile x;
    const int bh = t % (B * H);
    x.q0 = (nq - 1 - t / (B * H)) * kBQ;
    x.h = bh % H;
    x.b = bh / H;
    const int hi = causal ? min((x.q0 + kBQ - 1) / kBK + 1, nk) : nk;
    x.lo = window > 0 ? max(x.q0 - window + 1, 0) / kBK : 0;
    x.n = hi - x.lo;
    return x;
  };
  // the k-th query tile of this CTA: tiles go out in waves of gridDim.x,
  // every other wave in reverse, so heavy and light causal tiles pair up
  const auto tile_index = [&](int k) {
    const int c = static_cast<int>(blockIdx.x);
    const int g = static_cast<int>(gridDim.x);
    return k * g + (k % 2 ? g - 1 - c : c);
  };
  // the warp index, broadcast so the compiler sees it warp-uniform (the
  // roles and the consumers' loop bounds derive from it; wgmma must not sit
  // on a path it thinks divergent)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * kConsumers);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 4 * kConsumers);
      mbar_init(empty_v + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer warpgroup: one thread issues every load.  Q of the next tile
    // loads as soon as the last S of this one is computed; K and V of a
    // stage are released apart (K once S is computed, V once P V is), and
    // the ring runs on across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == 4 * kConsumers && lane == 0) {
      int it = 0;  // K/V tiles loaded so far
      for (int k = 0, t = tile_index(0); t < n_tiles; t = tile_index(++k)) {
        const Tile x = tile(t);
        const int g = x.h / (H / KV);
        if (k > 0) mbar_wait(empty_q, (k - 1) & 1);
        mbar_expect_tx(full_q, kQBytes);
#pragma unroll
        for (int c = 0; c < kDK / kBox; ++c)
          tma_load(s_q + c * kBQ * 128, &tm_q, full_q, c * kBox, x.h, x.q0,
                   x.b);
        for (int i = 0; i < x.n; ++i, ++it) {
          const int s = it % kStages, par = (it / kStages - 1) & 1;
          const uint32_t s_k = s_kv + s * (kKBytes + kVBytes);
          const uint32_t s_v = s_k + kKBytes;
          const int k0 = (x.lo + i) * kBK;
          if (it >= kStages) mbar_wait(empty_k + 8 * s, par);
          mbar_expect_tx(full_k + 8 * s, kKBytes);
#pragma unroll
          for (int c = 0; c < kDK / kBox; ++c)
            tma_load(s_k + c * kBK * 128, &tm_k, full_k + 8 * s, c * kBox, g,
                     k0, x.b);
          if (it >= kStages) mbar_wait(empty_v + 8 * s, par);
          mbar_expect_tx(full_v + 8 * s, kVBytes);
#pragma unroll
          for (int c = 0; c < kDV / kBox; ++c)
            tma_load(s_v + c * kBK * 128, &tm_v, full_v + 8 * s, c * kBox, g,
                     k0, x.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = warp / 4;
    // this thread's two rows of the accumulators (wgmma's D layout: warp w
    // of the warpgroup holds rows 16 w .. 16 w + 15; register 4 j + e holds
    // row lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2)
    const int rr = 16 * (warp % 4) + lane / 4;  // row within the warpgroup
    const int col = 2 * (lane % 4);
    const uint32_t a_q = s_q + 64 * wg * 128;
    const uint32_t o_box = s_o + 64 * wg * 128;
    // K/V tile i counts the tiles consumed since the kernel began
    const auto stage = [&](int i) { return i % kStages; };
    const auto parity = [&](int i) { return (i / kStages) & 1; };
    const auto k_tile = [&](int i) {
      return s_kv + stage(i) * (kKBytes + kVBytes);
    };
    const auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q K_i^T into sacc (issued, not awaited)
    float sacc[kBK / 2];
    const auto issue_qk = [&](int i) {
      mbar_wait(full_k + 8 * stage(i), parity(i));
      const uint32_t s_k = k_tile(i);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kDK / 16; ++kk) {
        // k-slice kk: box kk / 4, 32 bytes per slice along the swizzled
        // 128-byte rows; 8-row groups 1024 bytes apart (SBO)
        const uint32_t off = (kk % 4) * 32;
#ifndef FLASH_SM90_SKIP_QK
        wgmma_ss(sacc, desc_sw128(a_q + (kk / 4) * kBQ * 128 + off, 16, 1024),
                 desc_sw128(s_k + (kk / 4) * kBK * 128 + off, 16, 1024),
                 kk > 0);
#endif
      }
      wg_commit();
    };
    // O += P V_i (issued, not awaited)
    float oacc[kDV / 2];
    uint32_t pa[kBK / 16][4];
    const auto issue_pv = [&](int i) {
      mbar_wait(full_v + 8 * stage(i), parity(i));
      const uint32_t s_v = k_tile(i) + kKBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // V tile: kBK rows of 128-byte boxes, box c at c * kBK * 128 (LBO:
        // the next 64 columns), 8-row groups 1024 bytes apart (SBO)
#ifndef FLASH_SM90_SKIP_PV
        wgmma_rs(oacc, pa[kk], desc_sw128(s_v + kk * 16 * 128, kBK * 128, 1024));
#endif
      wg_commit();
    };
    // the two warpgroups take turns to issue their products (ping-pong):
    // one's products run on the tensor cores while the other computes its
    // softmax.  Turn barriers 1 + wg, 256 threads: the waiting warpgroup's
    // 128 and the other's 128 arrivals.
#ifdef FLASH_SM90_SKIP_PINGPONG
    const auto turn_begin = [&]() {};
    const auto turn_end = [&](bool last) {};
#else
    const auto turn_begin = [&]() { bar_sync(1 + wg, 256); };
    const auto turn_end = [&](bool last) {
      // (warpgroup 1's last turn opens no further turn of warpgroup 0)
      if (!(last && wg == 1)) bar_arrive(1 + (wg + 1) % 2, 256);
    };
    if (wg == 1) bar_arrive(1, 256);  // warpgroup 0 goes first
#endif

    int it = 0;  // K/V tiles consumed so far
    for (int k = 0, t = tile_index(0); t < n_tiles; t = tile_index(++k)) {
      const Tile x = tile(t);
      const bool last_tile = tile_index(k + 1) >= n_tiles;
      const int r_lo = x.q0 + 64 * wg;  // the warpgroup's first row
      const int row = r_lo + rr;

      // online softmax of the tile's KV tile i (base 2, scale folded into
      // the exponent): m, l and p in sacc; returns the rescale of o's two
      // rows.  Maxima and sums run as 4 independent chains a row (register
      // 4 c + e goes to chain c % 4), joined at the end.
      float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
      const auto softmax = [&](int i, float& c0, float& c1) {
#ifdef FLASH_SM90_SKIP_SOFTMAX
        c0 = c1 = 1.f; return;
#endif
        const int k0 = (x.lo + i) * kBK;
        const auto visible = [&](int j) {
          const int r = row + 8 * ((j / 2) % 2);
          const int key = k0 + 8 * (j / 4) + col + j % 2;
          return key < S && (!causal || key <= r) &&
                 (window <= 0 || r - key < window);
        };
        const auto run = [&](auto masked) {
          float mx[2][4], ps[2][4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            mx[0][a] = mx[1][a] = kNeg;
            ps[0][a] = ps[1][a] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < kBK / 2; ++j) {
            if (decltype(masked)::value && !visible(j)) sacc[j] = kNeg;
            mx[(j / 2) % 2][(j / 4) % 4] =
                fmaxf(mx[(j / 2) % 2][(j / 4) % 4], sacc[j]);
          }
          float mr0 =
              fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
          float mr1 =
              fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
          mr0 = fmaxf(mr0, __shfl_xor_sync(0xffffffffu, mr0, 1));
          mr1 = fmaxf(mr1, __shfl_xor_sync(0xffffffffu, mr1, 1));
          mr0 = fmaxf(mr0, __shfl_xor_sync(0xffffffffu, mr0, 2));
          mr1 = fmaxf(mr1, __shfl_xor_sync(0xffffffffu, mr1, 2));
          const float n0 = fmaxf(m0, mr0 * scale_log2);
          const float n1 = fmaxf(m1, mr1 * scale_log2);
          c0 = ex2(m0 - n0);
          c1 = ex2(m1 - n1);
          m0 = n0;
          m1 = n1;
#pragma unroll
          for (int j = 0; j < kBK / 2; ++j) {
            const int r = (j / 2) % 2;
            float p = ex2(fmaf(sacc[j], scale_log2, -(r ? n1 : n0)));
            if (decltype(masked)::value && !visible(j)) p = 0.f;
            sacc[j] = p;
            ps[r][(j / 4) % 4] += p;
          }
          l0 = l0 * c0 + ((ps[0][0] + ps[0][1]) + (ps[0][2] + ps[0][3]));
          l1 = l1 * c1 + ((ps[1][0] + ps[1][1]) + (ps[1][2] + ps[1][3]));
        };
        // only KV tiles crossing the diagonal, the window's edge or S mask
        if (k0 + kBK > S || (causal && k0 + kBK - 1 > r_lo) ||
            (window > 0 && r_lo + 63 - k0 >= window))
          run(std::true_type());
        else
          run(std::false_type());
      };
      // o's rows times (c0, c1); P as the A operand: k-slice kk (keys
      // 16 kk .. 16 kk + 15) is accumulator registers 8 kk .. 8 kk + 7,
      // already in A's layout
      const auto rescale_pack = [&](float c0, float c1) {
#pragma unroll
        for (int j = 0; j < kDV / 2; ++j) oacc[j] *= ((j / 2) % 2) ? c1 : c0;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            pa[kk][u] =
                pack_bf16(sacc[8 * kk + 2 * u], sacc[8 * kk + 2 * u + 1]);
      };

#pragma unroll
      for (int j = 0; j < kDV / 2; ++j) oacc[j] = 0.f;
      mbar_wait(full_q, k & 1);
      // software pipeline over the tile's n KV tiles: S of tile i is issued
      // with P V of tile i - 1, and the softmax of tile i runs beside that
      // P V.  Both warpgroups visit every KV tile: one wholly masked for a
      // warpgroup's rows leaves its m, l and o as they are.  Q is released
      // once the last S is computed.
      float c0, c1;
      fence_regs(sacc);
      turn_begin();
      issue_qk(it);
      turn_end(false);
      wg_wait<0>();
      fence_regs(sacc);
      arrive(empty_k + 8 * stage(it));
      if (x.n == 1) arrive(empty_q);
      softmax(0, c0, c1);
      rescale_pack(c0, c1);
      for (int i = 1; i < x.n; ++i) {
        fence_regs(sacc);
        fence_regs(oacc);
        turn_begin();
        issue_qk(it + i);
        issue_pv(it + i - 1);
        turn_end(false);
        wg_wait<1>();  // S of KV tile i
        fence_regs(sacc);
        arrive(empty_k + 8 * stage(it + i));
        if (i == x.n - 1) arrive(empty_q);
        softmax(i, c0, c1);
        wg_wait<0>();  // P V of KV tile i - 1
        fence_regs(oacc);
        fence_regs(pa);
        arrive(empty_v + 8 * stage(it + i - 1));
        rescale_pack(c0, c1);
      }
      fence_regs(oacc);
      turn_begin();
      issue_pv(it + x.n - 1);
      turn_end(last_tile);
      wg_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      arrive(empty_v + 8 * stage(it + x.n - 1));
      it += x.n;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      // each row's log-sum-exp of the scaled scores (m and l are base 2),
      // for the backward pass: one thread of the row's quad writes it
      if (lse != nullptr && lane % 4 == 0) {
        float* lrow = lse + (static_cast<int64_t>(x.b) * H + x.h) * S;
        if (row < S) lrow[row] = (m0 + log2f(l0)) * 0.6931471805599453f;
        if (row + 8 < S)
          lrow[row + 8] = (m1 + log2f(l1)) * 0.6931471805599453f;
      }
      // o / l in bf16 into this warpgroup's 64 rows of the O tile, in the
      // 128-byte-swizzled box layout TMA reads, once the previous tile's
      // store has read them; then one thread stores the boxes, TMA clipping
      // rows past S and columns past Dv
      if (threadIdx.x % 128 == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      bar_sync(3 + wg, 128);
#pragma unroll
      for (int j = 0; j < kDV / 2; j += 2) {
        const int r = rr + 8 * ((j / 2) % 2), chunk = (j / 4) % 8;
        const float inv = (j / 2) % 2 ? inv1 : inv0;
        st_shared(o_box + (j / 32) * kBQ * 128 + r * 128 +
                      ((chunk ^ (r % 8)) * 16) + 4 * (lane % 4),
                  pack_bf16(oacc[j] * inv, oacc[j + 1] * inv));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(3 + wg, 128);
#ifndef FLASH_SM90_SKIP_STORE
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int c = 0; c < kDV / kBox; ++c)
          tma_store(&tm_o, o_box + c * kBQ * 128, c * kBox, x.h, r_lo, x.b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
#endif
    }
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}


template <int kDK, int kDV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int Dk, int Dv, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int kBK = pick_bk(kDK, kDV);
  constexpr int kSmem =
      smem_bytes(kDK, kDV, kBK, pick_stages(kDK, kDV, kBK));
  static_assert(kSmem <= kMaxSmem, "tiles exceed shared memory");
  alignas(64) CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, B, S, H, Dk, kBQ) ||
      !make_map(&tk, k, B, S, KV, Dk, kBK) ||
      !make_map(&tv, v, B, S, KV, Dv, kBK) ||
      !make_map(&to, o, B, S, H, Dv, kBQ / kConsumers))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_sm90_kernel<kDK, kDV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kBQ - 1) / kBQ * B * H;
  flash_sm90_kernel<kDK, kDV><<<tiles < sms ? tiles : sms, kThreads, kSmem,
                                stream>>>(
      tq, tk, tv, to, lse, B, S, H, KV, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int kDK>
int launch_dv(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int KV, int Dk, int Dv,
              int causal, int window, float scale, cudaStream_t st) {
  switch ((Dv + kBox - 1) / kBox) {
    case 1: return launch<kDK, 64>(q, k, v, o, lse, B, S, H, KV, Dk, Dv,
                                   causal, window, scale, st);
    case 2: return launch<kDK, 128>(q, k, v, o, lse, B, S, H, KV, Dk, Dv,
                                    causal, window, scale, st);
    case 3: return launch<kDK, 192>(q, k, v, o, lse, B, S, H, KV, Dk, Dv,
                                    causal, window, scale, st);
    default: return launch<kDK, 256>(q, k, v, o, lse, B, S, H, KV, Dk, Dv,
                                     causal, window, scale, st);
  }
}

}  // namespace

// scale: Dk^-0.5 as the caller rounds it to float.  q, k, v, o: contiguous
// bf16 (B,S,H,Dk), (B,S,KV,Dk), (B,S,KV,Dv), (B,S,H,Dv), 16-byte aligned;
// Dk and Dv multiples of 16 in [16, 256].  Launches on `stream` and returns
// the CUDA error code (0 on success; cudaErrorInvalidValue for arguments the
// kernel does not take or a tensor map the driver refuses).  lse: null, or
// a float32 (B,H,S) that gets each row's log-sum-exp of its scaled, masked
// scores, which the backward pass reads.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int H, int KV, int Dk,
                                           int Dv, int causal, int window,
                                           float scale, void* lse,
                                           void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Dk <= 0 ||
      Dv <= 0 || Dk % 16 != 0 || Dv % 16 != 0 || Dk > 256 || Dv > 256 ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Dk + kBox - 1) / kBox) {
    case 1: return launch_dv<64>(q, k, v, o, static_cast<float*>(lse), B, S,
                                 H, KV, Dk, Dv, causal, window, scale, st);
    case 2: return launch_dv<128>(q, k, v, o, static_cast<float*>(lse), B, S,
                                  H, KV, Dk, Dv, causal, window, scale, st);
    case 3: return launch_dv<192>(q, k, v, o, static_cast<float*>(lse), B, S,
                                  H, KV, Dk, Dv, causal, window, scale, st);
    default: return launch_dv<256>(q, k, v, o, static_cast<float*>(lse), B, S,
                                   H, KV, Dk, Dv, causal, window, scale, st);
  }
}
