// seg = cumsum(dt * A) within each chunk of Q rows, for every (head,
// batch), into a (B, H, S) f32 buffer: what the head-tiled SSD kernels
// read in place of a per-chunk array in shared memory (whose size would
// grow with the chunk).  One warp a (head, batch); the running f32 sum in
// row order, the order of the scalar kernels' one-thread loop (and of
// jnp.cumsum): 32 rows' products are loaded at a time and broadcast lane
// by lane.  Included inside each SSD source's anonymous namespace, after
// <cuda_runtime.h> and <cstdint>.
#pragma once

constexpr int kSegThreads = 128;  // four (head, batch) pairs a block

__global__ void __launch_bounds__(kSegThreads)
ssd_seg_kernel(const float* __restrict__ dt, const float* __restrict__ A,
               float* __restrict__ seg, int B, int S, int H, int Q) {
  const int w = blockIdx.x * (kSegThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * H) return;  // the whole warp
  const int b = w / H, h = w % H;
  const float a = A[h];
  float* out = seg + static_cast<int64_t>(w) * S;
  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qe = min(Q, S - c0);
    float run = 0.f;
    for (int i0 = 0; i0 < qe; i0 += 32) {
      const int i = i0 + lane, n = min(32, qe - i0);
      const float prod =
          i < qe ? __fmul_rn(dt[(static_cast<int64_t>(b) * S + c0 + i) * H +
                                h],
                             a)
                 : 0.f;
      float mine = 0.f;
      for (int l = 0; l < n; ++l) {
        run = __fadd_rn(run, __shfl_sync(0xffffffffu, prod, l));
        if (lane == l) mine = run;
      }
      if (i < qe) out[c0 + i] = mine;
    }
  }
}

inline cudaError_t launch_seg(const float* dt, const float* A, float* seg,
                              int B, int S, int H, int Q,
                              cudaStream_t stream) {
  const int blocks = (B * H + kSegThreads / 32 - 1) / (kSegThreads / 32);
  ssd_seg_kernel<<<blocks, kSegThreads, 0, stream>>>(dt, A, seg, B, S, H, Q);
  return cudaGetLastError();
}
