// What the step kernels' shared-memory routes share (cycle_step.cu,
// simt_step.cu): the bulk copies that bring a DPU's WRAM and atomics row
// into shared memory at a launch's start and take them back at its end,
// the power-of-two forms of torch's floor division and remainder, and the
// per-section clock counters of a profiling build.
#pragma once

#include <cstdint>

namespace step_common {

// ---- floor division and remainder (torch's rounding) ----

// torch.div(x, d, rounding_mode="floor") for d > 0
__device__ __forceinline__ int floordiv(int x, int d) {
  int q = x / d;
  if (x % d != 0 && x < 0) --q;
  return q;
}
// torch.remainder(x, n) for n > 0
__device__ __forceinline__ int remainder(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}
// log2(d) when d > 0 is a power of two, else -1 (once a launch)
__device__ __forceinline__ int pow2_shift(int d) {
  return d > 0 && (d & (d - 1)) == 0 ? __ffs(d) - 1 : -1;
}
// floordiv(x, d) with sh = pow2_shift(d): an arithmetic shift rounds
// towards minus infinity, as floor division does
__device__ __forceinline__ int floordiv_p2(int x, int d, int sh) {
  return sh >= 0 ? x >> sh : floordiv(x, d);
}
// remainder(x, n) with sh = pow2_shift(n): in two's complement the low bits
// are the floor remainder
__device__ __forceinline__ int remainder_p2(int x, int n, int sh) {
  return sh >= 0 ? x & (n - 1) : remainder(x, n);
}

// ---- bulk copies between device and shared memory (sm_90) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: arm `bar` (count 1) for `bytes`, then start the copies of
// `n` rows (global src[i] -> shared dst[i], bytes[i] each, multiples of
// 16 at 16-byte-aligned addresses).  The warp then waits in bulk_wait.
__device__ __forceinline__ void bulk_load(uint32_t bar, int n,
                                          const uint32_t* dst,
                                          const void* const* src,
                                          const uint32_t* bytes) {
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) total += bytes[i];
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(total)
               : "memory");
  for (int i = 0; i < n; ++i) {
    if (bytes[i] == 0) continue;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(dst[i]),
        "l"(reinterpret_cast<uint64_t>(src[i])), "r"(bytes[i]), "r"(bar)
        : "memory");
  }
}

// Returns once the copies armed on `bar` (its first phase) have landed.
__device__ __forceinline__ void bulk_wait(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
}

// Every lane that wrote the shared rows calls it, then __syncwarp(): the
// generic-proxy writes become visible to the bulk copy's async proxy.
__device__ __forceinline__ void bulk_store_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: start the copies of `n` shared rows back to device memory
// (one bulk group); the same thread waits in bulk_store_wait before the
// block ends.  The launch's end makes the writes visible to the next
// launch on the stream.
__device__ __forceinline__ void bulk_store(int n, void* const* dst,
                                           const uint32_t* src,
                                           const uint32_t* bytes) {
  for (int i = 0; i < n; ++i) {
    if (bytes[i] == 0) continue;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(reinterpret_cast<uint64_t>(dst[i])), "r"(src[i]),
                 "r"(bytes[i])
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Returns once bulk_store's copies have read their shared rows (the block
// may then end and give its shared memory up).
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ---- per-section clock counters (a build with STEP_SECTIONS only) ----

// sections of a simulated step, in the order a step runs them; then the
// parts of a launch outside its steps (loading the DPU's state, waiting
// at the launch's vote, storing it back), the steps taken and the cycles
// of the whole launch
enum Section {
  S_PLAN, S_DRAM, S_ISSUE, S_DMA, S_CLASSIFY, S_LOAD, S_VOTE, S_STORE,
  S_STEPS, S_LAUNCH, N_SECTIONS
};

// Each lane keeps its own sums (every lane runs the same chain); lane 0
// adds them into the launch's buffer at the end.  Without STEP_SECTIONS
// every method is empty and the kernel's code is the plain build's.
struct Sections {
#ifdef STEP_SECTIONS
  long long acc[N_SECTIONS];
  long long t0, t_start;
  __device__ __forceinline__ void begin_launch() {
    for (int i = 0; i < N_SECTIONS; ++i) acc[i] = 0;
    t_start = t0 = clock64();
  }
  __device__ __forceinline__ void start() { t0 = clock64(); }
  __device__ __forceinline__ void mark(int s) {
    const long long t = clock64();
    acc[s] += t - t0;
    t0 = t;
  }
  __device__ __forceinline__ void step() { ++acc[S_STEPS]; }
  __device__ __forceinline__ void end_launch(long long* out, bool lead) {
    acc[S_LAUNCH] = clock64() - t_start;
    if (lead && out)
      for (int i = 0; i < N_SECTIONS; ++i)
        atomicAdd(reinterpret_cast<unsigned long long*>(out + i),
                  static_cast<unsigned long long>(acc[i]));
  }
#else
  __device__ __forceinline__ void begin_launch() {}
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void end_launch(long long*, bool) {}
#endif
};

}  // namespace step_common
