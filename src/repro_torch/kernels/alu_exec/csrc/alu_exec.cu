// Elementwise ALU over N lanes: out[i] = alu_exec_one(op[i], a[i], b[i]).
//
// Replaces the Pallas TPU kernel repro/kernels/alu_exec/alu_exec.py
// (_alu_kernel, launched by alu_exec_2d over (8, 128) int32 tiles).
// Here there are no tiles to pad to: one thread per lane, grid-stride,
// ragged edge masked by the loop bound.
//
// What bounds it on an H100: the engine calls it once per issue slot per
// simulated cycle over (D,) lanes, D = the DPU count (64 for one UPMEM
// rank).  That is 16*D bytes moved (three int32 inputs, one output):
// 1 KB at D = 64, about 0.3 ns at 3.35 TB/s.  So the launch latency
// (a few microseconds) bounds it, not bytes or operations.  The design
// answers that by keeping the ALU a __device__ function in alu_exec.cuh,
// so that a fused cycle-step kernel can call it with no launch of its own.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C interface, no PyTorch headers).
#include <cuda_runtime.h>

#include <cstdint>

#include "alu_exec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM on 132 SMs

__global__ void alu_exec_kernel(const int32_t* __restrict__ op,
                                const int32_t* __restrict__ a,
                                const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = alu_exec_one(op[i], a[i], b[i]);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() as int.
extern "C" int alu_exec_launch(const void* op, const void* a, const void* b,
                               void* out, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  alu_exec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
