// Shared helpers for the port's Hopper kernels (built by ops/_build.py with
// nvcc -gencode arch=compute_90a,code=sm_90a into one ctypes-loaded library).
// Every extern "C" entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, shared with ops/_build.py DTYPE_CODES
#define FNN_F32 0
#define FNN_BF16 1

__device__ __forceinline__ float fnn_to_float(float v) { return v; }
__device__ __forceinline__ float fnn_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void fnn_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fnn_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float fnn_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One asynchronous 16-byte global -> shared copy (L1 bypassed); it lands at
// the issuing thread's next fnn_cp_async_wait_all, and other threads see it
// after a __syncthreads that follows that wait.
__device__ __forceinline__ void fnn_cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void fnn_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
