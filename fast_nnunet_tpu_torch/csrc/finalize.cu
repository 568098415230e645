// Kernel B: per-offset argmax over the flat offset-major s2d accumulator,
// with the cyclic row mapping and in-place retirement of consumed rows.
// Replaces fast_nnunet_tpu/ops/pallas_finalize.py grouped_argmax. See
// ops/finalize.py for the contract, the launch plan (the host computes it,
// this file follows it) and what bounds the kernel on the card.
//
// A block owns a run of `run` consecutive voxels of one (virtual row i,
// plane row y) line; the run is contiguous in the accumulator. The block
// copies lanes [0, 8K) of each voxel into its own shared-memory row with
// 16-byte cp.async (rows `stride16` 16-byte units apart, an odd count, so the
// 32 voxels a warp reads at once fall on distinct bank groups), zeroes the
// whole run in place with 16-byte stores when the row retires, then thread
// (o, v) scans the K lanes of offset group o of voxel v in shared memory with
// float4 / 8 x bf16 reads: no shuffles. Ties take the lowest index and NaN
// counts as the maximum, as jnp.argmax / torch.argmax do. Consecutive threads
// take consecutive voxels of one group, so the uint8 stores coalesce.
//
// Bound by bytes: at the main path's call (23 rows, zeroed) it takes about
// 0.445 ms on an H100 (80GB HBM3, 700 W), 87% of its byte bound (0.386 ms).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // 8 groups x a run of at most 32 voxels

__device__ __forceinline__ unsigned fnn_word(const uint4& r, int m) {
  return m == 0 ? r.x : m == 1 ? r.y : m == 2 ? r.z : r.w;
}

// lane e of a 16-byte unit as f32 (e is a constant after unrolling)
__device__ __forceinline__ float fnn_unit_lane(const uint4& r, int e,
                                               const float*) {
  return __uint_as_float(fnn_word(r, e));
}
__device__ __forceinline__ float fnn_unit_lane(const uint4& r, int e,
                                               const __nv_bfloat16*) {
  const unsigned w = fnn_word(r, e >> 1);  // bf16 = the high half of an f32
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
grouped_argmax_kernel(T* __restrict__ acc, int p0h, int Yh, int Zh, int c8p,
                      int K, int row_base, int n_zero, int run, int stride16,
                      int vec16, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint4 rows[];  // run x stride16 units
  constexpr int kPer = 16 / sizeof(T);           // lanes per 16-byte unit
  const int z0 = blockIdx.x * run, y = blockIdx.y, i = blockIdx.z;
  const int nv = min(run, Zh - z0);
  const int phys = (row_base + i) % p0h;
  T* src = acc + (((long long)phys * Yh + y) * Zh + z0) * c8p;
  const int C8 = 8 * K;
  if (vec16) {  // C8 and c8p lanes are whole units, src 16-byte aligned
    const int units = C8 / kPer, step = c8p / kPer;
    for (int e = threadIdx.x; e < nv * units; e += blockDim.x) {
      const int v = e / units, u = e - v * units;
      fnn_cp_async16(rows + v * stride16 + u,
                     reinterpret_cast<const uint4*>(src) + v * step + u);
    }
    fnn_cp_async_wait_all();
  } else {
    T* s = reinterpret_cast<T*>(rows);
    for (int e = threadIdx.x; e < nv * C8; e += blockDim.x) {
      const int v = e / C8, l = e - v * C8;
      s[v * stride16 * kPer + l] = src[(long long)v * c8p + l];
    }
  }
  __syncthreads();  // every read of the run is done before it is zeroed
  if (i < n_zero) {
    if (vec16) {
      const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
      for (int e = threadIdx.x; e < nv * c8p / kPer; e += blockDim.x)
        reinterpret_cast<uint4*>(src)[e] = z4;
    } else {
      for (int e = threadIdx.x; e < nv * c8p; e += blockDim.x)
        fnn_store(src + e, 0.f);
    }
  }

  const int o = threadIdx.x / run, v = threadIdx.x - o * run;
  if (o >= 8 || v >= nv) return;
  const uint4* row = rows + v * stride16;
  const int l0 = o * K;
  float best = -INFINITY;
  int bi = 0;
  for (int u = l0 / kPer; u * kPer < l0 + K; ++u) {
    const uint4 raw = row[u];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int k = u * kPer + e - l0;
      if ((unsigned)k < (unsigned)K) {
        const float x = fnn_unit_lane(raw, e, static_cast<const T*>(nullptr));
        if (x > best || (isnan(x) && !isnan(best))) {
          best = x;
          bi = k;
        }
      }
    }
  }
  out[(((long long)i * 8 + o) * Yh + y) * Zh + z0 + v] = (uint8_t)bi;
}

template <typename T>
int launch(T* acc, dim3 grid, int run, int smem, cudaStream_t st, int p0h,
           int Yh, int Zh, int c8p, int K, int row_base, int n_zero,
           int stride16, int vec16, uint8_t* out) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_argmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  grouped_argmax_kernel<T><<<grid, 8 * run, smem, st>>>(
      acc, p0h, Yh, Zh, c8p, K, row_base, n_zero, run, stride16, vec16, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fnn_grouped_argmax(void* acc, int dtype, int p0h, int Yh,
                                  int Zh, int c8p, int K, int n_rows,
                                  int row_base, int n_zero, int run,
                                  int stride16, int smem, int vec16,
                                  void* out, void* stream) {
  if (run < 1 || 8 * run > kMaxThreads || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((Zh + run - 1) / run), (unsigned)Yh,
                  (unsigned)n_rows);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (dtype == FNN_BF16)
    return launch(static_cast<__nv_bfloat16*>(acc), grid, run, smem, st, p0h,
                  Yh, Zh, c8p, K, row_base, n_zero, stride16, vec16, o);
  return launch(static_cast<float*>(acc), grid, run, smem, st, p0h, Yh, Zh,
                c8p, K, row_base, n_zero, stride16, vec16, o);
}

