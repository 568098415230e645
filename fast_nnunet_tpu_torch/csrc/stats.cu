// Kernel A: per-(batch, channel) spatial sum and sum of squares, one pass.
// Replaces fast_nnunet_tpu/ops/pallas_stats.py spatial_sum_sumsq. See
// ops/stats.py for the contract and the design note.
//
// Layout: x is NCDHW-contiguous, i.e. `rows` = B*C rows of S contiguous
// voxels. One block owns one row and reduces it in a fixed order (per-thread
// strided partial sums, then a warp-shuffle tree), so the result is
// deterministic run to run: no atomics, no second pass. The per-thread sums
// are compensated (Kahan): a thread adds ~S/256 terms in a row, and on a
// nearly constant activation (air) plain f32 accumulation drifts by about
// that many ulps, all in one direction.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void fnn_kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_sum_sumsq_kernel(const T* __restrict__ x, long long S, int vec,
                         float* __restrict__ sum, float* __restrict__ sumsq) {
  const T* p = x + (long long)blockIdx.x * S;
  float s = 0.f, q = 0.f, cs = 0.f, cq = 0.f;
  if (vec) {
    // 16-byte loads: 8 bf16 or 4 f32 per thread per step (rows 16B-aligned)
    constexpr int E = 16 / sizeof(T);
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    const long long nv = S / E;
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      uint4 u = __ldg(pv + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float v = fnn_to_float(e[k]);
        fnn_kahan_add(s, cs, v);
        fnn_kahan_add(q, cq, v * v);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < S; i += kThreads) {
      const float v = fnn_to_float(p[i]);
      fnn_kahan_add(s, cs, v);
      fnn_kahan_add(q, cq, v * v);
    }
  }
  __shared__ float ss[kThreads / 32], qs[kThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  s = fnn_warp_sum(s);
  q = fnn_warp_sum(q);
  if (lane == 0) {
    ss[w] = s;
    qs[w] = q;
  }
  __syncthreads();
  if (w == 0) {
    s = lane < kThreads / 32 ? ss[lane] : 0.f;
    q = lane < kThreads / 32 ? qs[lane] : 0.f;
    s = fnn_warp_sum(s);
    q = fnn_warp_sum(q);
    if (lane == 0) {
      sum[blockIdx.x] = s;
      sumsq[blockIdx.x] = q;
    }
  }
}

}  // namespace

extern "C" int fnn_spatial_sum_sumsq(const void* x, int dtype, long long rows,
                                     long long S, int vec, float* sum,
                                     float* sumsq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FNN_BF16)
    spatial_sum_sumsq_kernel<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), S, vec, sum, sumsq);
  else
    spatial_sum_sumsq_kernel<float><<<(unsigned)rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), S, vec, sum, sumsq);
  return (int)cudaGetLastError();
}

// human-readable name of a cudaError_t code returned by the entry points
extern "C" const char* fnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
