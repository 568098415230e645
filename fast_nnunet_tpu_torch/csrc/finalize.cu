// Kernel B: per-offset argmax over the flat offset-major s2d accumulator,
// with the cyclic row mapping and in-place retirement of consumed rows.
// Replaces fast_nnunet_tpu/ops/pallas_finalize.py grouped_argmax. See
// ops/finalize.py for the contract and the design note.
//
// One warp per accumulator voxel (virtual row i, y, z): the warp reads the
// voxel's c8p contiguous lanes (coalesced), and for each offset group o the
// lanes reduce (max, lowest index) over [o*K, (o+1)*K) by shuffles. Ties take
// the lowest index and NaN counts as the maximum, as jnp.argmax /
// torch.argmax do. Pad lanes >= 8K are never read. Virtual rows < n_zero are
// zeroed in place (all c8p lanes) after they are read.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps = 8 voxels per block

__device__ __forceinline__ bool fnn_better(float v, int iv, float b, int ib) {
  const bool vn = isnan(v), bn = isnan(b);
  if (vn || bn) return vn && (!bn || iv < ib);
  return v > b || (v == b && iv < ib);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_argmax_kernel(T* __restrict__ acc, int p0h, int Yh, int Zh, int c8p,
                      int K, int n_rows, int row_base, int n_zero,
                      uint8_t* __restrict__ out) {
  const long long plane = (long long)Yh * Zh;
  const long long voxel =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;  // warp-uniform
  if (voxel >= (long long)n_rows * plane) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(voxel / plane);
  const long long yz = voxel - (long long)i * plane;
  const int phys = (row_base + i) % p0h;
  T* row = acc + ((long long)phys * plane + yz) * c8p;
#pragma unroll 1
  for (int o = 0; o < 8; ++o) {
    float best = -INFINITY;
    int bi = K;  // sentinel: loses every tie against a real lane
    for (int k = lane; k < K; k += 32) {
      const float v = fnn_to_float(row[o * K + k]);
      if (fnn_better(v, k, best, bi)) {
        best = v;
        bi = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (fnn_better(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[((long long)i * 8 + o) * plane + yz] = (uint8_t)bi;
  }
  if (i < n_zero) {
    __syncwarp();
    for (int j = lane; j < c8p; j += 32) fnn_store(row + j, 0.f);
  }
}

}  // namespace

extern "C" int fnn_grouped_argmax(void* acc, int dtype, int p0h, int Yh,
                                  int Zh, int c8p, int K, int n_rows,
                                  int row_base, int n_zero, void* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long warps = (long long)n_rows * Yh * Zh;
  const unsigned blocks = (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (dtype == FNN_BF16)
    grouped_argmax_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(acc), p0h, Yh, Zh, c8p, K, n_rows,
        row_base, n_zero, o);
  else
    grouped_argmax_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<float*>(acc), p0h, Yh, Zh, c8p, K, n_rows, row_base,
        n_zero, o);
  return (int)cudaGetLastError();
}
