// Kernel A: per-(batch, channel) spatial sum and sum of squares, one pass.
// Replaces fast_nnunet_tpu/ops/pallas_stats.py:58 spatial_sum_sumsq. The
// contract and the launch plan are in ops/stats.py (launch_plan).
//
// Bound on the card: bytes. Each element is read once and costs a few f32
// operations, far under the H100's ridge, so the floor is the input's bytes
// over the HBM rate. To reach it the card needs many 16-byte loads in flight
// on every SM.
//
// Layout: x is NCDHW-contiguous, i.e. `rows` = B*C rows of S contiguous
// voxels. The row-count limit: with one block per row, a training call of
// 32 or 64 rows (B = 2 at full resolution) keeps most of the 132 SMs idle.
// So a row is split over a thread-block cluster of k blocks (the plan's k,
// up to 8, the portable cluster size): block `rank` of the cluster reduces the contiguous voxels
// [rank * chunk, min((rank + 1) * chunk, S)) of the row, then rank 0 reads
// the k compensated partials through distributed shared memory in rank
// order and writes the row's result. One launch, no workspace, no atomics:
// the result is bit-for-bit the same run to run. k = 1 (the serving calls,
// with rows enough to fill the card) is one block per row, no cluster.
//
// On the 16-byte path each thread issues kUnroll independent loads per step
// before it reduces them. The elements of one 16-byte load are summed
// pairwise in f32, and those partials go into per-thread compensated (Kahan)
// sums: a thread adds up to hundreds of partials of a row, and on a nearly
// constant activation (air) plain f32 accumulation drifts by about that many
// ulps, all in one direction.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent 16-byte loads per thread per step

__device__ __forceinline__ void fnn_kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// sum and sum of squares of two values
__device__ __forceinline__ void pair_moments(float a, float b, float& s,
                                             float& q) {
  s = a + b;
  q = fmaf(a, a, b * b);
}

// sum and sum of squares of the elements of one 16-byte chunk, pairwise
template <typename T>
__device__ __forceinline__ void chunk_moments(const uint4& u, float& s,
                                              float& q);

template <>
__device__ __forceinline__ void chunk_moments<__nv_bfloat16>(const uint4& u,
                                                             float& s,
                                                             float& q) {
  // a bf16 is the high half of its f32: element 2i in the low half of word
  // i, element 2i + 1 in the high half
  float s0, s1, s2, s3, q0, q1, q2, q3;
  pair_moments(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
               s0, q0);
  pair_moments(__uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u),
               s1, q1);
  pair_moments(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
               s2, q2);
  pair_moments(__uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u),
               s3, q3);
  s = (s0 + s1) + (s2 + s3);
  q = (q0 + q1) + (q2 + q3);
}

template <>
__device__ __forceinline__ void chunk_moments<float>(const uint4& u, float& s,
                                                     float& q) {
  float s0, s1, q0, q1;
  pair_moments(__uint_as_float(u.x), __uint_as_float(u.y), s0, q0);
  pair_moments(__uint_as_float(u.z), __uint_as_float(u.w), s1, q1);
  s = s0 + s1;
  q = q0 + q1;
}

// Grid: rows * k blocks, clusters of k along x. `chunk` voxels per block
// (a multiple of 16 bytes' worth when vec). vec: every block range starts
// and ends on 16 bytes (the plan's choice).
template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_sum_sumsq_kernel(const T* __restrict__ x, long long S,
                         long long chunk, int k, int vec,
                         float* __restrict__ sum, float* __restrict__ sumsq) {
  // a cluster is k consecutive blocks: one row
  const int rank = k > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long row = blockIdx.x / (unsigned)k;
  const long long start = min((long long)rank * chunk, S);
  const long long end = min(start + chunk, S);
  const T* p = x + row * S + start;
  float s = 0.f, q = 0.f, cs = 0.f, cq = 0.f;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    const long long n = (end - start) / E;
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
      uint4 u[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) u[j] = __ldg(pv + i + j * kThreads);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        float a, b;
        chunk_moments<T>(u[j], a, b);
        fnn_kahan_add(s, cs, a);
        fnn_kahan_add(q, cq, b);
      }
    }
    for (; i < n; i += kThreads) {
      float a, b;
      chunk_moments<T>(__ldg(pv + i), a, b);
      fnn_kahan_add(s, cs, a);
      fnn_kahan_add(q, cq, b);
    }
  } else {
    // any S, any alignment: element loads
    for (long long i = threadIdx.x; i < end - start; i += kThreads) {
      const float v = fnn_to_float(p[i]);
      fnn_kahan_add(s, cs, v);
      fnn_kahan_add(q, cq, v * v);
    }
  }
  s -= cs;
  q -= cq;

  // block: warp shuffles, then warp 0 over the 8 warp sums (fixed order)
  __shared__ float ss[kThreads / 32], qs[kThreads / 32];
  __shared__ float part[2];  // this block's partial, read by cluster rank 0
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
      if (k == 1) {
        sum[row] = s;
        sumsq[row] = q;
      } else {
        part[0] = s;
        part[1] = q;
      }
    }
  }
  if (k == 1) return;

  // cluster: rank 0 gathers the k partials (lane r reads rank r), then
  // adds them in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial written and visible across the cluster
  if (rank == 0 && w == 0) {
    float ps = 0.f, pq = 0.f;
    if (lane < k) {
      const float* remote = cluster.map_shared_rank(part, lane);
      ps = remote[0];
      pq = remote[1];
    }
    float ts = 0.f, tq = 0.f, cts = 0.f, ctq = 0.f;
    for (int r = 0; r < k; ++r) {
      fnn_kahan_add(ts, cts, __shfl_sync(0xffffffffu, ps, r));
      fnn_kahan_add(tq, ctq, __shfl_sync(0xffffffffu, pq, r));
    }
    if (lane == 0) {
      sum[row] = ts - cts;
      sumsq[row] = tq - ctq;
    }
  }
  cluster.sync();  // no block exits while rank 0 may still read its part
}

template <typename T>
int launch(const void* x, long long rows, long long S, long long chunk,
           int k, int vec, float* sum, float* sumsq, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (k > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, spatial_sum_sumsq_kernel<T>, static_cast<const T*>(x), S, chunk,
      k, vec, sum, sumsq);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, S) NCDHW rows; the plan: k blocks per row (one cluster), chunk
// voxels per block, vec (16-byte path). sum, sumsq: (rows,) f32.
extern "C" int fnn_spatial_sum_sumsq(const void* x, int dtype, long long rows,
                                     long long S, long long chunk, int k,
                                     int vec, float* sum, float* sumsq,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FNN_BF16)
    return launch<__nv_bfloat16>(x, rows, S, chunk, k, vec, sum, sumsq, st);
  return launch<float>(x, rows, S, chunk, k, vec, sum, sumsq, st);
}

// human-readable name of a cudaError_t code returned by the entry points
extern "C" const char* fnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
