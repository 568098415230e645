// Kernel D: gaussian-weighted scatter-accumulate of one tile batch into the
// full-resolution sweep accumulator. Replaces
// fast_nnunet_tpu/ops/pallas_kernels.py fused_scatter_accumulate. See
// ops/scatter_accumulate.py for the contract and the design note.
//
// acc (X, Y, Z, C) += logits[b] * gauss at coords[b] for b < n_real.
// Block r owns one (x, y) accumulator row of the batch's footprint and walks
// the tiles in batch order; a covering tile adds its contiguous (pz * C)
// lane run with 16-byte vector loads. A barrier separates two covering tiles
// of one row, so tiles that overlap are applied in batch order with no
// atomics, and every accumulator element is written by one block
// (deterministic). bf16: acc = bf16(f32(acc) + f32(l) * f32(g)), the
// product exact in f32; f32: acc + l * g with no FMA contraction.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 32;

struct TileArgs {
  int x0[kMaxTiles];
  int y0[kMaxTiles];
  int z0[kMaxTiles];
};

// 8 bf16 lanes in one 16-byte vector
__device__ __forceinline__ void fnn_madd(uint4& a, const uint4& l,
                                         const uint4& g) {
  __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* lp = reinterpret_cast<const __nv_bfloat162*>(&l);
  const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 av = __bfloat1622float2(ap[i]);
    const float2 lv = __bfloat1622float2(lp[i]);
    const float2 gv = __bfloat1622float2(gp[i]);
    ap[i] = __floats2bfloat162_rn(__fadd_rn(av.x, __fmul_rn(lv.x, gv.x)),
                                  __fadd_rn(av.y, __fmul_rn(lv.y, gv.y)));
  }
}

// 4 f32 lanes in one 16-byte vector
__device__ __forceinline__ void fnn_madd(float4& a, const float4& l,
                                         const float4& g) {
  a.x = __fadd_rn(a.x, __fmul_rn(l.x, g.x));
  a.y = __fadd_rn(a.y, __fmul_rn(l.y, g.y));
  a.z = __fadd_rn(a.z, __fmul_rn(l.z, g.z));
  a.w = __fadd_rn(a.w, __fmul_rn(l.w, g.w));
}

// V: the 16-byte vector type; kLanes: elements of the accumulator dtype in V.
// All offsets below are in elements, then divided by kLanes: C % 8 == 0
// makes every row start a whole number of vectors.
template <typename V, int kLanes>
__global__ void __launch_bounds__(kThreads)
scatter_accumulate_kernel(V* acc, const V* __restrict__ logits,
                          const V* __restrict__ gauss, TileArgs tiles,
                          int n_real, int px, int py, int pz, int Y, int Z,
                          int C, int x_lo, int y_lo, int n_y) {
  const int x = x_lo + (int)(blockIdx.x / (unsigned)n_y);
  const int y = y_lo + (int)(blockIdx.x % (unsigned)n_y);
  const long long run = (long long)pz * C;  // elements of one tile row
  const int n_vec = (int)(run / kLanes);
  bool first = true;
  for (int b = 0; b < n_real; ++b) {
    const int lx = x - tiles.x0[b], ly = y - tiles.y0[b];
    if (lx < 0 || lx >= px || ly < 0 || ly >= py) continue;  // block-uniform
    if (!first) __syncthreads();  // the previous tile's writes land first
    first = false;
    V* a = acc + ((((long long)x * Y + y) * Z + tiles.z0[b]) * C) / kLanes;
    const V* l = logits + ((((long long)b * px + lx) * py + ly) * run) / kLanes;
    const V* g = gauss + (((long long)lx * py + ly) * run) / kLanes;
    for (int v = threadIdx.x; v < n_vec; v += kThreads) {
      V av = a[v];
      fnn_madd(av, l[v], g[v]);
      a[v] = av;
    }
  }
}

}  // namespace

extern "C" int fnn_scatter_accumulate(void* acc, int dtype, const void* logits,
                                      const void* gauss, const int* x0,
                                      const int* y0, const int* z0, int n_real,
                                      int px, int py, int pz, int Y, int Z,
                                      int C, int x_lo, int x_hi, int y_lo,
                                      int y_hi, void* stream) {
  if (n_real < 1 || n_real > kMaxTiles || x_hi <= x_lo || y_hi <= y_lo ||
      C % 8 != 0)
    return (int)cudaErrorInvalidValue;
  TileArgs tiles;
  for (int b = 0; b < n_real; ++b) {
    tiles.x0[b] = x0[b];
    tiles.y0[b] = y0[b];
    tiles.z0[b] = z0[b];
  }
  const int n_y = y_hi - y_lo;
  const unsigned blocks = (unsigned)((long long)(x_hi - x_lo) * n_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FNN_BF16)
    scatter_accumulate_kernel<uint4, 8><<<blocks, kThreads, 0, st>>>(
        static_cast<uint4*>(acc), static_cast<const uint4*>(logits),
        static_cast<const uint4*>(gauss), tiles, n_real, px, py, pz, Y, Z, C,
        x_lo, y_lo, n_y);
  else
    scatter_accumulate_kernel<float4, 4><<<blocks, kThreads, 0, st>>>(
        static_cast<float4*>(acc), static_cast<const float4*>(logits),
        static_cast<const float4*>(gauss), tiles, n_real, px, py, pz, Y, Z, C,
        x_lo, y_lo, n_y);
  return (int)cudaGetLastError();
}
