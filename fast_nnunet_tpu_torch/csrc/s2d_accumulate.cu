// Kernel C: fused 1^3 seg head + gaussian weight + accumulator
// read-modify-write for one batch of s2d tiles. Replaces
// fast_nnunet_tpu/ops/pallas_s2d.py fused_head_gauss_accumulate (f32
// accumulator) and its XLA twin, the bf16 accumulate_batch of the default
// sweep (bf16 accumulator). See ops/s2d_accumulate.py for the contract and
// the design note.
//
// Tiles of one batch overlap (tile step 0.5), so blocks own ACCUMULATOR rows,
// not tiles: block (Y - y_lo, i) owns row (phys(i), Y, :, :) and walks the
// batch's tiles in batch order, adding each covering tile's contribution to
// that row's z-span [zh0, zh0 + pzh) x [0, 8K). Each accumulator element is
// written by exactly one block, tile after tile: race-free and deterministic.
// Per tile, the block stages the tile's (8F, pzh) features and (pzh, 8)
// gaussian row in shared memory; the per-offset F x K head weights stay in
// shared memory for the whole block. The head dot is an ordered f32 sum of
// unfused products (f = 0..F-1), so the plain PyTorch version reproduces it
// bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 32;

struct TileArgs {
  int yh0[kMaxTiles];
  int zh0[kMaxTiles];
  float valid[kMaxTiles];
};

// f32 accumulator: the Pallas contract, acc += (dot + b) * g
__device__ __forceinline__ void fnn_accumulate(float* dst, float dot, float b,
                                               float g) {
  *dst = __fadd_rn(*dst, __fmul_rn(__fadd_rn(dot, b), g));
}

// bf16 accumulator: the XLA accumulate_batch sequence op for op,
// y = bf16(bf16(dot) + b); c = bf16(f32(y) * g); acc = bf16(acc + c)
__device__ __forceinline__ void fnn_accumulate(__nv_bfloat16* dst, float dot,
                                               float b, float g) {
  const float y = fnn_round_bf16(__fadd_rn(fnn_round_bf16(dot), b));
  const float c = fnn_round_bf16(__fmul_rn(y, g));
  *dst = __float2bfloat16_rn(__fadd_rn(__bfloat162float(*dst), c));
}

template <typename TF, typename TA>
__global__ void __launch_bounds__(kThreads)
s2d_accumulate_kernel(TA* __restrict__ acc, const TF* __restrict__ feats,
                      const float* __restrict__ g,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, TileArgs tiles, int B,
                      int p0h, int pyh, int pzh, int F, int K, int Yh, int Zh,
                      int c8p, int row_base, int y_lo) {
  extern __shared__ float smem[];
  const int C8 = 8 * K, F8 = 8 * F;
  float* ws = smem;            // (8, F, K) per-offset head weights
  float* bs = ws + 8 * F * K;  // (8K,) bias
  float* fs = bs + C8;         // (8F, pzh) this tile's feature row
  float* gs = fs + F8 * pzh;   // (pzh, 8) gaussian row * validity

  const int i = blockIdx.y;  // virtual tile row
  const int Y = y_lo + blockIdx.x;
  bool covered = false;
  for (int t = 0; t < B; ++t)
    covered |= tiles.valid[t] != 0.f && Y >= tiles.yh0[t] &&
               Y < tiles.yh0[t] + pyh;
  if (!covered) return;  // block-uniform

  for (int e = threadIdx.x; e < 8 * F * K; e += kThreads) ws[e] = w[e];
  for (int e = threadIdx.x; e < C8; e += kThreads) bs[e] = bias[e];

  const int phys = (row_base + i) % p0h;
  const long long S = (long long)p0h * pyh * pzh;
  for (int t = 0; t < B; ++t) {
    const float vt = tiles.valid[t];
    const int yl = Y - tiles.yh0[t];
    if (vt == 0.f || yl < 0 || yl >= pyh) continue;  // block-uniform
    __syncthreads();  // the previous tile's smem reads and acc writes
    const TF* fp = feats + (long long)t * F8 * S + ((long long)i * pyh + yl) * pzh;
    for (int e = threadIdx.x; e < F8 * pzh; e += kThreads) {
      const int c = e / pzh, z = e - c * pzh;
      fs[e] = fnn_to_float(fp[(long long)c * S + z]);
    }
    const float* gp = g + ((long long)i * pyh + yl) * pzh * 8;
    for (int e = threadIdx.x; e < pzh * 8; e += kThreads)
      gs[e] = __fmul_rn(gp[e], vt);
    __syncthreads();

    TA* rowp = acc + (((long long)phys * Yh + Y) * Zh + tiles.zh0[t]) * c8p;
    const int n = pzh * C8;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int z = e / C8, j = e - z * C8;
      const int o = j / K, k = j - o * K;
      const float* fo = fs + o * F * pzh + z;
      const float* wo = ws + o * F * K + k;
      float dot = __fmul_rn(fo[0], wo[0]);
      for (int f = 1; f < F; ++f)
        dot = __fadd_rn(dot, __fmul_rn(fo[f * pzh], wo[f * K]));
      fnn_accumulate(rowp + (long long)z * c8p + j, dot, bs[j], gs[z * 8 + o]);
    }
  }
}

template <typename TF, typename TA>
int launch(void* acc, const void* feats, const float* g, const float* w,
           const float* bias, const TileArgs& tiles, int B, int p0h, int pyh,
           int pzh, int F, int K, int Yh, int Zh, int c8p, int row_base,
           int y_lo, int y_hi, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)8 * F * K + 8 * K + (size_t)8 * F * pzh + pzh * 8);
  cudaError_t err = cudaFuncSetAttribute(
      s2d_accumulate_kernel<TF, TA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(y_hi - y_lo), (unsigned)p0h);
  s2d_accumulate_kernel<TF, TA><<<grid, kThreads, smem, st>>>(
      static_cast<TA*>(acc), static_cast<const TF*>(feats), g, w, bias, tiles,
      B, p0h, pyh, pzh, F, K, Yh, Zh, c8p, row_base, y_lo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fnn_s2d_accumulate(void* acc, int acc_dtype, const void* feats,
                                  int feat_dtype, const float* g,
                                  const float* w, const float* bias,
                                  const int* yh0, const int* zh0,
                                  const float* valid, int B, int p0h, int pyh,
                                  int pzh, int F, int K, int Yh, int Zh,
                                  int c8p, int row_base, int y_lo, int y_hi,
                                  void* stream) {
  if (B < 1 || B > kMaxTiles || y_hi <= y_lo) return (int)cudaErrorInvalidValue;
  TileArgs tiles;
  for (int t = 0; t < B; ++t) {
    tiles.yh0[t] = yh0[t];
    tiles.zh0[t] = zh0[t];
    tiles.valid[t] = valid[t];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FNN_LAUNCH(TF, TA)                                                  \
  return launch<TF, TA>(acc, feats, g, w, bias, tiles, B, p0h, pyh, pzh, F, \
                        K, Yh, Zh, c8p, row_base, y_lo, y_hi, st)
  if (feat_dtype == FNN_BF16) {
    if (acc_dtype == FNN_BF16) FNN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    FNN_LAUNCH(__nv_bfloat16, float);
  }
  if (acc_dtype == FNN_BF16) FNN_LAUNCH(float, __nv_bfloat16);
  FNN_LAUNCH(float, float);
#undef FNN_LAUNCH
}
