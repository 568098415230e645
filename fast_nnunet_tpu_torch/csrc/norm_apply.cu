// Kernel E: the s2d InstanceNorm's affine and LeakyReLU in one pass over the
// activation. The JAX package has no Pallas kernel here (XLA fuses that
// arithmetic itself); this is a kernel of the port alone. The contract and
// the launch plan are in ops/norm_apply.py (launch_plan).
//
// Bound on the card: bytes. Per element it reads the conv output once and
// writes the result once (2 B + 2 B in bf16) and does five or six f32
// operations, far under the H100's ridge, so the floor is those bytes over
// the HBM rate.
//
// Layout: x is NCDHW-contiguous, `rows` = B * C8 rows of S contiguous voxels.
// Row b * C8 + ch normalises with the moments of logical channel ch % c of
// batch b (the offset-major s2d channels; c = C8 for groups 1) and, with a
// conv bias, adds that bias's entry ch first, so a block, which covers part
// of one row, keeps its five parameters in registers.
//
// Rounding: v = x + cb (kBias only), y = ((v - m) * r) * sc + bi in f32,
// each step rounded alone (__fadd_rn, __fsub_rn, __fmul_rn: nvcc contracts
// none of them into an FMA), then rounded to T (round to nearest even), then
// LeakyReLU on the rounded value as torch's kernel does it: v > 0 ? v :
// T(v * slope). That is the plain version's sequence of torch ops, so the
// two agree bit for bit. Without a conv bias no add is made at all (adding
// +0 would turn an x of -0 into +0).
//
// Each thread issues kUnroll independent 16-byte loads (8 bf16) before it
// computes and stores them; rows that are not whole 16-byte units at a
// 16-byte base take element loads. The output may be the input itself: each
// element is read and then written by the same thread, so no load is marked
// read-only (__ldg) and no pointer __restrict__.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // independent loads per thread

struct Params {
  float cb, m, r, sc, bi, slope;
};

template <bool kBias>
__device__ __forceinline__ float affine(float v, const Params& p) {
  if (kBias) v = __fadd_rn(v, p.cb);
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, p.m), p.r), p.sc), p.bi);
}

// the value stored for element v, as a float that T holds exactly
template <bool kAct, bool kBias>
__device__ __forceinline__ float finish_f32(float v, const Params& p) {
  const float y = affine<kBias>(v, p);
  return (!kAct || y > 0.f) ? y : __fmul_rn(y, p.slope);
}

template <bool kAct, bool kBias>
__device__ __forceinline__ unsigned short finish_bf16(float v,
                                                      const Params& p) {
  __nv_bfloat16 h = __float2bfloat16_rn(affine<kBias>(v, p));
  if (kAct) {
    const float y = __bfloat162float(h);
    if (!(y > 0.f)) h = __float2bfloat16_rn(__fmul_rn(y, p.slope));
  }
  return __bfloat16_as_ushort(h);
}

template <bool kAct, bool kBias>
__device__ __forceinline__ unsigned bf16_pair(unsigned w, const Params& p) {
  // element 2i in the low half of word i, element 2i + 1 in the high half
  const unsigned lo = finish_bf16<kAct, kBias>(__uint_as_float(w << 16), p);
  const unsigned hi =
      finish_bf16<kAct, kBias>(__uint_as_float(w & 0xffff0000u), p);
  return lo | (hi << 16);
}

// the 16 bytes of one load (8 bf16 or 4 f32), each element finished
template <bool kAct, bool kBias, typename T>
__device__ __forceinline__ uint4 apply16(uint4 u, const Params& p) {
  if constexpr (sizeof(T) == 2) {
    return make_uint4(
        bf16_pair<kAct, kBias>(u.x, p), bf16_pair<kAct, kBias>(u.y, p),
        bf16_pair<kAct, kBias>(u.z, p), bf16_pair<kAct, kBias>(u.w, p));
  } else {
    return make_uint4(
        __float_as_uint(finish_f32<kAct, kBias>(__uint_as_float(u.x), p)),
        __float_as_uint(finish_f32<kAct, kBias>(__uint_as_float(u.y), p)),
        __float_as_uint(finish_f32<kAct, kBias>(__uint_as_float(u.z), p)),
        __float_as_uint(finish_f32<kAct, kBias>(__uint_as_float(u.w), p)));
  }
}

template <bool kAct, bool kBias>
__device__ __forceinline__ void store1(float* y, float v, const Params& p) {
  *y = finish_f32<kAct, kBias>(v, p);
}

template <bool kAct, bool kBias>
__device__ __forceinline__ void store1(__nv_bfloat16* y, float v,
                                       const Params& p) {
  *y = __ushort_as_bfloat16(finish_bf16<kAct, kBias>(v, p));
}

// Grid: rows * chunks blocks; block `part` of a row covers the units
// [part * span, min((part + 1) * span, n)) of it, span = kUnroll *
// blockDim.x, a unit being 16 bytes (vec) or one element. conv_bias: (C8,)
// (read only with kBias); mean, rstd: (B, c); scale, bias: (c,).
template <bool kAct, bool kBias, typename T>
__global__ void __launch_bounds__(256)
norm_apply_kernel(const T* x, T* y, long long S, int C8, int c, int chunks,
                  int vec, const float* __restrict__ conv_bias,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float slope) {
  const long long row = blockIdx.x / (unsigned)chunks;
  const int part = (int)(blockIdx.x % (unsigned)chunks);
  const int ch = (int)(row % C8), lc = ch % c;
  const long long bc = (row / C8) * c + lc;
  const Params p = {kBias ? __ldg(conv_bias + ch) : 0.f, __ldg(mean + bc),
                    __ldg(rstd + bc), __ldg(scale + lc), __ldg(bias + lc),
                    slope};
  const long long span = (long long)kUnroll * blockDim.x;
  const long long first = part * span + threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const long long n = S / E;
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * S);
    uint4* yv = reinterpret_cast<uint4*>(y + row * S);
    uint4 u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = first + (long long)j * blockDim.x;
      if (i < n) u[j] = xv[i];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = first + (long long)j * blockDim.x;
      if (i < n) yv[i] = apply16<kAct, kBias, T>(u[j], p);
    }
  } else {
    const T* xr = x + row * S;
    T* yr = y + row * S;
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = first + (long long)j * blockDim.x;
      if (i < S) v[j] = fnn_to_float(xr[i]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = first + (long long)j * blockDim.x;
      if (i < S) store1<kAct, kBias>(yr + i, v[j], p);
    }
  }
}

template <bool kAct, bool kBias, typename T>
void launch_one(dim3 grid, dim3 block, cudaStream_t st, const void* x,
                void* y, long long S, int C8, int c, int chunks, int vec,
                const float* conv_bias, const float* mean, const float* rstd,
                const float* scale, const float* bias, float slope) {
  norm_apply_kernel<kAct, kBias, T><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), S, C8, c, chunks, vec,
      conv_bias, mean, rstd, scale, bias, slope);
}

template <typename T>
int launch(const void* x, void* y, long long rows, long long S, int C8, int c,
           int threads, int chunks, int vec, const float* conv_bias,
           const float* mean, const float* rstd, const float* scale,
           const float* bias, int act, float slope, cudaStream_t st) {
  const dim3 grid((unsigned)(rows * chunks)), block((unsigned)threads);
  auto* run = act ? (conv_bias ? launch_one<true, true, T>
                               : launch_one<true, false, T>)
                  : (conv_bias ? launch_one<false, true, T>
                               : launch_one<false, false, T>);
  run(grid, block, st, x, y, S, C8, c, chunks, vec, conv_bias, mean, rstd,
      scale, bias, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, S) NCDHW rows (y may be x), rows = B * C8; the plan: threads
// per block, chunks (blocks) per row, vec (16-byte path). conv_bias: (C8,)
// f32, added to x before the norm, or null for none; mean, rstd: (B, c)
// f32; scale, bias: (c,) f32; act: LeakyReLU(slope) after the affine.
extern "C" int fnn_norm_apply(const void* x, void* y, int dtype,
                              long long rows, long long S, int C8, int c,
                              int threads, int chunks, int vec,
                              const float* conv_bias, const float* mean,
                              const float* rstd, const float* scale,
                              const float* bias, int act, float slope,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FNN_BF16)
    return launch<__nv_bfloat16>(x, y, rows, S, C8, c, threads, chunks, vec,
                                 conv_bias, mean, rstd, scale, bias, act,
                                 slope, st);
  return launch<float>(x, y, rows, S, C8, c, threads, chunks, vec, conv_bias,
                       mean, rstd, scale, bias, act, slope, st);
}
