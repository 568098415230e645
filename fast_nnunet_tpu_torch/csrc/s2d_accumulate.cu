// Kernel C: fused 1^3 seg head + gaussian weight + accumulator
// read-modify-write for one batch of s2d tiles. Replaces
// fast_nnunet_tpu/ops/pallas_s2d.py fused_head_gauss_accumulate (f32
// accumulator) and its XLA twin, the bf16 accumulate_batch of the default
// sweep (bf16 accumulator). See ops/s2d_accumulate.py for the contract, the
// launch plan (the host computes it, this file follows it) and what bounds
// the kernel on the card.
//
// A block owns one (virtual row i, plane row Y) line of the accumulator for
// the whole launch and walks it in pieces of SEG z voxels (all lanes). Each
// piece is copied to shared memory once (16-byte cp.async), gets every
// covering tile in batch order while it stays there, and is written back
// once: the accumulator moves once per launch, race-free and deterministic.
// The walk is a list of steps (segment, covering tile) that one warp builds
// with ballots; each step costs one barrier. While a step's math runs, the
// step after next has its features and gaussian in flight into registers,
// the next step's are staged (double-buffered), and at a segment's first
// step the next segment's piece is in flight (a ring of three piece
// buffers). Thread (o, kq) holds lanes k0 = 2kq and k0 + 1 of offset group o,
// with their head weights w[o, f, k] for f < FMAX (16 or 32) in registers,
// so each staged feature feeds two multiply-adds; a head wider than 32 reads
// the rest of its weights through L1 and stages the feature channels past
// the prefetched ones without prefetch.
//
// The head dot is the plain version's ordered f32 sum over f = 0..F-1. With
// bf16 features and weights given in bf16 (q.fuse, set by the host from the
// dtypes) every product x * w has at most 16 significant bits and is exact
// in f32, so fmaf rounds where __fadd_rn(d, __fmul_rn(x, w)) does: the
// kFma instances fuse, the others do not. Both equal the plain PyTorch
// version bit for bit, with one exception: a product whose lowest bit lies
// below 2^-149 (under f32's normal range, |x * w| < 2^-126 or so) is
// rounded by the unfused form and not by fmaf, so the dot may then differ
// by a few units of 2^-149.
//
// What bounds it on an H100 (80GB HBM3, 700 W): instruction issue, not
// bytes. At the main path's call it takes about 1.7 ms, a quarter of its
// byte bound (0.454 ms); with every load and store switched off it keeps
// most of that time (tools/ablate_s2d_accumulate.py). Tensor cores would sum
// the head dot in another order and lose the bit-exact check.
#include "common.cuh"

// Parts of the kernel that tools/ablate_s2d_accumulate.py switches off with
// -D<name>=1 to time the rest; such a build computes wrong values.
#ifndef FNN_ABLATE_MEMORY  // features, gaussian and accumulator pieces
#define FNN_ABLATE_MEMORY 0
#endif
#ifndef FNN_ABLATE_MATH  // the head dot and the accumulator update
#define FNN_ABLATE_MATH 0
#endif
#ifndef FNN_ABLATE_EPILOGUE  // the update's roundings (one plain add)
#define FNN_ABLATE_EPILOGUE 0
#endif

// Launch geometry, mirrored field for field by ops/s2d_accumulate.py
// _Geometry (the host computes it; see launch_plan there).
struct FnnS2dGeometry {
  int B, p0h, pyh, pzh, F, K, Yh, Zh, c8p;
  int row_base, y_lo, y_hi, seg, seg_lo, seg_hi;
  int lane_pairs, n_pass, piece_off, fb_off, gb_off, steps_off, segs_off;
  int smem, vec16, fvec, fuse;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 32;
constexpr int kMaxRegF = 32;  // head weights in registers: f < 32
constexpr int kFPad = 4;  // floats after each offset group's staged features
constexpr int kFirst = 1, kLast = 2;  // a step opens / closes its segment

struct TileArgs {
  int yh0[kMaxTiles];
  int zh0[kMaxTiles];
  float valid[kMaxTiles];
};

// f32 accumulator, the Pallas contract: acc += (dot + b) * g, for the two
// lanes of a thread at one z (a: the values read; lane 1 only when `two`)
__device__ __forceinline__ void fnn_update2(float* dst, float a0, float a1,
                                           float d0, float d1, float b0,
                                           float b1, float g, bool two) {
  dst[0] = __fadd_rn(a0, __fmul_rn(__fadd_rn(d0, b0), g));
  if (two) dst[1] = __fadd_rn(a1, __fmul_rn(__fadd_rn(d1, b1), g));
}

// f32 -> nearest-even bf16 -> f32 of two values with one conversion
__device__ __forceinline__ void fnn_round_bf16x2(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x = __low2float(h);
  y = __high2float(h);
}

// bf16 accumulator: the XLA accumulate_batch sequence op for op,
// y = bf16(bf16(dot) + b); c = bf16(f32(y) * g); acc = bf16(acc + c)
__device__ __forceinline__ void fnn_update2(__nv_bfloat16* dst, float a0,
                                           float a1, float d0, float d1,
                                           float b0, float b1, float g,
                                           bool two) {
  fnn_round_bf16x2(d0, d1);
  float y0 = __fadd_rn(d0, b0), y1 = __fadd_rn(d1, b1);
  fnn_round_bf16x2(y0, y1);
  float c0 = __fmul_rn(y0, g), c1 = __fmul_rn(y1, g);
  fnn_round_bf16x2(c0, c1);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fadd_rn(a0, c0), __fadd_rn(a1, c1));
  dst[0] = __low2bfloat16(r);
  if (two) dst[1] = __high2bfloat16(r);
}

// Block-cooperative copy of n elements from global to shared memory. With
// vec16 both addresses are 16-byte aligned and n * sizeof(T) is a multiple of
// 16: the copy is asynchronous (fnn_cp_async16, common.cuh); otherwise it is
// element by element and done on return.
template <typename T>
__device__ __forceinline__ void fnn_copy_in(T* smem, const T* gmem, int n,
                                            bool vec16) {
  if (vec16) {
    const int n16 = n * (int)sizeof(T) / 16;
    for (int v = threadIdx.x; v < n16; v += blockDim.x)
      fnn_cp_async16(reinterpret_cast<uint4*>(smem) + v,
                     reinterpret_cast<const uint4*>(gmem) + v);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) smem[e] = gmem[e];
  }
}

// Block-cooperative copy of n elements from shared to global memory, with
// 16-byte vectors under the same vec16 condition.
template <typename T>
__device__ __forceinline__ void fnn_copy_out(T* gmem, const T* smem, int n,
                                             bool vec16) {
  if (vec16) {
    const int n16 = n * (int)sizeof(T) / 16;
    for (int v = threadIdx.x; v < n16; v += blockDim.x)
      reinterpret_cast<uint4*>(gmem)[v] =
          reinterpret_cast<const uint4*>(smem)[v];
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) gmem[e] = smem[e];
  }
}

template <bool kFma>
__device__ __forceinline__ float fnn_madd(float x, float w, float d) {
  return kFma ? fmaf(x, w, d) : __fadd_rn(d, __fmul_rn(x, w));
}


// Features travel in runs of 8 consecutive z of one channel, as raw bits
// (bf16: one uint4; f32: two).
template <typename TF>
struct Run8 {
  uint4 u[sizeof(TF) / 2];
};

__device__ __forceinline__ void fnn_set_lane(Run8<__nv_bfloat16>& r, int e,
                                             __nv_bfloat16 v) {
  unsigned* w = reinterpret_cast<unsigned*>(&r.u[0]) + (e >> 1);
  const unsigned b = __bfloat16_as_ushort(v);
  *w = e & 1 ? (*w & 0xffffu) | (b << 16) : (*w & 0xffff0000u) | b;
}
__device__ __forceinline__ void fnn_set_lane(Run8<float>& r, int e, float v) {
  reinterpret_cast<unsigned*>(&r.u[0])[e] = __float_as_uint(v);
}

// the 8 values of a run as two float4 (z 0-3, 4-7)
__device__ __forceinline__ void fnn_unpack(const Run8<__nv_bfloat16>& r,
                                           float4& a, float4& b) {
  const uint4 u = r.u[0];  // bf16 = the high half of an f32
  a = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  b = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                  __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}
__device__ __forceinline__ void fnn_unpack(const Run8<float>& r, float4& a,
                                           float4& b) {
  a = *reinterpret_cast<const float4*>(&r.u[0]);
  b = *reinterpret_cast<const float4*>(&r.u[1]);
}

// Elements m .. m + 7 (m in 0..7, the same in every thread of a step) of
// the 16 bf16 in chunks (a, b).
__device__ __forceinline__ uint4 fnn_shift_run(uint4 a, uint4 b, int m) {
  const unsigned sh = (m & 1) * 16;
  unsigned p0, p1, p2, p3, p4;
  switch (m >> 1) {
    case 0: p0 = a.x; p1 = a.y; p2 = a.z; p3 = a.w; p4 = b.x; break;
    case 1: p0 = a.y; p1 = a.z; p2 = a.w; p3 = b.x; p4 = b.y; break;
    case 2: p0 = a.z; p1 = a.w; p2 = b.x; p3 = b.y; p4 = b.z; break;
    default: p0 = a.w; p1 = b.x; p2 = b.y; p3 = b.z; p4 = b.w; break;
  }
  return make_uint4(__funnelshift_r(p0, p1, sh), __funnelshift_r(p1, p2, sh),
                    __funnelshift_r(p2, p3, sh), __funnelshift_r(p3, p4, sh));
}

// This thread's run of channel c in step st: segment z 8 (t % (SEG / 8)) ..
// + 7 of tile st.x, zero outside the tile. With fvec (bf16 features, rows of
// whole 16-byte chunks) it comes from the one or two aligned chunks that
// hold it, whatever the tile's z-start (chunks outside the tile read as
// zeros); otherwise z by z.
template <typename TF, int SEG>
__device__ __forceinline__ void fnn_load_run(
    Run8<TF>& run, const TF* __restrict__ feats, const TileArgs& t, int4 st,
    int i, int Y, const FnnS2dGeometry& q, long long S, int c) {
  constexpr int kPer = SEG / 8;  // runs per channel in a segment
  const int k = st.x, zh0 = t.zh0[k];
  const long long row = ((long long)i * q.pyh + (Y - t.yh0[k])) * q.pzh;
  const int z8 = st.y + 8 * (threadIdx.x % kPer) - zh0;  // tile-local z
  const TF* src = feats + ((long long)k * 8 * q.F + c) * S + row;
  if constexpr (sizeof(TF) == 2) {
    if (q.fvec) {
      const int za = z8 & ~7, m = z8 - za;  // the run's first aligned chunk
      if constexpr (FNN_ABLATE_MEMORY) {
        run.u[0] = make_uint4(c, z8, m, k);
        return;
      }
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 a = za >= 0 && za < q.pzh
                          ? __ldg(reinterpret_cast<const uint4*>(src + za))
                          : zero;
      if (m == 0) {
        run.u[0] = a;
      } else {
        const uint4 b =
            za + 8 >= 0 && za + 8 < q.pzh
                ? __ldg(reinterpret_cast<const uint4*>(src + za + 8))
                : zero;
        run.u[0] = fnn_shift_run(a, b, m);
      }
      return;
    }
  }
  const int zend = min(q.pzh, q.Zh - zh0);  // the tile's z-span, clipped
#pragma unroll
  for (int e = 0; e < 8; ++e)
    fnn_set_lane(run, e, z8 + e >= 0 && z8 + e < zend ? src[z8 + e] : TF(0.f));
}

// Step st's operands for this thread. Thread t loads run r of channel
// c = t / (SEG / 8) + r * (kThreads / (SEG / 8)) (fnn_load_run), and
// threads t < 2 SEG load gaussian z = t / 2, offsets 4 (t % 2) .. + 3 as
// one float4, times valid[k]; zero outside tile k.
template <typename TF, int SEG, int kRuns>
__device__ __forceinline__ void fnn_load_step(
    Run8<TF>* pf, float4& pg, const TF* __restrict__ feats,
    const float* __restrict__ g, const TileArgs& t, int4 st, int i, int Y,
    const FnnS2dGeometry& q, long long S) {
  constexpr int kPer = SEG / 8;
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int c = threadIdx.x / kPer + r * (kThreads / kPer);
    if (c < 8 * q.F) fnn_load_run<TF, SEG>(pf[r], feats, t, st, i, Y, q, S, c);
  }
  if (threadIdx.x < 2 * SEG) {
    const int k = st.x, zh0 = t.zh0[k];
    const long long row = ((long long)i * q.pyh + (Y - t.yh0[k])) * q.pzh;
    const int zg = st.y + threadIdx.x / 2 - zh0;
    const float v = t.valid[k];
    if (zg >= 0 && zg < min(q.pzh, q.Zh - zh0)) {
      const float4 x =
          FNN_ABLATE_MEMORY
              ? make_float4(zg, 1.f, 2.f, (float)row)
              : __ldg(reinterpret_cast<const float4*>(
                    g + (row + zg) * 8 + 4 * (threadIdx.x & 1)));
      pg = make_float4(__fmul_rn(x.x, v), __fmul_rn(x.y, v),
                       __fmul_rn(x.z, v), __fmul_rn(x.w, v));
    } else {
      pg = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Head dots of four consecutive z (fo: the group's staged features at the
// quad, f-stride SEG) for the thread's two lanes; kAllF: F >= FMAX, so the
// register loop has no bound test and its loads can run ahead; kWide:
// F > FMAX, f = FMAX .. F-1 follow with their weights read through L1 from
// wt0[f K], wt1[f K]. The features are read as four broadcast scalars, not
// one float4: measured faster on the H100 (a warp spans two offset groups,
// so each read serves two addresses).
template <int SEG, int FMAX, bool kFma, bool kAllF, bool kWide>
__device__ __forceinline__ void fnn_head_quad(
    const float* fo, int F, const float* w0, const float* w1,
    const float* __restrict__ wt0, const float* __restrict__ wt1, int K,
    float* d0, float* d1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d0[j] = __fmul_rn(fo[j], w0[0]);
    d1[j] = __fmul_rn(fo[j], w1[0]);
  }
#pragma unroll
  for (int f = 1; f < FMAX; ++f) {
    if (kAllF || f < F) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = fo[f * SEG + j];
        d0[j] = fnn_madd<kFma>(x, w0[f], d0[j]);
        d1[j] = fnn_madd<kFma>(x, w1[f], d1[j]);
      }
    }
  }
  if constexpr (kWide) {
    for (int f = FMAX; f < F; ++f) {
      const float v0 = __ldg(wt0 + f * K), v1 = __ldg(wt1 + f * K);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = fo[f * SEG + j];
        d0[j] = fnn_madd<kFma>(x, v0, d0[j]);
        d1[j] = fnn_madd<kFma>(x, v1, d1[j]);
      }
    }
  }
}

template <int SEG, int FMAX, bool kFma>
__device__ __forceinline__ void fnn_head(const float* fo, int F,
                                         const float* w0, const float* w1,
                                         const float* wt0, const float* wt1,
                                         int K, float* d0, float* d1) {
  if (F == FMAX)
    fnn_head_quad<SEG, FMAX, kFma, true, false>(fo, F, w0, w1, wt0, wt1, K,
                                                d0, d1);
  else if (F < FMAX)
    fnn_head_quad<SEG, FMAX, kFma, false, false>(fo, F, w0, w1, wt0, wt1, K,
                                                 d0, d1);
  else if constexpr (FMAX == kMaxRegF)
    fnn_head_quad<SEG, FMAX, kFma, true, true>(fo, F, w0, w1, wt0, wt1, K,
                                               d0, d1);
}

// SEG: z voxels of a piece (16; 8 where 16 would not fit in shared memory).
// FMAX: the register budget for head weights (F <= 16, or 32 for any wider
// head); the 32 variant gives up the third resident block for its 64 weight
// registers. kFma: the head dot fuses its multiply-adds (bf16 features and
// weights only). A per-thread runtime choice spilled at the 80-register
// cap and measured about 10% slower on an H100.
template <typename TF, typename TA, int SEG, int FMAX, bool kFma>
__global__ void __launch_bounds__(kThreads, FMAX <= 16 ? 3 : 1)
s2d_accumulate_kernel(TA* __restrict__ acc, const TF* __restrict__ feats,
                      const float* __restrict__ g,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const __grid_constant__ TileArgs tiles,
                      const __grid_constant__ FnnS2dGeometry q) {
  constexpr int kPer = SEG / 8;  // 8-z runs per channel in a segment
  constexpr int kRuns = (FMAX * 8 * kPer + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_steps, n_segs;
  const int Y = q.y_lo + blockIdx.x, i = blockIdx.y;
  int4* steps = reinterpret_cast<int4*>(smem + q.steps_off);
  int2* segs = reinterpret_cast<int2*>(smem + q.segs_off);
  if (threadIdx.x < 32) {  // warp 0 lists the block's steps in order
    const int t = threadIdx.x;
    const bool cover = t < q.B && tiles.valid[t] != 0.f &&
                       Y >= tiles.yh0[t] && Y < tiles.yh0[t] + q.pyh;
    const int z0 = cover ? tiles.zh0[t] : 0;
    int n = 0, j = 0;
    for (int s = q.seg_lo; s < q.seg_hi; ++s) {
      const int s0 = s * SEG, s1 = min(s0 + SEG, q.Zh);
      const bool hit = cover && z0 < s1 && z0 + q.pzh > s0;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (!m) continue;
      const int pa = __reduce_min_sync(0xffffffffu, hit ? max(s0, z0) : s1);
      const int pb =
          __reduce_max_sync(0xffffffffu, hit ? min(s1, z0 + q.pzh) : s0);
      if (hit)
        steps[n + __popc(m & ((1u << t) - 1u))] = make_int4(
            t, s0, j,
            (t == __ffs(m) - 1 ? kFirst : 0) |
                (t == 31 - __clz(m) ? kLast : 0));
      if (t == 0) segs[j] = make_int2(pa, pb);
      n += __popc(m);
      ++j;
    }
    if (t == 0) {
      n_steps = n;
      n_segs = j;
    }
  }
  __syncthreads();
  const int ns = n_steps;
  if (ns == 0) return;  // block-uniform: no tile adds to this line

  const long long S = (long long)q.p0h * q.pyh * q.pzh;
  float* fbs = reinterpret_cast<float*>(smem + q.fb_off);  // 2 x (8, F, SEG)
  float* gbs = reinterpret_cast<float*>(smem + q.gb_off);  // 2 x (SEG, 8)
  const int ostride = q.F * SEG + kFPad;  // pad: two groups, two bank sets
  const int fb_size = 8 * ostride;
  const int phys = (q.row_base + i) % q.p0h;
  TA* line = acc + ((long long)phys * q.Yh + Y) * q.Zh * q.c8p;
  const bool vec16 = q.vec16 != 0;
  const int lf = __popc(q.F - 1);  // log2 F where F is a power of two
  const bool f_pow2 = (q.F & (q.F - 1)) == 0;
  Run8<TF> pf[kRuns];
  float4 pg;

  auto piece_buf = [&](int j) {  // segment j's piece: ring of three buffers
    return reinterpret_cast<TA*>(smem + (j % 3) * q.piece_off);
  };
  auto piece_copy_in = [&](int j) {
    const int2 p = segs[j];
    if (!FNN_ABLATE_MEMORY)
      fnn_copy_in(piece_buf(j), line + p.x * q.c8p, (p.y - p.x) * q.c8p,
                  vec16);
  };
  auto piece_copy_out = [&](int j) {
    const int2 p = segs[j];
    if (!FNN_ABLATE_MEMORY)
      fnn_copy_out(line + p.x * q.c8p, piece_buf(j), (p.y - p.x) * q.c8p,
                   vec16);
  };
  auto load = [&](int n) {
    fnn_load_step<TF, SEG, kRuns>(pf, pg, feats, g, tiles, steps[n], i, Y, q,
                                  S);
  };
  auto put = [&](float* fb, int c, const Run8<TF>& run) {  // run -> staged
    const int og = f_pow2 ? c >> lf : c / q.F;
    float4* dst = reinterpret_cast<float4*>(
        fb + og * ostride + (c - og * q.F) * SEG + 8 * (threadIdx.x % kPer));
    fnn_unpack(run, dst[0], dst[1]);
  };
  auto stage = [&](int n) {  // step n's operands -> buffers n % 2
    float* fb = fbs + (n & 1) * fb_size;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int c = threadIdx.x / kPer + r * (kThreads / kPer);
      if (c < 8 * q.F) put(fb, c, pf[r]);
    }
    if constexpr (FMAX == kMaxRegF) {
      // a head wider than FMAX: the channels past the prefetched runs
      for (int c = kRuns * (kThreads / kPer) + threadIdx.x / kPer;
           c < 8 * q.F; c += kThreads / kPer) {
        Run8<TF> run;
        fnn_load_run<TF, SEG>(run, feats, tiles, steps[n], i, Y, q, S, c);
        put(fb, c, run);
      }
    }
    if (threadIdx.x < 2 * SEG)
      reinterpret_cast<float4*>(gbs + (n & 1) * SEG * 8)[threadIdx.x] = pg;
  };

  for (int pass = 0; pass < q.n_pass; ++pass) {
    const int v = pass * kThreads + threadIdx.x;  // lane pair
    const int o = v / q.lane_pairs;
    const int k0 = 2 * (v - o * q.lane_pairs);
    const bool live = o < 8;  // threads past the last pair only stage
    const bool two = live && k0 + 1 < q.K;
    float w0[FMAX], w1[FMAX];
#pragma unroll
    for (int f = 0; f < FMAX; ++f) {
      w0[f] = live && f < q.F ? __ldg(w + (o * q.F + f) * q.K + k0) : 0.f;
      w1[f] = two && f < q.F ? __ldg(w + (o * q.F + f) * q.K + k0 + 1) : 0.f;
    }
    const float b0 = live ? __ldg(bias + o * q.K + k0) : 0.f;
    const float b1 = two ? __ldg(bias + o * q.K + k0 + 1) : 0.f;
    // w[o, f, k0 (+ 1)] for f >= FMAX, read through L1 by a wider head (a
    // thread without lane 1 reads lane 0's, and stores no lane-1 result)
    const float* wt0 = w + (live ? o * q.F * q.K + k0 : 0);
    const float* wt1 = two ? wt0 + 1 : wt0;

    // prologue: segment 0's piece in flight, step 0 staged, step 1 in flight
    __syncthreads();  // the previous pass's pieces are back in global memory
    piece_copy_in(0);
    load(0);
    stage(0);
    if (ns > 1) load(1);
    int pending = -1;  // a finished segment whose piece is not stored yet
    for (int n = 0; n < ns; ++n) {
      const int4 st = steps[n];
      if (st.w & kFirst) fnn_cp_async_wait_all();  // segment st.z's piece
      // one barrier a step: step n's piece and stage are visible, and
      // step n - 1's math is done with its piece and feature buffer
      __syncthreads();
      if (pending >= 0) piece_copy_out(pending);
      pending = -1;
      // the next segment's piece: its ring slot last held segment
      // st.z - 2, stored at least one barrier ago
      if ((st.w & kFirst) && st.z + 1 < n_segs) piece_copy_in(st.z + 1);
      if (n + 1 < ns) stage(n + 1);
      if (n + 2 < ns) load(n + 2);  // in flight while this step's math runs
      if (live && !FNN_ABLATE_MATH) {
        const int k = st.x, s0 = st.y;
        const int za = max(s0, tiles.zh0[k]) - s0;
        const int zb = min(min(s0 + SEG, q.Zh), tiles.zh0[k] + q.pzh) - s0;
        const float* fo = fbs + (n & 1) * fb_size + o * ostride;
        const float* gb = gbs + (n & 1) * SEG * 8 + o;
        TA* dst0 = piece_buf(st.z) + (s0 - segs[st.z].x) * q.c8p + o * q.K +
                   k0;
        for (int zq = za & ~3; zq < zb; zq += 4) {
          float d0[4], d1[4], a0[4], a1[4];
          fnn_head<SEG, FMAX, kFma>(fo + zq, q.F, w0, w1, wt0, wt1, q.K, d0,
                                    d1);
          // all of the quad's accumulator reads before any write: the
          // compiler cannot tell the eight elements apart, and would chain
          // each read-modify-write behind the previous one
          TA* dq = dst0 + zq * q.c8p;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = zq + j >= za && zq + j < zb;
            a0[j] = in ? fnn_to_float(dq[j * q.c8p]) : 0.f;
            a1[j] = in && two ? fnn_to_float(dq[j * q.c8p + 1]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (zq + j < za || zq + j >= zb) continue;
            if constexpr (FNN_ABLATE_EPILOGUE)
              dq[j * q.c8p] =
                  (TA)(a0[j] + d0[j] + d1[j] + a1[j] + gb[(zq + j) * 8]);
            else
              fnn_update2(dq + j * q.c8p, a0[j], a1[j], d0[j], d1[j], b0,
                          b1, gb[(zq + j) * 8], two);
          }
        }
      }
      if (st.w & kLast) pending = st.z;
    }
    __syncthreads();
    piece_copy_out(pending);
  }
}

template <typename TF, typename TA, int SEG, int FMAX, bool kFma>
int launch(void* acc, const void* feats, const float* g, const float* w,
           const float* bias, const TileArgs& tiles, const FnnS2dGeometry& q,
           cudaStream_t st) {
  auto kernel = s2d_accumulate_kernel<TF, TA, SEG, FMAX, kFma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(q.y_hi - q.y_lo), (unsigned)q.p0h);
  kernel<<<grid, kThreads, q.smem, st>>>(static_cast<TA*>(acc),
                                         static_cast<const TF*>(feats), g, w,
                                         bias, tiles, q);
  return (int)cudaGetLastError();
}

template <typename TF, typename TA, bool kFma>
int launch_shape(void* acc, const void* feats, const float* g, const float* w,
                 const float* bias, const TileArgs& tiles,
                 const FnnS2dGeometry& q, cudaStream_t st) {
#define FNN_LAUNCH(SEG, FMAX) \
  return launch<TF, TA, SEG, FMAX, kFma>(acc, feats, g, w, bias, tiles, q, st)
  if (q.seg == 16) {
    if (q.F <= 16) FNN_LAUNCH(16, 16);
    FNN_LAUNCH(16, kMaxRegF);
  }
  if (q.F <= 16) FNN_LAUNCH(8, 16);
  FNN_LAUNCH(8, kMaxRegF);
#undef FNN_LAUNCH
}

}  // namespace

extern "C" int fnn_s2d_accumulate(void* acc, int acc_dtype, const void* feats,
                                  int feat_dtype, const float* g,
                                  const float* w, const float* bias,
                                  const int* yh0, const int* zh0,
                                  const float* valid,
                                  const FnnS2dGeometry* geom, void* stream) {
  const FnnS2dGeometry q = *geom;
  if (q.B < 1 || q.B > kMaxTiles || q.y_hi <= q.y_lo ||
      q.seg_hi <= q.seg_lo || q.F < 1 || q.n_pass < 1 ||
      (q.seg != 16 && q.seg != 8) || (q.fuse && feat_dtype != FNN_BF16))
    return (int)cudaErrorInvalidValue;
  TileArgs tiles;
  for (int t = 0; t < q.B; ++t) {
    tiles.yh0[t] = yh0[t];
    tiles.zh0[t] = zh0[t];
    tiles.valid[t] = valid[t];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FNN_LAUNCH(TF, TA, FMA) \
  return launch_shape<TF, TA, FMA>(acc, feats, g, w, bias, tiles, q, st)
  if (feat_dtype == FNN_BF16) {
    if (acc_dtype == FNN_BF16) {
      if (q.fuse) FNN_LAUNCH(__nv_bfloat16, __nv_bfloat16, true);
      FNN_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
    }
    if (q.fuse) FNN_LAUNCH(__nv_bfloat16, float, true);
    FNN_LAUNCH(__nv_bfloat16, float, false);
  }
  if (acc_dtype == FNN_BF16) FNN_LAUNCH(float, __nv_bfloat16, false);
  FNN_LAUNCH(float, float, false);
#undef FNN_LAUNCH
}
