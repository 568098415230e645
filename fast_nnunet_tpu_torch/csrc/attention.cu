// Kernels F and G: Primus's attention, fused, forward (F) and backward (G),
// FlashAttention-2 style: online softmax, no T x T tensor in device memory.
// The JAX package has no Pallas kernel here (its EvaAttention is XLA einsums
// and a softmax); this is a kernel of the port alone, added because plain
// attention keeps f32 scores and probabilities of (B, H, T, T) per layer for
// the backward (~15.4 GB a layer for Primus M at a 160^3 patch, 8,000
// tokens), which no card holds over 16 layers. The contract, the plain
// version and the autograd Function are in ops/attention.py.
//
// Per batch row b and head h, with q already scaled by the head's
// temperature and q, k unit-norm and rotated (outside, in torch):
//   S = q k^T (bf16 operands, f32 sums), P = softmax(S) by rows in f32,
//   O = P V with P rounded to bf16, the sum in f32, O rounded to bf16;
//   lse = the rows' log-sum-exp (natural log, f32).
// Backward, from lse: P = exp(S - lse), D = rowsum(dO o O),
//   dV = P^T dO, dP = dO V^T, dS = P o (dP - D), dQ = dS K, dK = dS^T Q,
// with P and dS rounded to bf16 where they enter a product.
//
// Bound on the card: bf16 tensor-core FLOPs. F does 4 B H T^2 72 (QK^T and
// PV) against (3 + 1) B T H 72 x 2 bytes of q, k, v and O: at T = 8,000 some
// 4,600 operations a byte, far above the H100's ridge (~295). G's useful work
// is 10 B H T^2 72 (five products); it runs two kernels, dq (QK^T, dO V^T,
// dS K) and dkdv (K Q^T, V dO^T, P^T dO, dS^T Q), so it does 14 B H T^2 72
// and recomputes two products rather than accumulate dQ with atomics. The
// design for that bound: mma.sync m16n8k16 (bf16 in, f32 accumulators) on
// fragments read with ldmatrix from shared memory; a block of W warps owns
// 16 W rows (16 a warp: F 8 warps, G's passes 4, the fastest of 4 and 8 on
// an H100 at Primus M's 160^3 shape; results do not depend on it), streams
// the other operand's 64-row tiles through a double buffer of cp.async
// copies, so the next tile's load overlaps the current tile's products;
// softmax statistics stay in registers.
//
// Shapes: head dim 72 is not a multiple of 16. Tiles live in shared memory
// as rows of 88 bf16 (176 bytes: ldmatrix's 8 rows fall on distinct banks);
// columns 72-79 are zeroed once, so the QK^T (and dO V^T) depth runs to 80
// in five k16 steps; products of width 72 run as nine n8 tiles. T need not be
// a multiple of 64: rows past T are loaded as zeros (cp.async's zero fill),
// scores of keys past T are set to -inf, and rows past T are not stored.
//
// Layouts: q, k, v are (B, T, H, 72) views with element strides (batch,
// token, head), the last dim contiguous, 16-byte aligned rows (v is read in
// place from the qkv projection's (B, T, 3, H, 72) output). O, dO, dQ, dK,
// dV are contiguous (B, T, H, 72); lse and D are (B, H, T) f32.
#include <math.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 72;                // head dim
constexpr int kSteps = 5;             // k16 steps of the padded depth 80
constexpr int kRow = 88;              // shared-memory row stride (bf16)
constexpr int kChunks = kD * 2 / 16;  // 16-byte chunks a row
// A block of W warps owns 16 W rows (kW* below) and streams tiles of the
// other operand's rows through its double buffer.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct View {  // a (B, T, H, 72) view
  const bf16* p;
  long long sb, st, sh;
  __device__ const bf16* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

struct Args {
  View q, k, v;
  const bf16* o;    // forward output (backward only)
  const bf16* dout;
  bf16* out;        // O (forward) or dQ (backward, dq kernel)
  bf16* dk;
  bf16* dv;
  float* lse;       // (B, H, T)
  float* delta;     // (B, H, T), written by the dq kernel
  int T, H;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp16(bf16* s, const bf16* g, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// rows row0 .. row0 + rows - 1 of one head's (T, 72) view into shared rows
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long st, int row0, int rows,
                                          int T) {
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const int row = row0 + r;
    const bool ok = row < T;
    cp16(s + r * kRow + ch * 8, ok ? g + row * st + ch * 8 : g, ok);
  }
}

// columns 72-79 of `rows` shared rows set to zero (the padded depth)
__device__ __forceinline__ void zero_pad(bf16* s, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    *reinterpret_cast<uint4*>(s + r * kRow + kD) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm2t(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The A fragment (16 rows x 16 columns from row r0, column k0) of a shared
// tile stored [row][column].
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* s,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(a, s + (r0 + (lane & 15)) * kRow + k0 + (lane >> 4) * 8);
}

// acc[n] (16 x N, N = 8 x NT) += A (16 x 80, five k16 steps in `a`) times
// the transpose of the shared tile `s` (N rows x 80): S = Q K^T and its kin.
template <int NT>
__device__ __forceinline__ void mul_nt(float (&acc)[NT][4],
                                       const unsigned (&a)[kSteps][4],
                                       const bf16* s) {
  const int lane = threadIdx.x & 31;
  const int rn = (lane & 7) + ((lane >> 4) << 3), ck = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldsm4(b, s + (np * 16 + rn) * kRow + kk * 16 + ck);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x 72, nine n8 tiles) += A (16 x 16 KT, KT k16 steps in `a`) times
// the shared tile `s` (16 KT rows x 72): O = P V and its kin.
template <int KT>
__device__ __forceinline__ void mul_nn(float (&acc)[9][4],
                                       const unsigned (&a)[KT][4],
                                       const bf16* s) {
  const int lane = threadIdx.x & 31;
  const int rk = (lane & 7) + ((lane >> 3) & 1) * 8, cn = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const bf16* row = s + (kk * 16 + rk) * kRow;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm4t(b, row + np * 16 + cn);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
    unsigned b[2];
    ldsm2t(b, row + 64);
    mma(acc[8], a[kk], b[0], b[1]);
  }
}

// accumulator tiles (16 x 16 KT) -> bf16 A fragments (KT k16 steps)
template <int KT>
__device__ __forceinline__ void to_frags(unsigned (&a)[KT][4],
                                         const float (&c)[2 * KT][4]) {
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    a[nt / 2][(nt & 1) * 2] = pack(c[nt][0], c[nt][1]);
    a[nt / 2][(nt & 1) * 2 + 1] = pack(c[nt][2], c[nt][3]);
  }
}

// scores of keys at or past T set to -inf (a tile of keys from key0)
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int key0,
                                          int T) {
  if (key0 + NT * 8 <= T) return;
  const int c = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + nt * 8 + (e & 1) >= T) s[nt][e] = -INFINITY;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a 16 x 72 accumulator, each row scaled, stored as bf16 rows r < T of a
// contiguous (B, T, H, 72) tensor; r0 the warp's first row
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[9][4],
                                           float s0, float s1, int b, int h,
                                           int r0, int T, int H) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + (lane >> 2), rb = ra + 8, c = 2 * (lane & 3);
  bf16* pa = out + ((long long)b * T + ra) * H * kD + h * kD + c;
  bf16* pb = pa + 8LL * H * kD;
#pragma unroll
  for (int nt = 0; nt < 9; ++nt) {
    if (ra < T)
      *reinterpret_cast<unsigned*>(pa + nt * 8) =
          pack(acc[nt][0] * s0, acc[nt][1] * s0);
    if (rb < T)
      *reinterpret_cast<unsigned*>(pb + nt * 8) =
          pack(acc[nt][2] * s1, acc[nt][3] * s1);
  }
}

// ----------------------------------------------------------------- kernel F
template <int kWarps, int kBc>
__global__ void __launch_bounds__(32 * kWarps)
    attention_fwd_kernel(const Args a) {
  constexpr int kTile = 16 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * kRow;      // two buffers of kBc rows
  bf16* sV = sK + 2 * kBc * kRow;    // two buffers of kBc rows
  constexpr int NT = kBc / 8, KT = kBc / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T = a.T, H = a.H;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const bf16* gk = a.k.head(b, h);
  const bf16* gv = a.v.head(b, h);

  zero_pad(sQ, kTile + 4 * kBc);
  load_tile(sQ, a.q.head(b, h), a.q.st, q0, kTile, T);
  load_tile(sK, gk, a.k.st, 0, kBc, T);
  load_tile(sV, gv, a.v.st, 0, kBc, T);
  cp_commit();
  fnn_cp_async_wait_all();
  __syncthreads();

  unsigned qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) frag_a(qf[kk], sQ, warp * 16, kk * 16);

  float o[9][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int nkv = (T + kBc - 1) / kBc;
  for (int j = 0; j < nkv; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkv) {
      load_tile(sK + (buf ^ 1) * kBc * kRow, gk, a.k.st, (j + 1) * kBc, kBc,
                T);
      load_tile(sV + (buf ^ 1) * kBc * kRow, gv, a.v.st, (j + 1) * kBc, kBc,
                T);
      cp_commit();
    }
    float s[NT][4] = {};
    mul_nt<NT>(s, qf, sK + buf * kBc * kRow);
    mask_keys<NT>(s, j * kBc, T);
    // online softmax, in log2 units
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= kLog2e;
      x0 = fmaxf(x0, fmaxf(s[nt][0], s[nt][1]));
      x1 = fmaxf(x1, fmaxf(s[nt][2], s[nt][3]));
    }
    x0 = quad_max(x0);
    x1 = quad_max(x1);
    const float al0 = exp2f(m0 - x0), al1 = exp2f(m1 - x1);
    m0 = x0;
    m1 = x1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nt = 0; nt < 9; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - x0);
      s[nt][1] = exp2f(s[nt][1] - x0);
      s[nt][2] = exp2f(s[nt][2] - x1);
      s[nt][3] = exp2f(s[nt][3] - x1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    unsigned pf[KT][4];
    to_frags<KT>(pf, s);
    mul_nn<KT>(o, pf, sV + buf * kBc * kRow);
    fnn_cp_async_wait_all();
    __syncthreads();
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = q0 + warp * 16;
  store_rows(a.out, o, 1.f / l0, 1.f / l1, b, h, r0, T, H);
  if ((lane & 3) == 0) {
    const int ra = r0 + (lane >> 2), rb = ra + 8;
    float* lse = a.lse + ((long long)b * H + h) * T;
    if (ra < T) lse[ra] = (m0 + log2f(l0)) * kLn2;
    if (rb < T) lse[rb] = (m1 + log2f(l1)) * kLn2;
  }
}

// ------------------------------------------------------- kernel G: dq pass
// D = rowsum(dO o O) for its rows (written for the dkdv pass), then
// dQ = sum over key tiles of dS K, P recomputed from lse.
template <int kWarps, int kBc>
__global__ void __launch_bounds__(32 * kWarps)
    attention_bwd_dq_kernel(const Args a) {
  constexpr int kTile = 16 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kTile * kRow;      // dO
  bf16* sK = sO + kTile * kRow;      // two buffers of kBc rows
  bf16* sV = sK + 2 * kBc * kRow;    // two buffers of kBc rows
  float* sL = reinterpret_cast<float*>(sV + 2 * kBc * kRow);  // lse, log2
  float* sD = sL + kTile;
  constexpr int NT = kBc / 8, KT = kBc / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T = a.T, H = a.H;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const bf16* gk = a.k.head(b, h);
  const bf16* gv = a.v.head(b, h);
  const long long rs = (long long)H * kD;  // token stride of O, dO
  const bf16* go = a.o + (long long)b * T * rs + h * kD;
  const bf16* gdo = a.dout + (long long)b * T * rs + h * kD;
  float* lse = a.lse + ((long long)b * H + h) * T;
  float* delta = a.delta + ((long long)b * H + h) * T;

  zero_pad(sQ, 2 * kTile + 4 * kBc);
  load_tile(sQ, a.q.head(b, h), a.q.st, q0, kTile, T);
  load_tile(sO, gdo, rs, q0, kTile, T);
  load_tile(sK, gk, a.k.st, 0, kBc, T);
  load_tile(sV, gv, a.v.st, 0, kBc, T);
  cp_commit();
  // D of the warp's 16 rows, from O and dO in device memory
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < T) {
      for (int c = lane; c < kD; c += 32)
        acc += __bfloat162float(gdo[row * rs + c]) *
               __bfloat162float(go[row * rs + c]);
    }
    acc = fnn_warp_sum(acc);
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = row < T ? lse[row] * kLog2e : 0.f;
      if (row < T) delta[row] = acc;
    }
  }
  fnn_cp_async_wait_all();
  __syncthreads();

  unsigned qf[kSteps][4], df[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    frag_a(qf[kk], sQ, warp * 16, kk * 16);
    frag_a(df[kk], sO, warp * 16, kk * 16);
  }
  const int ra = warp * 16 + (lane >> 2);
  const float L0 = sL[ra], L1 = sL[ra + 8], D0 = sD[ra], D1 = sD[ra + 8];

  float dq[9][4] = {};
  const int nkv = (T + kBc - 1) / kBc;
  for (int j = 0; j < nkv; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkv) {
      load_tile(sK + (buf ^ 1) * kBc * kRow, gk, a.k.st, (j + 1) * kBc, kBc,
                T);
      load_tile(sV + (buf ^ 1) * kBc * kRow, gv, a.v.st, (j + 1) * kBc, kBc,
                T);
      cp_commit();
    }
    const bf16* Ks = sK + buf * kBc * kRow;
    float s[NT][4] = {}, dp[NT][4] = {};
    mul_nt<NT>(s, qf, Ks);
    mask_keys<NT>(s, j * kBc, T);
    mul_nt<NT>(dp, df, sV + buf * kBc * kRow);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(fmaf(s[nt][0], kLog2e, -L0)) * (dp[nt][0] - D0);
      s[nt][1] = exp2f(fmaf(s[nt][1], kLog2e, -L0)) * (dp[nt][1] - D0);
      s[nt][2] = exp2f(fmaf(s[nt][2], kLog2e, -L1)) * (dp[nt][2] - D1);
      s[nt][3] = exp2f(fmaf(s[nt][3], kLog2e, -L1)) * (dp[nt][3] - D1);
    }
    unsigned sf[KT][4];
    to_frags<KT>(sf, s);
    mul_nn<KT>(dq, sf, Ks);
    fnn_cp_async_wait_all();
    __syncthreads();
  }
  store_rows(a.out, dq, 1.f, 1.f, b, h, q0 + warp * 16, T, H);
}

// ----------------------------------------------------- kernel G: dkdv pass
// For 64 keys: dV = sum over query tiles of P^T dO, dK of dS^T Q, with the
// scores computed transposed (keys as rows), P from lse, D from the dq pass.
template <int kWarps, int kBr>
__global__ void __launch_bounds__(32 * kWarps)
    attention_bwd_dkdv_kernel(const Args a) {
  constexpr int kTile = 16 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * kRow;
  bf16* sQ = sV + kTile * kRow;      // two buffers of kBr rows
  bf16* sO = sQ + 2 * kBr * kRow;    // dO, two buffers of kBr rows
  float* sL = reinterpret_cast<float*>(sO + 2 * kBr * kRow);  // 2 x kBr
  float* sD = sL + 2 * kBr;                                   // 2 x kBr
  constexpr int NT = kBr / 8, KT = kBr / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T = a.T, H = a.H;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const bf16* gq = a.q.head(b, h);
  const long long rs = (long long)H * kD;
  const bf16* gdo = a.dout + (long long)b * T * rs + h * kD;
  const float* lse = a.lse + ((long long)b * H + h) * T;
  const float* delta = a.delta + ((long long)b * H + h) * T;

  // lse (log2 units; +inf past T, so P is 0 there) and D of a query tile
  auto load_stats = [&](int buf, int row0) {
    for (int i = threadIdx.x; i < kBr; i += blockDim.x) {
      const int row = row0 + i;
      sL[buf * kBr + i] = row < T ? lse[row] * kLog2e : INFINITY;
      sD[buf * kBr + i] = row < T ? delta[row] : 0.f;
    }
  };

  zero_pad(sK, 2 * kTile + 4 * kBr);
  load_tile(sK, a.k.head(b, h), a.k.st, k0, kTile, T);
  load_tile(sV, a.v.head(b, h), a.v.st, k0, kTile, T);
  load_tile(sQ, gq, a.q.st, 0, kBr, T);
  load_tile(sO, gdo, rs, 0, kBr, T);
  cp_commit();
  load_stats(0, 0);
  fnn_cp_async_wait_all();
  __syncthreads();

  float dk[9][4] = {}, dv[9][4] = {};
  const int c = 2 * (lane & 3);
  const int nq = (T + kBr - 1) / kBr;
  for (int i = 0; i < nq; ++i) {
    const int buf = i & 1;
    if (i + 1 < nq) {
      load_tile(sQ + (buf ^ 1) * kBr * kRow, gq, a.q.st, (i + 1) * kBr, kBr,
                T);
      load_tile(sO + (buf ^ 1) * kBr * kRow, gdo, rs, (i + 1) * kBr, kBr, T);
      cp_commit();
      load_stats(buf ^ 1, (i + 1) * kBr);
    }
    const bf16* Qs = sQ + buf * kBr * kRow;
    const bf16* Os = sO + buf * kBr * kRow;
    const float* L = sL + buf * kBr;
    const float* Dl = sD + buf * kBr;
    unsigned af[kSteps][4];
    float p[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) frag_a(af[kk], sK, warp * 16, kk * 16);
    mul_nt<NT>(p, af, Qs);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) frag_a(af[kk], sV, warp * 16, kk * 16);
    mul_nt<NT>(dp, af, Os);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int q = nt * 8 + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qe = q + (e & 1);
        p[nt][e] = exp2f(fmaf(p[nt][e], kLog2e, -L[qe]));
        dp[nt][e] = p[nt][e] * (dp[nt][e] - Dl[qe]);
      }
    }
    unsigned pf[KT][4];
    to_frags<KT>(pf, p);
    mul_nn<KT>(dv, pf, Os);
    to_frags<KT>(pf, dp);
    mul_nn<KT>(dk, pf, Qs);
    fnn_cp_async_wait_all();
    __syncthreads();
  }
  store_rows(a.dk, dk, 1.f, 1.f, b, h, k0 + warp * 16, T, H);
  store_rows(a.dv, dv, 1.f, 1.f, b, h, k0 + warp * 16, T, H);
}

// warps a block (16 rows each) and the streamed tile's rows, per kernel:
// on an H100 at (2, 8000, 12, 72) F takes 1.83 ms with 8 warps against 2.08
// with 4; G 6.17 ms with 4 and 4, 6.33 with 8 in the dq pass, 6.34 with 8 in
// the dkdv pass, 6.48 with 32-row query tiles there (bit-equal results)
constexpr int kWFwd = 8, kBcFwd = 64;
constexpr int kWDq = 4, kBcDq = 64;
constexpr int kWDkdv = 4, kBrDkdv = 64;

// dynamic shared memory of each kernel
constexpr int kSmemFwd = (16 * kWFwd + 4 * kBcFwd) * kRow * 2;
constexpr int kSmemDq =
    (2 * 16 * kWDq + 4 * kBcDq) * kRow * 2 + 2 * 16 * kWDq * 4;
constexpr int kSmemDkdv =
    (2 * 16 * kWDkdv + 4 * kBrDkdv) * kRow * 2 + 4 * kBrDkdv * 4;

template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

Args make_args(const void* q, long long q_sb, long long q_st, long long q_sh,
               const void* k, long long k_sb, long long k_st, long long k_sh,
               const void* v, long long v_sb, long long v_st, long long v_sh,
               int T, int H) {
  Args a = {};
  a.q = {static_cast<const bf16*>(q), q_sb, q_st, q_sh};
  a.k = {static_cast<const bf16*>(k), k_sb, k_st, k_sh};
  a.v = {static_cast<const bf16*>(v), v_sb, v_st, v_sh};
  a.T = T;
  a.H = H;
  return a;
}

}  // namespace

// F. q, k, v: (B, T, H, 72) bf16 views (element strides sb, st, sh; rows of
// 16-byte-aligned 144 bytes); out: contiguous (B, T, H, 72) bf16; lse:
// (B, H, T) f32.
extern "C" int fnn_attention_fwd(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh, void* out,
    float* lse, int B, int T, int H, void* stream) {
  Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st,
                     v_sh, T, H);
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  cudaError_t err = prepare(attention_fwd_kernel<kWFwd, kBcFwd>, kSmemFwd);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + 16 * kWFwd - 1) / (16 * kWFwd), B * H);
  attention_fwd_kernel<kWFwd, kBcFwd><<<grid, 32 * kWFwd, kSmemFwd,
                                        static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

// G: the dq pass (which writes delta, D) then the dkdv pass, on one stream.
// o, dout, dq, dk, dv: contiguous (B, T, H, 72) bf16; lse, delta: (B, H, T)
// f32.
extern "C" int fnn_attention_bwd(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* o, const void* dout, const float* lse, void* dq, void* dk,
    void* dv, float* delta, int B, int T, int H, void* stream) {
  Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st,
                     v_sh, T, H);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare(attention_bwd_dq_kernel<kWDq, kBcDq>, kSmemDq);
  if (err == cudaSuccess)
    err = prepare(attention_bwd_dkdv_kernel<kWDkdv, kBrDkdv>, kSmemDkdv);
  if (err != cudaSuccess) return (int)err;
  a.out = static_cast<bf16*>(dq);
  const dim3 grid_q((T + 16 * kWDq - 1) / (16 * kWDq), B * H);
  attention_bwd_dq_kernel<kWDq, kBcDq><<<grid_q, 32 * kWDq, kSmemDq, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((T + 16 * kWDkdv - 1) / (16 * kWDkdv), B * H);
  attention_bwd_dkdv_kernel<kWDkdv, kBrDkdv>
      <<<grid_k, 32 * kWDkdv, kSmemDkdv, st>>>(a);
  return (int)cudaGetLastError();
}
