// Kernels F and G: Primus's attention, fused, forward (F) and backward (G):
// no T x T tensor in device memory. The JAX package has no Pallas kernel
// here (its EvaAttention is XLA einsums and a softmax); these are kernels of
// the port alone, added because plain attention keeps f32 scores and
// probabilities of (B, H, T, T) per layer for the backward (~15.4 GB a layer
// for Primus M at a 160^3 patch, 8,000 tokens), which no card holds over 16
// layers. The contract, the plain version and the autograd Function are in
// ops/attention.py.
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
// 4,600 operations a byte, far above the H100's ridge (~295). G's work is
// the five products, 10 B H T^2 72.
//
// F, FlashAttention-2 style: mma.sync m16n8k16 (bf16 in, f32 accumulators)
// on fragments read with ldmatrix from shared memory; a block of 8 warps owns
// 128 query rows (16 a warp), streams 64-row key and value tiles through a
// double buffer of cp.async copies, so the next tile's load overlaps the
// current tile's products; the online softmax stays in registers. Tiles live
// in shared memory as rows of 88 bf16 (176 bytes: ldmatrix's 8 rows fall on
// distinct banks); columns 72-79 are zeroed once, so the QK^T depth runs to
// 80 in five k16 steps; PV runs as nine n8 tiles. Rows past T are loaded as
// zeros (cp.async's zero fill), scores of keys past T are set to -inf, and
// rows past T are not stored.
//
// G, two launches a call, built on Hopper's wgmma, TMA and mbarriers:
// - attention_bwd_prep_kernel writes D and lse in log2 units (+inf past T,
//   so P is 0 there) for every row of the query tiles, zeroes the f32 dQ
//   accumulator and one arrival counter per query tile;
// - attention_bwd_kernel is one key-major pass: a block owns 128 key rows of
//   one (b, h), K and V in shared memory, and walks every 64-row query tile,
//   each block starting at another tile (so the blocks of a head add into
//   other dQ tiles at a time, and the last one to reach a tile is spread
//   over the blocks). A producer warpgroup's first warp streams Q, dO, lse
//   and D through a ring of three stages (TMA and bulk copies completing on
//   mbarriers); two consumer warpgroups, 64 key rows each, compute for
//   each tile
//     S^T = K Q^T, dP^T = V dO^T (SS wgmma m64n64k16, depth 80),
//     P^T = exp(S^T - lse), dS^T = P^T o (dP^T - D) in registers,
//     dV += P^T dO, dK += dS^T Q (RS wgmma m64n80k16, A from registers),
//     dQ_part = dS K (SS wgmma, dS^T through shared memory),
//   so each of the five products is computed once (P^T from the SFU's
//   ex2.approx.ftz: exp2f's path for subnormal results cost 0.6 ms a
//   call); dV and dK stay in f32
//   registers over the whole walk and are stored once, in bf16. The two
//   warpgroups' dQ parts are summed in one of three shared buffers, which
//   the producer's second warp adds into the f32 accumulator with one bulk
//   reduce-add (cp.reduce.async.bulk) a tile. That warp counts the block in
//   for eight tiles at a time, four reduce-adds behind (a fence a count is
//   what costs: a count a tile took 3.65 ms a call against 2.86), and lists
//   the tiles whose counter it brought to the number of key blocks; at the
//   end the producer warpgroup writes those tiles' dQ in bf16. So dQ's f32
//   sums arrive in an order that changes from run to run; dK and dV do not.
//   The producer warpgroup gives up registers (setmaxnreg 40) so that the
//   consumers hold 232; the loop is not software-pipelined (issuing the
//   next tile's S^T before this tile's dQ part goes out runs out of
//   registers: ptxas serializes the wgmmas, 3.37-3.49 ms).
// On an H100 at (2, 8000, 12, 72): 2.78-2.80 ms a call, 40% of the bound.
//
// Shapes: head dim 72 is not a multiple of 16. G keeps every bf16 tile in
// shared memory as five 16-column slabs of 32-byte rows, in the 32-byte
// swizzle that TMA writes and wgmma reads, both as K-major operand (the
// depth of S^T and dP^T) and as MN-major one (the width of dV, dK and dQ);
// TMA fills columns 72-79 and rows past T with zeros, so every product runs
// at width or depth 80 and columns 72-79 of the results are dropped. Keys
// past T have zero K and V rows, and their P is set to 0.
//
// Layouts: q, k, v are (B, T, H, 72) views with element strides (batch,
// token, head), the last dim contiguous, 16-byte aligned rows (v is read in
// place from the qkv projection's (B, T, 3, H, 72) output). O, dO, dQ, dK,
// dV are contiguous (B, T, H, 72); lse is (B, H, T) f32.
#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 72;                // head dim
constexpr int kSteps = 5;             // k16 steps of the padded depth 80
constexpr int kRow = 88;              // F's shared-memory row stride (bf16)
constexpr int kChunks = kD * 2 / 16;  // 16-byte chunks a row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct View {  // a (B, T, H, 72) view
  const bf16* p;
  long long sb, st, sh;
  __device__ const bf16* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

struct Args {       // kernel F
  View q, k, v;
  bf16* out;        // O
  float* lse;       // (B, H, T)
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


// ----------------------------------------------------------------- kernel G
constexpr int kBr = 64;                 // query rows a tile
constexpr int kBc = 128;                // key rows a block, 64 a warpgroup
constexpr int kStages = 3;              // query tiles in flight
// a block: two consumer warpgroups and a producer one, whose first warp
// issues the loads and second one the dQ reduce-adds and counts
constexpr int kThreadsBwd = 3 * 128;
constexpr int kDqBufs = 3;              // dQ parts in flight
// shared memory, bytes from a 1024-aligned base; a bf16 tile of R rows is
// five slabs of R rows x 32 bytes (columns 16 s .. 16 s + 15 of each row)
constexpr int kKvBytes = kSteps * kBc * 32;        // K or V
constexpr int kTileBytes = kSteps * kBr * 32;      // Q or dO
constexpr int kStageTx = 2 * kTileBytes + 2 * kBr * 4;  // + lse, D
constexpr int kStageStride = (kStageTx + 1023) / 1024 * 1024;
constexpr int kDsBytes = 4 * kBc * 32;             // dS^T: (q / 16, key, q % 16)
constexpr int kDqBytes = kBr * kD * 4;             // a tile's dQ part, f32
constexpr int kOffV = kKvBytes;
constexpr int kOffStage = 2 * kKvBytes;
constexpr int kOffDs = kOffStage + kStages * kStageStride;
constexpr int kOffDq = kOffDs + kDsBytes;          // kDqBufs buffers
constexpr int kOffBar = kOffDq + kDqBufs * kDqBytes;
constexpr int kOffClosed = kOffBar + 256;          // + barriers, a count
constexpr int kSmemBwd = kOffClosed + 1024;        // + alignment; + 4 nq
static_assert((2 * kStages + 3 * kDqBufs + 1) * 8 + 4 <= 256, "barriers");
constexpr int kLag = 4;     // reduce-adds in flight past the counted ones
constexpr int kBatch = 8;   // tiles counted at a time
// named barriers (0 is __syncthreads): 1 + warpgroup, the warpgroup's own;
// 3, the producer warpgroup's

struct BwdArgs {
  const bf16* o;       // forward output, contiguous
  const bf16* dout;    // contiguous
  const float* lse;    // (B, H, T)
  float* L;            // (B H, Tpad): lse x log2(e), +inf past T
  float* D;            // (B H, Tpad): rowsum(dO o O), 0 past T
  float* dq_acc;       // (B H, Tpad, 72) f32
  int* count;          // (B H, nq): key blocks done with each query tile
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int T, H, Tpad, nq;
};

// ------------------------------------------- Hopper: mbarriers, TMA, wgmma
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// wait for the completion of the barrier's phase of the given parity; a wait
// of 2^35 clocks (~20 s) traps, so a copy that never lands fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  long long since = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (since == 0)
      since = clock64();
    else if (clock64() - since > (1ll << 35))
      __trap();
  }
}

// a box of the tensor map at coordinates (c0 .. c3) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i], f32, from shared to global memory, as one bulk group
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                unsigned bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 32-byte swizzle; lbo and sbo in bytes
// (K-major: sbo the stride of 8-row groups, lbo unused; MN-major: lbo the
// stride of 16-column slabs, sbo that of 8-row groups along K)
__device__ __forceinline__ uint64_t gdesc(unsigned addr, unsigned lbo,
                                          unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// 2^x by the SFU, subnormal results flushed to 0 (P below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers the compiler must treat as live and changed here: accumulators
// and A fragments of wgmma in flight are read only after its wait
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void keep(unsigned (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define FNN_D8(o)                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define FNN_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FNN_R40                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), both K-major in shared memory
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FNN_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FNN_D8(0), FNN_D8(8), FNN_D8(16), FNN_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 80) (+)= A (64 x 16) B (16 x 80), both MN-major in shared memory
__device__ __forceinline__ void wg_ss80t(float (&d)[40], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " FNN_R40
      ", %40, %41, p, 1, 1, 1, 1;\n}\n"
      : FNN_D8(0), FNN_D8(8), FNN_D8(16), FNN_D8(24), FNN_D8(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 80) += A (64 x 16, registers) B (16 x 80, MN-major in shared
// memory)
__device__ __forceinline__ void wg_rs80(float (&d)[40], const unsigned (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " FNN_R40
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : FNN_D8(0), FNN_D8(8), FNN_D8(16), FNN_D8(24), FNN_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A fragments (four k16 steps) of a 64 x 64 accumulator, rounded to bf16
__device__ __forceinline__ void frags64(unsigned (&a)[4][4],
                                        const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
}

// Counts this block in for the query tiles of its walk's steps `from` ..
// `to` - 1 (kBatch at most), whose reduce-adds have landed (the caller waited
// for their bulk groups): one release fence, then the counters' atomics all
// in flight; a tile this block was the last for is listed in `closed`.
__device__ __forceinline__ void count_in(const BwdArgs& a, int bh, int first,
                                         int from, int to, int* closed,
                                         int* n_closed) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  int tile[kBatch], old[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    tile[u] = (first + from + u) % a.nq;
    old[u] = from + u < to
                 ? atomicAdd(a.count + (long long)bh * a.nq + tile[u], 1)
                 : 0;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (from + u < to && old[u] == (int)gridDim.x - 1)
      closed[(*n_closed)++] = tile[u];
}

// query tile `tile` of the f32 dQ accumulator, complete, to bf16 dQ rows
// below T (128 threads, t the thread's index; three loads in flight each)
__device__ __forceinline__ void write_dq(const BwdArgs& a, int b, int h,
                                         int bh, int tile, int t) {
  constexpr int kQuads = kD / 4, kEach = kBr * kQuads / 128;  // 9
  const float4* src = reinterpret_cast<const float4*>(
      a.dq_acc + ((long long)bh * a.Tpad + tile * kBr) * kD);
#pragma unroll
  for (int e0 = 0; e0 < kEach; e0 += 3) {
    float4 x[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) x[u] = __ldcg(src + t + 128 * (e0 + u));
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int e = t + 128 * (e0 + u), row = tile * kBr + e / kQuads;
      if (row < a.T)
        *reinterpret_cast<uint2*>(a.dq +
                                  ((long long)b * a.T + row) * a.H * kD +
                                  h * kD + (e % kQuads) * 4) =
            make_uint2(pack(x[u].x, x[u].y), pack(x[u].z, x[u].w));
    }
  }
}

// Launch 1: for the rows of one 64-row query tile of one (b, h), D and lse
// in log2 units (0 and +inf past T); the tile's f32 dQ rows and its counter
// set to zero.
__global__ void __launch_bounds__(128) attention_bwd_prep_kernel(
    const BwdArgs a) {
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * kBr, t = threadIdx.x;
  const long long row0 = (long long)bh * a.Tpad + q0;
  if (t < kBr) {
    const int row = q0 + t;
    float d = 0.f, l = INFINITY;
    if (row < a.T) {
      const long long off = ((long long)b * a.T + row) * a.H * kD + h * kD;
      const uint4* po = reinterpret_cast<const uint4*>(a.o + off);
      const uint4* pd = reinterpret_cast<const uint4*>(a.dout + off);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint4 x = po[c], y = pd[c];
        const bf16* xs = reinterpret_cast<const bf16*>(&x);
        const bf16* ys = reinterpret_cast<const bf16*>(&y);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d = fmaf(__bfloat162float(ys[e]), __bfloat162float(xs[e]), d);
      }
      l = a.lse[(long long)bh * a.T + row] * kLog2e;
    }
    a.L[row0 + t] = l;
    a.D[row0 + t] = d;
  }
  float4* acc = reinterpret_cast<float4*>(a.dq_acc + row0 * kD);
  for (int i = t; i < kBr * kD / 4; i += blockDim.x)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t == 0) a.count[(long long)bh * a.nq + blockIdx.x] = 0;
}

// Launch 2: the key-major pass (the note at the top). Grid (key blocks,
// B H); tq, tk, tv, tdo: 4-d tensor maps (72, H, T, B) with boxes of 16
// columns x 64 (q, dO) or 128 (k, v) rows and the 32-byte swizzle.
__global__ void __launch_bounds__(kThreadsBwd, 1) attention_bwd_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;
  uint64_t* dq_empty = dq_full + kDqBufs;
  uint64_t* dq_half = dq_empty + kDqBufs;  // warpgroup 0's part is in
  uint64_t* kv_full = dq_half + kDqBufs;
  int* n_closed = reinterpret_cast<int*>(kv_full + 1);
  int* closed = reinterpret_cast<int*>(sm + kOffClosed);  // nq slots
  const int T = a.T, H = a.H, nq = a.nq;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBc;
  const int first = (int)((long long)blockIdx.x * nq / gridDim.x);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    for (int s = 0; s < kDqBufs; ++s) {
      mbar_init(dq_full + s, 128);
      mbar_init(dq_empty + s, 1);
      mbar_init(dq_half + s, 128);
    }
    mbar_init(kv_full, 1);
    *n_closed = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {  // the loads: K and V once, then the query tiles
      mbar_expect_tx(kv_full, 2 * kKvBytes);
      for (int s = 0; s < kSteps; ++s) {
        tma_load(sm + s * kBc * 32, &tk, 16 * s, h, k0, b, kv_full);
        tma_load(sm + kOffV + s * kBc * 32, &tv, 16 * s, h, k0, b, kv_full);
      }
      int i = first;
      for (int n = 0; n < nq; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(empty + s, ((n / kStages) + 1) & 1);
        unsigned char* st = sm + kOffStage + s * kStageStride;
        mbar_expect_tx(full + s, kStageTx);
        for (int c = 0; c < kSteps; ++c) {
          tma_load(st + c * kBr * 32, &tq, 16 * c, h, i * kBr, b, full + s);
          tma_load(st + kTileBytes + c * kBr * 32, &tdo, 16 * c, h, i * kBr,
                   b, full + s);
        }
        const long long r0 = (long long)bh * a.Tpad + i * kBr;
        bulk_load(st + 2 * kTileBytes, a.L + r0, kBr * 4, full + s);
        bulk_load(st + 2 * kTileBytes + kBr * 4, a.D + r0, kBr * 4, full + s);
        i = i + 1 == nq ? 0 : i + 1;
      }
    } else if (tid >> 5 == 9 && lane == 0) {
      // dQ: the reduce-adds; the counts kBatch steps at a time, kLag steps
      // behind (once those reduce-adds have landed); the closed tiles listed
      int i = first, counted = 0;
      for (int n = 0; n < nq; ++n) {
        const int buf = n % kDqBufs;
        mbar_wait(dq_full + buf, (n / kDqBufs) & 1);
        bulk_reduce_add(
            a.dq_acc + ((long long)bh * a.Tpad + i * kBr) * kD,
            reinterpret_cast<const float*>(sm + kOffDq + buf * kDqBytes),
            kDqBytes);
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(dq_empty + buf);
        if (n + 1 - kLag - counted == kBatch) {
          asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kLag)
                       : "memory");
          count_in(a, bh, first, counted, counted + kBatch, closed, n_closed);
          counted += kBatch;
        }
        i = i + 1 == nq ? 0 : i + 1;
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      for (; counted < nq; counted += kBatch)
        count_in(a, bh, first, counted, nq, closed, n_closed);
      __threadfence();  // the other blocks' parts of the closed tiles
    }
    // the closed tiles to bf16 dQ, by the whole producer warpgroup (its
    // threads arrive here from diverged branches: barrier without .aligned)
    asm volatile("barrier.sync 3, 128;\n" ::: "memory");
    for (int c = 0; c < *n_closed; ++c)
      write_dq(a, b, h, bh, closed[c], tid - 256);
    return;
  }

  // consumer warpgroup wg: key rows k0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t = tid & 127;
  const int r = 16 * (t >> 5) + (lane >> 2);  // accumulator rows r, r + 8
  const int c2 = 2 * (lane & 3);               // and columns 8 j + c2, + 1
  const unsigned base = smem_u32(sm);
  const unsigned aK = base + wg * 64 * 32;     // slab 0 of its K rows
  const unsigned aV = base + kOffV + wg * 64 * 32;
  const unsigned aDs = base + kOffDs + wg * 64 * 32;
  // keys past T: P = 0 (their K and V rows are zeros)
  const bool live0 = k0 + 64 * wg + r < T, live1 = k0 + 64 * wg + r + 8 < T;
  float dv[40], dk[40], dq[40], sp[32], dp[32];
#pragma unroll
  for (int e = 0; e < 40; ++e) dv[e] = dk[e] = dq[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sp[e] = dp[e] = 0.f;
  mbar_wait(kv_full, 0);

  for (int n = 0; n < nq; ++n) {
    const int s = n % kStages;
    const unsigned st = base + kOffStage + s * kStageStride;
    const float* sL = reinterpret_cast<const float*>(
        sm + kOffStage + s * kStageStride + 2 * kTileBytes);
    const float* sD = sL + kBr;
    mbar_wait(full + s, (n / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, depth 80 in five slabs
    wg_fence();
#pragma unroll
    for (int c = 0; c < kSteps; ++c)
      wg_ss64(sp, gdesc(aK + c * kBc * 32, 16, 256),
              gdesc(st + c * kBr * 32, 16, 256), c);
    wg_commit();
#pragma unroll
    for (int c = 0; c < kSteps; ++c)
      wg_ss64(dp, gdesc(aV + c * kBc * 32, 16, 256),
              gdesc(st + kTileBytes + c * kBr * 32, 16, 256), c);
    wg_commit();
    wg_wait<1>();
    keep(sp);

    // P^T = exp(S^T - lse) (queries are columns); dV += P^T dO
    float p[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sL + 8 * j + c2);
      p[4 * j] = live0 ? ex2(fmaf(sp[4 * j], kLog2e, -l.x)) : 0.f;
      p[4 * j + 1] = live0 ? ex2(fmaf(sp[4 * j + 1], kLog2e, -l.y)) : 0.f;
      p[4 * j + 2] = live1 ? ex2(fmaf(sp[4 * j + 2], kLog2e, -l.x)) : 0.f;
      p[4 * j + 3] = live1 ? ex2(fmaf(sp[4 * j + 3], kLog2e, -l.y)) : 0.f;
    }
    unsigned pa[4][4];
    frags64(pa, p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs80(dv, pa[kk], gdesc(st + kTileBytes + kk * 512, kBr * 32, 256));
    wg_commit();
    wg_wait<1>();
    keep(dp);

    // dS^T = P^T o (dP^T - D); dK += dS^T Q; dS^T to shared memory
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(sD + 8 * j + c2);
      p[4 * j] *= dp[4 * j] - d.x;
      p[4 * j + 1] *= dp[4 * j + 1] - d.y;
      p[4 * j + 2] *= dp[4 * j + 2] - d.x;
      p[4 * j + 3] *= dp[4 * j + 3] - d.y;
    }
    unsigned sa[4][4];
    frags64(sa, p);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // sa[kk][e]: key row r + 8 (e & 1), queries 16 kk + 8 (e >> 1) + c2
        const int key = 64 * wg + r + 8 * (e & 1);
        const int chunk = (e >> 1) ^ ((key >> 2) & 1);  // the 32-byte swizzle
        *reinterpret_cast<unsigned*>(sm + kOffDs + kk * kBc * 32 + key * 32 +
                                     chunk * 16 + c2 * 2) = sa[kk][e];
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs80(dk, sa[kk], gdesc(st + kk * 512, kBr * 32, 256));
    wg_commit();
    fence_async_smem();
    bar_sync(1 + wg, 128);

    // this warpgroup's part of dQ = dS K
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_ss80t(dq, gdesc(aDs + kk * 512, kBc * 32, 256),
               gdesc(aK + kk * 512, kBc * 32, 256), kk);
    wg_commit();
    wg_wait<0>();
    keep(dv);
    keep(dk);
    keep(dq);
    keep(pa);
    keep(sa);
    mbar_arrive(empty + s);

    // the two parts summed in a dQ buffer, which the dQ warp adds into the
    // accumulator
    const int buf = n % kDqBufs;
    float* sq = reinterpret_cast<float*>(sm + kOffDq + buf * kDqBytes);
    if (wg == 0) {
      if (n >= kDqBufs) mbar_wait(dq_empty + buf, ((n / kDqBufs) + 1) & 1);
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(sq + (r + 8 * e) * kD + 8 * j + c2) =
              make_float2(dq[4 * j + 2 * e], dq[4 * j + 2 * e + 1]);
      mbar_arrive(dq_half + buf);
    } else {
      mbar_wait(dq_half + buf, (n / kDqBufs) & 1);
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float2* q2 =
              reinterpret_cast<float2*>(sq + (r + 8 * e) * kD + 8 * j + c2);
          const float2 x = *q2;
          *q2 = make_float2(x.x + dq[4 * j + 2 * e],
                            x.y + dq[4 * j + 2 * e + 1]);
        }
      fence_async_smem();
      mbar_arrive(dq_full + buf);
    }
  }

  // dK and dV rows below T, columns 0-71, in bf16
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = k0 + 64 * wg + r + 8 * e;
    if (row >= T) continue;
    const long long off = ((long long)b * T + row) * H * kD + h * kD + c2;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      *reinterpret_cast<unsigned*>(a.dk + off + 8 * j) =
          pack(dk[4 * j + 2 * e], dk[4 * j + 2 * e + 1]);
      *reinterpret_cast<unsigned*>(a.dv + off + 8 * j) =
          pack(dv[4 * j + 2 * e], dv[4 * j + 2 * e + 1]);
    }
  }
}

// F's warps a block (16 rows each) and streamed key tile: on an H100 at
// (2, 8000, 12, 72) F takes 1.83 ms with 8 warps against 2.08 with 4
constexpr int kWFwd = 8, kBcFwd = 64;
constexpr int kSmemFwd = (16 * kWFwd + 4 * kBcFwd) * kRow * 2;

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (so
// nothing links -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, T, H, 72) bf16 view (element strides sb, st, sh) as G's tensor map:
// dims (72, H, T, B), boxes of 16 columns x `rows` tokens, 32-byte swizzle,
// zeros outside (columns 72-79, rows past T)
cudaError_t tensor_map(CUtensorMap* map, const void* p, long long sb,
                       long long st, long long sh, int B, int T, int H,
                       int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {kD, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// G: the prep kernel, then the key-major pass, on one stream. q, k, v as
// for F; o, dout, dq, dk, dv: contiguous (B, T, H, 72) bf16; lse: (B, H, T)
// f32; ws: f32 workspace of B H (74 Tpad + nq) values, Tpad = 64 nq, nq =
// ceil(T / 64): lse in log2 units, D, the dQ accumulator, then nq int32
// counters per (b, h).
extern "C" int fnn_attention_bwd(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* o, const void* dout, const float* lse, void* dq, void* dk,
    void* dv, float* ws, int B, int T, int H, void* stream) {
  const int nq = (T + kBr - 1) / kBr, nkv = (T + kBc - 1) / kBc;
  const long long rows = (long long)B * H * nq * kBr;
  BwdArgs a = {};
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.L = ws;
  a.D = ws + rows;
  a.dq_acc = ws + 2 * rows;
  a.count = reinterpret_cast<int*>(ws + (2 + kD) * rows);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.T = T;
  a.H = H;
  a.Tpad = nq * kBr;
  a.nq = nq;
  CUtensorMap tq, tk, tv, tdo;
  const long long ct = (long long)H * kD;  // token stride of dO
  cudaError_t err = tensor_map(&tq, q, q_sb, q_st, q_sh, B, T, H, kBr);
  if (err == cudaSuccess)
    err = tensor_map(&tk, k, k_sb, k_st, k_sh, B, T, H, kBc);
  if (err == cudaSuccess)
    err = tensor_map(&tv, v, v_sb, v_st, v_sh, B, T, H, kBc);
  if (err == cudaSuccess)
    err = tensor_map(&tdo, dout, T * ct, ct, kD, B, T, H, kBr);
  const int smem = kSmemBwd + 4 * nq;  // + the list of closed tiles
  if (err == cudaSuccess) err = prepare(attention_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attention_bwd_prep_kernel<<<dim3(nq, B * H), 128, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<<<dim3(nkv, B * H), kThreadsBwd, smem, st>>>(
      tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}
