// Host-side ops of the turbo serving path, exported with a C ABI for ctypes
// (fast_nnunet_tpu_torch/utils/hostops.py): the fused CT preprocess (clip,
// z-score, trilinear resize to the target grid, bf16 out), its box form
// for one x-strip, the raw-HU non-air bounding box and the nearest mask
// revert. The port's copy of engine/src/host_ops.cpp, built at first use by
// fast_nnunet_tpu_torch/ops/_build.py host_library() with the host C++
// compiler; the arithmetic is unchanged.
//
// Numerics contract (pinned by tests/test_torch_hostops.py):
// - fnn_preprocess_ct_i16 == `clip -> (x-mean)/std ->
//   jax.image.resize(method="trilinear", antialias=False) -> bfloat16`
//   up to f32 rounding (identical half-pixel-center sample positions,
//   clamped edges == jax's renormalized edge weights; the final bf16
//   round-to-nearest-even absorbs sub-ULP differences).
// - fnn_nearest_revert_u8 replays jax.image.resize(method="nearest")'s
//   exact index rule: idx = floor((i + 0.5) * in / out) in float32
//   arithmetic (same as inference/turbo.py _nearest_index).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint16_t f32_to_bf16(float v) {
    uint32_t x;
    std::memcpy(&x, &v, 4);
    // round to nearest even (matches XLA's f32->bf16 convert)
    uint32_t rounded = x + 0x7FFFu + ((x >> 16) & 1u);
    return static_cast<uint16_t>(rounded >> 16);
}

struct AxisTable {
    std::vector<int64_t> lo, hi;
    std::vector<float> w;  // weight of hi; lo gets (1 - w)
};

// jax.image.resize linear sample positions, f32 arithmetic like a jitted
// f32 program: x = (i + 0.5) * (in/out) - 0.5, triangle kernel width 1,
// out-of-range neighbors clamped (== jax's zero-weight + renormalize)
AxisTable linear_table(int64_t n_in, int64_t n_out) {
    AxisTable t;
    t.lo.resize(n_out);
    t.hi.resize(n_out);
    t.w.resize(n_out);
    const float scale = static_cast<float>(n_in) / static_cast<float>(n_out);
    for (int64_t i = 0; i < n_out; ++i) {
        float x = (static_cast<float>(i) + 0.5f) * scale - 0.5f;
        float fl = std::floor(x);
        int64_t lo = static_cast<int64_t>(fl);
        float w = x - fl;
        int64_t hi = lo + 1;
        if (lo < 0) { lo = 0; }
        if (hi > n_in - 1) { hi = n_in - 1; }
        if (lo > n_in - 1) { lo = n_in - 1; }
        t.lo[i] = lo;
        t.hi[i] = hi;
        t.w[i] = w;
    }
    return t;
}

}  // namespace

extern "C" {

// Core of the preprocess: compute output voxels in the half-open box
// [k0,k1)x[j0,j1)x[i0,i1) of the FULL out_shape grid, written compactly
// into `out` of shape (n_ch, k1-k0, j1-j0, i1-i0). Per-voxel math is a
// function of the voxel's FULL-grid index only, so any box is bit-identical
// to the same region of a whole-grid call — this is what lets the streamed
// turbo pipeline preprocess x-strips lazily, overlapped with the previous
// strip's H2D transfer.
int fnn_preprocess_ct_i16_box(const int16_t* src, const int64_t* in_shape,
                              int64_t n_ch, const float* lb, const float* ub,
                              const float* mean, const float* stdv,
                              const int64_t* out_shape, const int64_t* box,
                              uint16_t* out) {
    if (!src || !in_shape || !out_shape || !box || !out || n_ch < 1) return 1;
    const int64_t D = in_shape[0], H = in_shape[1], W = in_shape[2];
    const int64_t OD = out_shape[0], OH = out_shape[1], OW = out_shape[2];
    if (D < 1 || H < 1 || W < 1 || OD < 1 || OH < 1 || OW < 1) return 2;
    const int64_t k0 = box[0], k1 = box[1], j0 = box[2], j1 = box[3],
                  i0 = box[4], i1 = box[5];
    if (k0 < 0 || k1 > OD || j0 < 0 || j1 > OH || i0 < 0 || i1 > OW ||
        k0 >= k1 || j0 >= j1 || i0 >= i1) return 3;
    AxisTable td = linear_table(D, OD), th = linear_table(H, OH),
              tw = linear_table(W, OW);
    const int64_t in_plane = D * H * W;
    const int64_t BD = k1 - k0, BH = j1 - j0, BW = i1 - i0;
    const int64_t out_plane = BD * BH * BW;
    // row scratch: for a fixed (k, j) output row, the 4 source rows
    // (d0/d1 x h0/h1) are contiguous W-runs; lerp them W-wise
    for (int64_t c = 0; c < n_ch; ++c) {
        const int16_t* s = src + c * in_plane;
        uint16_t* o = out + c * out_plane;
        const float lo_v = lb[c], hi_v = ub[c];
        const float m = mean[c], inv = 1.0f / std::max(stdv[c], 1e-8f);
        for (int64_t k = k0; k < k1; ++k) {
            const int64_t d0 = td.lo[k] * H * W, d1 = td.hi[k] * H * W;
            const float wd = td.w[k];
            for (int64_t j = j0; j < j1; ++j) {
                const int64_t h0 = th.lo[j] * W, h1 = th.hi[j] * W;
                const float wh = th.w[j];
                const int16_t* r00 = s + d0 + h0;
                const int16_t* r01 = s + d0 + h1;
                const int16_t* r10 = s + d1 + h0;
                const int16_t* r11 = s + d1 + h1;
                // the row's first output voxel is i = i0: index orow[i - i0]
                // (offsetting the base by -i0 would form a pointer before
                // the buffer)
                uint16_t* orow = o + ((k - k0) * BH + (j - j0)) * BW;
                for (int64_t i = i0; i < i1; ++i) {
                    const int64_t w0 = tw.lo[i], w1 = tw.hi[i];
                    const float ww = tw.w[i];
                    auto cl = [&](int16_t v) {
                        float f = static_cast<float>(v);
                        return f < lo_v ? lo_v : (f > hi_v ? hi_v : f);
                    };
                    float c00 = cl(r00[w0]) + (cl(r00[w1]) - cl(r00[w0])) * ww;
                    float c01 = cl(r01[w0]) + (cl(r01[w1]) - cl(r01[w0])) * ww;
                    float c10 = cl(r10[w0]) + (cl(r10[w1]) - cl(r10[w0])) * ww;
                    float c11 = cl(r11[w0]) + (cl(r11[w1]) - cl(r11[w0])) * ww;
                    float c0 = c00 + (c01 - c00) * wh;
                    float c1 = c10 + (c11 - c10) * wh;
                    float v = c0 + (c1 - c0) * wd;
                    orow[i - i0] = f32_to_bf16((v - m) * inv);
                }
            }
        }
    }
    return 0;
}

// (n_ch, d, h, w) C-contiguous int16 HU -> (n_ch, od, oh, ow) bf16 (as
// uint16 bit patterns): per-channel clip to [lb, ub], z-score with
// (mean, std), trilinear resize with half-pixel centers. Returns 0 on
// success. Single-threaded by design (the serving box is 1-core; threads
// would fight the Python process).
int fnn_preprocess_ct_i16(const int16_t* src, const int64_t* in_shape,
                          int64_t n_ch, const float* lb, const float* ub,
                          const float* mean, const float* stdv,
                          const int64_t* out_shape, uint16_t* out) {
    if (!out_shape) return 1;
    const int64_t box[6] = {0, out_shape[0], 0, out_shape[1],
                            0, out_shape[2]};
    return fnn_preprocess_ct_i16_box(src, in_shape, n_ch, lb, ub, mean,
                                     stdv, out_shape, box, out);
}

// Per-axis [lo, hi) SOURCE-grid extents of the voxels where ANY channel's
// raw HU exceeds its clip floor lb (the voxels that can normalize to
// anything other than the air fill). One pass; air rows cost a SIMD row
// max, body rows two short scans. Feeds the lazy streamed crop: the
// source bbox maps conservatively to a target-grid bbox without ever
// materializing the full preprocessed volume (turbo._source_range_to_target).
// hi stays 0 when the whole volume is at/below the floor.
int fnn_nonair_bbox_i16(const int16_t* src, const int64_t* in_shape,
                        int64_t n_ch, const float* lb,
                        int64_t* out_lo, int64_t* out_hi) {
    if (!src || !in_shape || !lb || !out_lo || !out_hi || n_ch < 1) return 1;
    const int64_t D = in_shape[0], H = in_shape[1], W = in_shape[2];
    if (D < 1 || H < 1 || W < 1) return 2;
    int64_t dlo = D, dhi = 0, hlo = H, hhi = 0, wlo = W, whi = 0;
    for (int64_t c = 0; c < n_ch; ++c) {
        // v > lb  <=>  v >= thr with thr = lb+1 (integral lb) / ceil(lb)
        const float f = std::ceil(lb[c]);
        const float thrf = (f == lb[c]) ? f + 1.0f : f;
        if (thrf > 32767.0f) continue;  // nothing can exceed the floor
        const int16_t thr = static_cast<int16_t>(
            std::max(-32768.0f, thrf));
        const int16_t* s = src + c * D * H * W;
        for (int64_t d = 0; d < D; ++d) {
            for (int64_t h = 0; h < H; ++h) {
                const int16_t* row = s + (d * H + h) * W;
                int16_t mx = row[0];
                for (int64_t i = 1; i < W; ++i) mx = std::max(mx, row[i]);
                if (mx < thr) continue;
                dlo = std::min(dlo, d); dhi = std::max(dhi, d + 1);
                hlo = std::min(hlo, h); hhi = std::max(hhi, h + 1);
                int64_t a = 0;
                while (a < wlo && row[a] < thr) ++a;
                wlo = std::min(wlo, a);
                int64_t b = W;
                while (b > whi && row[b - 1] < thr) --b;
                whi = std::max(whi, b);
            }
        }
    }
    out_lo[0] = dlo; out_lo[1] = hlo; out_lo[2] = wlo;
    out_hi[0] = dhi; out_hi[1] = hhi; out_hi[2] = whi;
    if (dhi <= dlo) { out_lo[0] = out_lo[1] = out_lo[2] = 0;
                      out_hi[0] = out_hi[1] = out_hi[2] = 0; }
    return 0;
}

// uint8 nearest-neighbor resize (in_shape -> out_shape), replaying
// jax.image.resize(method="nearest")'s index map in f32 like
// turbo._nearest_index: idx = floor((i + 0.5) * in / out).
int fnn_nearest_revert_u8(const uint8_t* src, const int64_t* in_shape,
                          const int64_t* out_shape, uint8_t* out) {
    if (!src || !in_shape || !out_shape || !out) return 1;
    const int64_t D = in_shape[0], H = in_shape[1], W = in_shape[2];
    const int64_t OD = out_shape[0], OH = out_shape[1], OW = out_shape[2];
    if (D < 1 || H < 1 || W < 1 || OD < 1 || OH < 1 || OW < 1) return 2;
    auto nearest = [](int64_t n_in, int64_t n_out) {
        std::vector<int64_t> idx(n_out);
        for (int64_t i = 0; i < n_out; ++i) {
            // f32 multiply-then-divide, matching the numpy/jax rule exactly
            float x = (static_cast<float>(i) + 0.5f) *
                      static_cast<float>(n_in) / static_cast<float>(n_out);
            int64_t v = static_cast<int64_t>(std::floor(x));
            idx[i] = std::clamp<int64_t>(v, 0, n_in - 1);
        }
        return idx;
    };
    auto id = nearest(D, OD), ih = nearest(H, OH), iw = nearest(W, OW);
    for (int64_t k = 0; k < OD; ++k) {
        const uint8_t* sk = src + id[k] * H * W;
        for (int64_t j = 0; j < OH; ++j) {
            const uint8_t* sj = sk + ih[j] * W;
            uint8_t* orow = out + (k * OH + j) * OW;
            if (W == OW) {
                std::memcpy(orow, sj, static_cast<size_t>(OW));
            } else {
                for (int64_t i = 0; i < OW; ++i) orow[i] = sj[iw[i]];
            }
        }
    }
    return 0;
}

}  // extern "C"
