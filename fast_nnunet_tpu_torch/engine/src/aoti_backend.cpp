// In-process AOTInductor backend: loads the exporter's AOTInductor package
// (model_aoti.pt2, export/export_model.py aoti=True: the network's
// evaluation forward, weights baked in) with libtorch's
// AOTIModelPackageLoader and runs the sliding-window inference natively on
// the card (or the CPU) — no Python, no daemon.
//
// The port's counterpart of engine/src/pjrt_backend.cpp, which compiles the
// JAX exporter's StableHLO artifact through a PJRT plugin: the tile grid,
// the gaussian importance map, the batching (the last batch padded by
// repeating a tile), the f32 -> bf16 input rounding and the host
// accumulation are that file's, element for element, so masks match the
// Python predictor. What differs is the device call: each tile batch is
// copied to the device in the export dtype, run by the package, and its
// logits (channels-first, (B, K, px, py, pz)) are copied back as float32;
// and the host loops walk one class plane at a time in memory order (the
// same additions per element, in the same tile order), with the
// accumulators kept z-fastest like the tiles.
//
// The package calls the network's InstanceNorm back through the dispatcher
// as the op fnn_torch::instance_norm (models/blocks.py registers it in
// Python); it is registered here with the same ATen calls in the same
// order, so each norm rounds as the eager network's does.
#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/library.h>

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "fast_nnunet/engine.h"

namespace fast_nnunet {
namespace {

// models/blocks.py instance_norm: two-pass float32 InstanceNorm over the
// spatial dims of NC..., cast back to the input dtype
at::Tensor instance_norm(const at::Tensor& x, const at::Tensor& scale,
                         const at::Tensor& bias, double eps) {
    std::vector<int64_t> dims;
    for (int64_t d = 2; d < x.dim(); ++d) dims.push_back(d);
    at::Tensor y = x.to(at::kFloat, /*non_blocking=*/false, /*copy=*/true);
    auto [var, mean] = at::var_mean(y, dims, /*correction=*/at::Scalar(0),
                                    /*keepdim=*/true);
    std::vector<int64_t> shape(x.dim(), 1);
    shape[1] = -1;
    y.sub_(mean).mul_(at::rsqrt(var + eps));
    y.mul_(scale.to(at::kFloat).reshape(shape))
        .add_(bias.to(at::kFloat).reshape(shape));
    return y.to(x.scalar_type());
}

// ----------------------------------------------------------------- utilities
// fp32 -> bf16 with round-to-nearest-even (matches XLA's convert semantics)
inline uint16_t f32_to_bf16(float v) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    if ((bits & 0x7fffffff) > 0x7f800000) return uint16_t((bits >> 16) | 0x40);
    uint32_t lsb = (bits >> 16) & 1;
    return uint16_t((bits + 0x7fff + lsb) >> 16);
}

// scipy.ndimage.gaussian_filter1d kernel: truncated at radius
// int(4*sigma + 0.5), normalized to sum 1 (ops/sliding_window.py parity)
std::vector<double> gaussian_kernel1d(double sigma) {
    int radius = int(4.0 * sigma + 0.5);
    std::vector<double> k(2 * radius + 1);
    double sum = 0;
    for (int i = -radius; i <= radius; ++i) {
        double v = std::exp(-0.5 * i * i / (sigma * sigma));
        k[i + radius] = v;
        sum += v;
    }
    for (double& v : k) v /= sum;
    return k;
}

// Separable gaussian importance map == scipy gaussian_filter of a center
// impulse with mode="constant": product of 1-D kernels centered at
// patch[d]//2, zero outside the truncation radius, then normalized to max 1
// and zeros clamped to the smallest positive value.
std::vector<float> compute_gaussian_map(const std::array<int, 3>& patch) {
    std::array<std::vector<double>, 3> k1;
    std::array<int, 3> center, radius;
    for (int d = 0; d < 3; ++d) {
        double sigma = patch[d] / 8.0;
        k1[d] = gaussian_kernel1d(sigma);
        center[d] = patch[d] / 2;
        radius[d] = int(k1[d].size() / 2);
    }
    auto tap = [&](int d, int i) -> double {
        int off = i - center[d] + radius[d];
        if (off < 0 || off >= int(k1[d].size())) return 0.0;
        return k1[d][off];
    };
    std::vector<float> g(size_t(patch[0]) * patch[1] * patch[2]);
    double maxv = 0;
    size_t idx = 0;
    for (int i = 0; i < patch[0]; ++i)
        for (int j = 0; j < patch[1]; ++j)
            for (int l = 0; l < patch[2]; ++l) {
                double v = tap(0, i) * tap(1, j) * tap(2, l);
                g[idx++] = float(v);
                maxv = std::max(maxv, v);
            }
    float minpos = std::numeric_limits<float>::max();
    for (float& v : g) {
        v = float(v / maxv);
        if (v > 0) minpos = std::min(minpos, v);
    }
    for (float& v : g)
        if (v == 0) v = minpos;
    return g;
}

// Per-axis tile starts: at most patch*step apart, evenly spread, last tile
// flush with the border (ops/sliding_window.py compute_steps_for_sliding_window)
std::vector<int64_t> steps_for_axis(int64_t image, int64_t tile, double step) {
    int64_t max_start = image - tile;
    int64_t num = int64_t(std::ceil(double(max_start) / (tile * step))) + 1;
    std::vector<int64_t> out(num);
    if (num == 1) {
        out[0] = 0;
        return out;
    }
    double actual = double(max_start) / (num - 1);
    for (int64_t i = 0; i < num; ++i)
        out[i] = int64_t(std::llround(actual * i));
    return out;
}

// ------------------------------------------------------------------- backend
class AotiBackend : public Backend {
  public:
    AotiBackend(const std::string& package_path, const std::string& device,
                const std::string& input_dtype)
        : device_(device == "cuda" ? at::Device(at::kCUDA, 0)
                                   : at::Device(at::kCPU)),
          bf16_input_(input_dtype == "bfloat16") {
        if (device != "cuda" && device != "cpu")
            throw std::runtime_error("--device must be cuda or cpu, got " +
                                     device);
        if (input_dtype != "bfloat16" && input_dtype != "float32")
            throw std::runtime_error("input dtype must be bfloat16 or "
                                     "float32, got " + input_dtype);
        try {
            loader_ = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
                package_path, "model");
        } catch (const std::exception& e) {
            throw std::runtime_error("loading " + package_path + " on " +
                                     device + ": " + e.what());
        }
        // a package runs on the device it was compiled for: a CUDA package
        // is never run on the CPU, nor a CPU package on the card
        auto meta = loader_->get_metadata();
        auto it = meta.find("AOTI_DEVICE_KEY");
        const std::string built = it == meta.end() ? "" : it->second;
        if (built != device)
            throw std::runtime_error(package_path + " was compiled for '" +
                                     built + "', asked to run on '" + device +
                                     "'");
    }

    Logits infer_volume(const std::vector<float>& pre,
                        const std::array<int64_t, 3>& shape,
                        const EngineConfig& cfg) override {
        const std::array<int, 3> patch = cfg.patch_size;
        const int K = cfg.num_class;

        // pad volume up to >= patch per axis (centered, zeros — matches
        // ops/pad.pad_nd_image used by the Python predictor)
        std::array<int64_t, 3> padded{}, lo{};
        for (int d = 0; d < 3; ++d) {
            padded[d] = std::max<int64_t>(shape[d], patch[d]);
            lo[d] = (padded[d] - shape[d]) / 2;
        }
        std::vector<float> vol(size_t(padded[0]) * padded[1] * padded[2], 0.f);
        for (int64_t k = 0; k < shape[2]; ++k)
            for (int64_t j = 0; j < shape[1]; ++j)
                for (int64_t i = 0; i < shape[0]; ++i)
                    vol[(i + lo[0]) +
                        padded[0] * ((j + lo[1]) + padded[1] * (k + lo[2]))] =
                        pre[i + shape[0] * (j + shape[1] * k)];

        auto sx = steps_for_axis(padded[0], patch[0], cfg.step_size);
        auto sy = steps_for_axis(padded[1], patch[1], cfg.step_size);
        auto sz = steps_for_axis(padded[2], patch[2], cfg.step_size);

        std::vector<float> gauss =
            cfg.use_gaussian
                ? compute_gaussian_map(patch)
                : std::vector<float>(size_t(patch[0]) * patch[1] * patch[2],
                                     1.f);

        const size_t patch_n = size_t(patch[0]) * patch[1] * patch[2];
        const size_t pvol = size_t(padded[0]) * padded[1] * padded[2];
        // accumulator index of padded voxel (x, y, z): z fastest, the
        // tiles' own order (the volume and the logits are x fastest)
        auto zfast = [&](int64_t x, int64_t y, int64_t z) {
            return (size_t(x) * padded[1] + size_t(y)) * padded[2] + z;
        };
        const int B = std::max(1, cfg.tile_batch);
        std::vector<float> acc(size_t(K) * pvol, 0.f);
        std::vector<float> wsum(pvol, 0.f);
        std::vector<float> tiles(size_t(B) * patch_n);
        std::vector<uint16_t> tiles_bf16(bf16_input_ ? size_t(B) * patch_n : 0);
        std::vector<float> logits_f32(size_t(B) * patch_n * K);

        // package input layout: (B, 1, px, py, pz) channels-first (one
        // channel: the same bytes as pjrt_backend.cpp's channels-last
        // tiles); B must match the batch dimension it was exported with
        std::vector<int64_t> in_dims = {B, 1, patch[0], patch[1], patch[2]};

        std::vector<std::array<int64_t, 3>> starts;
        for (int64_t x0 : sx)
            for (int64_t y0 : sy)
                for (int64_t z0 : sz) starts.push_back({x0, y0, z0});

        if (cfg.skip_air_tiles) {
            // empty-tile skipping on the normalized volume: one-pass 8^3
            // block maxima, then drop tiles whose covering blocks all stay
            // below the air threshold (voxels covered only by dropped tiles
            // have weight 0 -> argmax 0 = background). Whole-body CTs are
            // typically 30-50% air (parity with the Python TurboPipeline).
            const float thr = (std::min(cfg.lower_bound + cfg.air_margin_hu,
                                        cfg.upper_bound) -
                               cfg.mean) / cfg.std;
            const int64_t bs = 8;
            const int64_t gx = (padded[0] + bs - 1) / bs;
            const int64_t gy = (padded[1] + bs - 1) / bs;
            const int64_t gz = (padded[2] + bs - 1) / bs;
            std::vector<float> bmax(size_t(gx) * gy * gz, -1e30f);
            for (int64_t z = 0; z < padded[2]; ++z)
                for (int64_t y = 0; y < padded[1]; ++y) {
                    const float* row = vol.data() +
                        padded[0] * (y + padded[1] * z);
                    float* brow = bmax.data() +
                        gx * ((y / bs) + gy * (z / bs));
                    for (int64_t x = 0; x < padded[0]; ++x) {
                        float v = row[x];
                        if (v > brow[x / bs]) brow[x / bs] = v;
                    }
                }
            std::vector<std::array<int64_t, 3>> kept;
            for (const auto& s : starts) {
                bool body = false;
                for (int64_t bx = s[0] / bs;
                     bx <= (s[0] + patch[0] - 1) / bs && !body; ++bx)
                    for (int64_t by = s[1] / bs;
                         by <= (s[1] + patch[1] - 1) / bs && !body; ++by)
                        for (int64_t bz = s[2] / bs;
                             bz <= (s[2] + patch[2] - 1) / bs; ++bz)
                            if (bmax[bx + gx * (by + gy * bz)] > thr) {
                                body = true;
                                break;
                            }
                if (body) kept.push_back(s);
            }
            if (!kept.empty()) starts.swap(kept);
        }

        auto crop_tile = [&](size_t slot, const std::array<int64_t, 3>& s) {
            // crop (x fastest in volume) -> row-major (px,py,pz) order
            // expected by the one-channel package
            float* dst = tiles.data() + slot * patch_n;
            for (int i = 0; i < patch[0]; ++i)
                for (int j = 0; j < patch[1]; ++j)
                    for (int k = 0; k < patch[2]; ++k)
                        dst[size_t(i) * patch[1] * patch[2] +
                            size_t(j) * patch[2] + k] =
                            vol[(s[0] + i) +
                                padded[0] * ((s[1] + j) +
                                             padded[1] * (s[2] + k))];
        };
        auto accumulate_tile = [&](size_t slot,
                                   const std::array<int64_t, 3>& s) {
            // logits of slot: (K, px, py, pz), class-major. pjrt_backend.cpp
            // adds all K classes of one voxel before the next voxel; here
            // one class plane at a time, each row of z contiguous in both
            // the tile and the accumulator. Every element gets the same
            // additions in the same tile order, so the sums are the same.
            const float* lg = logits_f32.data() + slot * patch_n * K;
            for (int i = 0; i < patch[0]; ++i)
                for (int j = 0; j < patch[1]; ++j) {
                    const float* g_row = gauss.data() +
                        (size_t(i) * patch[1] + j) * patch[2];
                    float* w_row = wsum.data() + zfast(s[0] + i, s[1] + j, s[2]);
                    for (int k = 0; k < patch[2]; ++k) w_row[k] += g_row[k];
                }
            for (int c = 0; c < K; ++c) {
                float* acc_c = acc.data() + size_t(c) * pvol;
                const float* lg_c = lg + size_t(c) * patch_n;
                for (int i = 0; i < patch[0]; ++i)
                    for (int j = 0; j < patch[1]; ++j) {
                        size_t g = (size_t(i) * patch[1] + j) * patch[2];
                        float* a_row = acc_c + zfast(s[0] + i, s[1] + j, s[2]);
                        for (int k = 0; k < patch[2]; ++k)
                            a_row[k] += gauss[g + k] * lg_c[g + k];
                    }
            }
        };

        for (size_t t0 = 0; t0 < starts.size(); t0 += size_t(B)) {
            size_t n_real = std::min(size_t(B), starts.size() - t0);
            for (size_t b = 0; b < size_t(B); ++b)  // pad by repeating the last
                crop_tile(b, starts[t0 + std::min(b, n_real - 1)]);

            at::Tensor in;
            if (bf16_input_) {
                for (size_t p = 0; p < size_t(B) * patch_n; ++p)
                    tiles_bf16[p] = f32_to_bf16(tiles[p]);
                in = at::from_blob(tiles_bf16.data(), in_dims,
                                   at::TensorOptions().dtype(at::kBFloat16));
            } else {
                in = at::from_blob(tiles.data(), in_dims,
                                   at::TensorOptions().dtype(at::kFloat));
            }
            std::vector<at::Tensor> outs = loader_->run({in.to(device_)});
            if (outs.size() != 1)
                throw std::runtime_error("expected a single-output package");

            // fetch logits (B, K, px, py, pz) as float32
            at::Tensor lg = outs[0].to(at::kFloat).to(at::kCPU).contiguous();
            if (lg.numel() != int64_t(logits_f32.size()))
                throw std::runtime_error(
                    "package output has " + std::to_string(lg.numel()) +
                    " values, expected (tile_batch, num_class, patch)");
            std::memcpy(logits_f32.data(), lg.data_ptr<float>(),
                        logits_f32.size() * sizeof(float));

            for (size_t b = 0; b < n_real; ++b)
                accumulate_tile(b, starts[t0 + b]);
        }

        // normalize + crop padding back off; output layout (K, nx, ny, nz),
        // x fastest
        Logits out;
        out.shape = shape;
        out.num_class = K;
        out.data.resize(size_t(K) * shape[0] * shape[1] * shape[2]);
        for (int c = 0; c < K; ++c)
            for (int64_t i = 0; i < shape[0]; ++i)
                for (int64_t j = 0; j < shape[1]; ++j)
                    for (int64_t k = 0; k < shape[2]; ++k) {
                        size_t v = zfast(i + lo[0], j + lo[1], k + lo[2]);
                        // wsum==0 only where every covering tile was skipped
                        // as air: emit 0 logits everywhere -> argmax 0 =
                        // background (not NaN)
                        out.data[size_t(c) * shape[0] * shape[1] * shape[2] +
                                 i + shape[0] * (j + shape[1] * k)] =
                            wsum[v] > 0.f
                                ? acc[size_t(c) * pvol + v] / wsum[v]
                                : 0.f;
                    }
        return out;
    }

  private:
    at::Device device_;
    bool bf16_input_;
    std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader_;
};

}  // namespace

std::unique_ptr<Backend> make_aoti_backend(const std::string& package_path,
                                           const std::string& device,
                                           const std::string& input_dtype) {
    return std::make_unique<AotiBackend>(package_path, device, input_dtype);
}

}  // namespace fast_nnunet

TORCH_LIBRARY(fnn_torch, m) {
    m.def("instance_norm(Tensor x, Tensor scale, Tensor bias, float eps) "
          "-> Tensor",
          &fast_nnunet::instance_norm);
}
