// The PyTorch port's copy of engine/src/engine.cpp (its argmax runs class by
// class; the results are the same).
#include "fast_nnunet/engine.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <iostream>
#include <stdexcept>

namespace fast_nnunet {

namespace {
inline int64_t idx3(int64_t i, int64_t j, int64_t k,
                    const std::array<int64_t, 3>& s) {
    return i + s[0] * (j + s[1] * k);
}
}  // namespace

std::vector<float> resample_trilinear(const std::vector<float>& src,
                                      const std::array<int64_t, 3>& in_shape,
                                      const std::array<int64_t, 3>& out_shape) {
    std::vector<float> out(out_shape[0] * out_shape[1] * out_shape[2]);
    std::array<double, 3> scale;
    for (int a = 0; a < 3; ++a)
        scale[a] = static_cast<double>(in_shape[a]) / out_shape[a];
    for (int64_t k = 0; k < out_shape[2]; ++k) {
        double zk = scale[2] * (k + 0.5) - 0.5;  // pixel-center alignment
        int64_t k0 = std::clamp<int64_t>(static_cast<int64_t>(std::floor(zk)), 0,
                                         in_shape[2] - 1);
        int64_t k1 = std::min<int64_t>(k0 + 1, in_shape[2] - 1);
        double fk = std::clamp(zk - k0, 0.0, 1.0);
        for (int64_t j = 0; j < out_shape[1]; ++j) {
            double yj = scale[1] * (j + 0.5) - 0.5;
            int64_t j0 = std::clamp<int64_t>(static_cast<int64_t>(std::floor(yj)),
                                             0, in_shape[1] - 1);
            int64_t j1 = std::min<int64_t>(j0 + 1, in_shape[1] - 1);
            double fj = std::clamp(yj - j0, 0.0, 1.0);
            for (int64_t i = 0; i < out_shape[0]; ++i) {
                double xi = scale[0] * (i + 0.5) - 0.5;
                int64_t i0 = std::clamp<int64_t>(
                    static_cast<int64_t>(std::floor(xi)), 0, in_shape[0] - 1);
                int64_t i1 = std::min<int64_t>(i0 + 1, in_shape[0] - 1);
                double fi = std::clamp(xi - i0, 0.0, 1.0);
                double c00 = src[idx3(i0, j0, k0, in_shape)] * (1 - fi) +
                             src[idx3(i1, j0, k0, in_shape)] * fi;
                double c10 = src[idx3(i0, j1, k0, in_shape)] * (1 - fi) +
                             src[idx3(i1, j1, k0, in_shape)] * fi;
                double c01 = src[idx3(i0, j0, k1, in_shape)] * (1 - fi) +
                             src[idx3(i1, j0, k1, in_shape)] * fi;
                double c11 = src[idx3(i0, j1, k1, in_shape)] * (1 - fi) +
                             src[idx3(i1, j1, k1, in_shape)] * fi;
                double c0 = c00 * (1 - fj) + c10 * fj;
                double c1 = c01 * (1 - fj) + c11 * fj;
                out[idx3(i, j, k, out_shape)] =
                    static_cast<float>(c0 * (1 - fk) + c1 * fk);
            }
        }
    }
    return out;
}

std::vector<uint8_t> resample_mask_nearest(const std::vector<uint8_t>& src,
                                           const std::array<int64_t, 3>& in_shape,
                                           const std::array<int64_t, 3>& out_shape) {
    std::vector<uint8_t> out(out_shape[0] * out_shape[1] * out_shape[2]);
    std::array<double, 3> scale;
    for (int a = 0; a < 3; ++a)
        scale[a] = static_cast<double>(in_shape[a]) / out_shape[a];
    for (int64_t k = 0; k < out_shape[2]; ++k) {
        int64_t sk = std::clamp<int64_t>(
            static_cast<int64_t>(std::lround(scale[2] * (k + 0.5) - 0.5)), 0,
            in_shape[2] - 1);
        for (int64_t j = 0; j < out_shape[1]; ++j) {
            int64_t sj = std::clamp<int64_t>(
                static_cast<int64_t>(std::lround(scale[1] * (j + 0.5) - 0.5)), 0,
                in_shape[1] - 1);
            for (int64_t i = 0; i < out_shape[0]; ++i) {
                int64_t si = std::clamp<int64_t>(
                    static_cast<int64_t>(std::lround(scale[0] * (i + 0.5) - 0.5)),
                    0, in_shape[0] - 1);
                out[idx3(i, j, k, out_shape)] = src[idx3(si, sj, sk, in_shape)];
            }
        }
    }
    return out;
}

class NullBackend : public Backend {
  public:
    Logits infer_volume(const std::vector<float>& pre,
                        const std::array<int64_t, 3>& shape,
                        const EngineConfig& cfg) override {
        Logits l;
        l.shape = shape;
        l.num_class = cfg.num_class;
        l.data.assign(static_cast<size_t>(cfg.num_class) * shape[0] * shape[1] *
                          shape[2],
                      0.f);
        // class 0 wins everywhere
        std::fill(l.data.begin(), l.data.begin() + shape[0] * shape[1] * shape[2],
                  1.f);
        return l;
    }
};

std::unique_ptr<Backend> make_null_backend() {
    return std::make_unique<NullBackend>();
}

namespace FastnnUNet {

void Engine::set_config(const std::string& ini_path) {
    config_ = EngineConfig::from_ini(ini_path);
    if (!backend_) backend_ = make_null_backend();
}

void Engine::set_workspace(const std::string& dir, bool verbose,
                           bool keep_intermediates) {
    workspace_ = dir;
    verbose_ = verbose;
    (void)keep_intermediates;
}

void Engine::set_backend(std::unique_ptr<Backend> backend) {
    backend_ = std::move(backend);
}

std::vector<uint8_t> Engine::infer(const Volume& raw, bool use_sliding_window,
                                   bool use_mirroring, bool use_gaussian) {
    (void)use_sliding_window;  // tiling happens device-side in the backend
    (void)use_mirroring;
    (void)use_gaussian;
    // 1) resample to target spacing (pixel-center aligned trilinear)
    std::array<int64_t, 3> new_shape;
    for (int a = 0; a < 3; ++a)
        new_shape[a] = std::max<int64_t>(
            1, static_cast<int64_t>(std::llround(
                   raw.spacing[a] / config_.target_spacing[a] * raw.shape[a])));
    std::vector<float> resampled =
        resample_trilinear(raw.data, raw.shape, new_shape);

    // 2) CT windowing + z-score with fingerprint stats (CTNormalization parity)
    const float lo = config_.lower_bound, hi = config_.upper_bound;
    const float mean = config_.mean, inv_std = 1.f / std::max(config_.std, 1e-8f);
    for (float& v : resampled)
        v = (std::clamp(v, lo, hi) - mean) * inv_std;

    if (verbose_)
        std::cerr << "[engine] resampled " << raw.shape[0] << "x" << raw.shape[1]
                  << "x" << raw.shape[2] << " -> " << new_shape[0] << "x"
                  << new_shape[1] << "x" << new_shape[2] << "\n";

    // 3) device inference (one call; the jitted sliding window runs there)
    Logits logits = backend_->infer_volume(resampled, new_shape, config_);
    if (logits.shape != new_shape || logits.num_class != config_.num_class)
        throw std::runtime_error("backend returned mismatched logits geometry");

    // 4) argmax, class plane by class plane (engine/src/engine.cpp runs the
    // classes innermost: the same comparisons, the first maximum kept)
    int64_t n = new_shape[0] * new_shape[1] * new_shape[2];
    std::vector<uint8_t> mask(n, 0);
    std::vector<float> best(logits.data.begin(), logits.data.begin() + n);
    for (int c = 1; c < logits.num_class; ++c) {
        const float* plane = logits.data.data() + static_cast<size_t>(c) * n;
        for (int64_t v = 0; v < n; ++v)
            if (plane[v] > best[v]) {
                best[v] = plane[v];
                mask[v] = static_cast<uint8_t>(c);
            }
    }

    // 5) back to original geometry
    return resample_mask_nearest(mask, new_shape, raw.shape);
}

}  // namespace FastnnUNet
}  // namespace fast_nnunet
