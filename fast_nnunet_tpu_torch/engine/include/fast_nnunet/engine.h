// FastnnUNet::Engine — native inference runtime (capability parity with the
// reference's proprietary TensorRT engine, ref engine/fast_nnunet.cpp:17-27 and
// docs/Engine.md:41-61: set_config(ini) -> set_workspace(dir) -> infer(...)).
// The PyTorch port's copy of engine/include/fast_nnunet/engine.h.
//
// The engine is the native host runtime around the device compute: NIfTI/
// config I/O, CT preprocessing, trilinear resampling, tile-grid planning,
// gaussian-weighted accumulation, argmax and geometry-exact mask export.
// Per volume it makes ONE call into a Backend:
//   - AotiBackend: in-process, libtorch's AOTIModelPackageLoader runs the
//     exporter's AOTInductor package (model_aoti.pt2, weights baked in) on
//     the card (or the CPU), tile batch by tile batch — no daemon
//   - HttpBackend: POST the preprocessed volume to the fast-inference REST API
//     (fast_nnunet_tpu_torch.fast_inference.rest_api) running on the card's host
//   - NullBackend: zero logits, for pipeline testing without a device
#pragma once

#include <array>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "fast_nnunet/config.h"
#include "fast_nnunet/nifti_io.h"

namespace fast_nnunet {

// Logits for a whole preprocessed volume: (num_class, nx, ny, nz), class-major,
// x fastest within a class.
struct Logits {
    std::vector<float> data;
    std::array<int64_t, 3> shape{0, 0, 0};
    int num_class = 0;
};

class Backend {
  public:
    virtual ~Backend() = default;
    // preprocessed: (nx, ny, nz) x fastest; returns per-class logits
    virtual Logits infer_volume(const std::vector<float>& preprocessed,
                                const std::array<int64_t, 3>& shape,
                                const EngineConfig& cfg) = 0;
};

std::unique_ptr<Backend> make_null_backend();
std::unique_ptr<Backend> make_http_backend(const std::string& host, int port);
// In-process AOTInductor runtime: load the exporter's package
// (model_aoti.pt2, export/export_model.py aoti=True) with libtorch's
// AOTIModelPackageLoader on `device` ("cuda" or "cpu", the device the package
// was compiled for) and drive the sliding window from C++. Each tile batch is
// copied to the device in `input_dtype` ("bfloat16" or "float32", the
// export dtype) and its logits are copied back.
std::unique_ptr<Backend> make_aoti_backend(const std::string& package_path,
                                           const std::string& device,
                                           const std::string& input_dtype);

namespace FastnnUNet {

class Engine {
  public:
    void set_config(const std::string& ini_path);
    void set_workspace(const std::string& dir, bool verbose = false,
                       bool keep_intermediates = false);
    void set_backend(std::unique_ptr<Backend> backend);

    // Full pipeline: resample to target spacing -> clip+normalize -> backend
    // inference -> argmax -> resample mask back -> original-geometry result.
    std::vector<uint8_t> infer(const Volume& raw, bool use_sliding_window = true,
                               bool use_mirroring = false,
                               bool use_gaussian = true);

    const EngineConfig& config() const { return config_; }

  private:
    EngineConfig config_;
    std::string workspace_;
    bool verbose_ = false;
    std::unique_ptr<Backend> backend_;
};

}  // namespace FastnnUNet

// host-side numerics shared with tests
std::vector<float> resample_trilinear(const std::vector<float>& src,
                                      const std::array<int64_t, 3>& in_shape,
                                      const std::array<int64_t, 3>& out_shape);
std::vector<uint8_t> resample_mask_nearest(const std::vector<uint8_t>& src,
                                           const std::array<int64_t, 3>& in_shape,
                                           const std::array<int64_t, 3>& out_shape);

}  // namespace fast_nnunet
