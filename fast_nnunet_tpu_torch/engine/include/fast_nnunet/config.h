// INI model config (schema parity with the reference's
// engine/config/fast_nnunet_bone_turbo.ini: [model] file_name/input_name/
// output_name/num_class, [input] patch_size/target_spacing, [preprocessing]
// mean/std/lower_bound/upper_bound, [inference] use_mirroring/step_size/
// use_gaussian).
#pragma once

#include <array>
#include <map>
#include <string>

namespace fast_nnunet {

struct EngineConfig {
    // [model]
    std::string file_name;      // serving endpoint or artifact path
    std::string input_name = "input";
    std::string output_name = "output";
    int num_class = 2;
    // [input]
    std::array<int, 3> patch_size{128, 128, 128};
    std::array<float, 3> target_spacing{1.f, 1.f, 1.f};
    // [preprocessing] (CT windowing + z-score with fingerprint stats)
    float mean = 0.f;
    float std = 1.f;
    float lower_bound = -1000.f;
    float upper_bound = 3000.f;
    // [inference]
    bool use_mirroring = false;
    float step_size = 0.5f;
    bool use_gaussian = true;
    // tiles per device call on the in-process AOTInductor backend; must
    // match the batch dimension the package was exported with (-b)
    int tile_batch = 1;
    // empty-tile skipping: drop tiles whose HU stays below
    // lower_bound + air_margin_hu (whole-body CTs are 30-50% air); voxels
    // covered only by skipped tiles come out background
    bool skip_air_tiles = false;
    float air_margin_hu = 200.f;

    static EngineConfig from_ini(const std::string& path);
};

// generic INI: section -> key -> value
std::map<std::string, std::map<std::string, std::string>>
parse_ini(const std::string& path);

}  // namespace fast_nnunet
