#include "fast_nnunet/config.h"

#include <algorithm>
#include <fstream>
#include <sstream>
#include <stdexcept>

namespace fast_nnunet {

namespace {
std::string trim(const std::string& s) {
    auto b = s.find_first_not_of(" \t\r\n");
    auto e = s.find_last_not_of(" \t\r\n");
    return b == std::string::npos ? "" : s.substr(b, e - b + 1);
}

// "(2.0, 0.9765625, 0.9765625)" or "160x96x96" or "160, 96, 96"
template <typename T, size_t N>
std::array<T, N> parse_tuple(std::string v) {
    for (char& c : v)
        if (c == '(' || c == ')' || c == ',' || c == 'x' || c == 'X') c = ' ';
    std::istringstream ss(v);
    std::array<T, N> out{};
    for (size_t i = 0; i < N; ++i)
        if (!(ss >> out[i]))
            throw std::runtime_error("cannot parse tuple from: " + v);
    return out;
}

bool parse_bool(std::string v) {
    std::transform(v.begin(), v.end(), v.begin(), ::tolower);
    return v == "1" || v == "true" || v == "yes" || v == "on";
}
}  // namespace

std::map<std::string, std::map<std::string, std::string>>
parse_ini(const std::string& path) {
    std::ifstream f(path);
    if (!f) throw std::runtime_error("cannot open config " + path);
    std::map<std::string, std::map<std::string, std::string>> out;
    std::string line, section;
    while (std::getline(f, line)) {
        line = trim(line);
        if (line.empty() || line[0] == '#' || line[0] == ';') continue;
        if (line.front() == '[' && line.back() == ']') {
            section = trim(line.substr(1, line.size() - 2));
            continue;
        }
        auto eq = line.find('=');
        if (eq == std::string::npos) continue;
        out[section][trim(line.substr(0, eq))] = trim(line.substr(eq + 1));
    }
    return out;
}

EngineConfig EngineConfig::from_ini(const std::string& path) {
    auto ini = parse_ini(path);
    EngineConfig c;
    auto get = [&](const std::string& sec, const std::string& key,
                   const std::string& dflt) {
        auto s = ini.find(sec);
        if (s == ini.end()) return dflt;
        auto k = s->second.find(key);
        return k == s->second.end() ? dflt : k->second;
    };
    c.file_name = get("model", "file_name", "");
    c.input_name = get("model", "input_name", "input");
    c.output_name = get("model", "output_name", "output");
    c.num_class = std::stoi(get("model", "num_class", "2"));
    if (!get("input", "patch_size", "").empty())
        c.patch_size = parse_tuple<int, 3>(get("input", "patch_size", ""));
    if (!get("input", "target_spacing", "").empty())
        c.target_spacing = parse_tuple<float, 3>(get("input", "target_spacing", ""));
    c.mean = std::stof(get("preprocessing", "mean", "0"));
    // the reference INI spells it std_dev (ref engine/config/
    // fast_nnunet_bone_turbo.ini); accept both
    c.std = std::stof(get("preprocessing", "std",
                          get("preprocessing", "std_dev", "1")));
    c.lower_bound = std::stof(get("preprocessing", "lower_bound", "-1000"));
    c.upper_bound = std::stof(get("preprocessing", "upper_bound", "3000"));
    c.use_mirroring = parse_bool(get("inference", "use_mirroring", "false"));
    c.step_size = std::stof(get("inference", "step_size", "0.5"));
    c.use_gaussian = parse_bool(get("inference", "use_gaussian", "true"));
    c.tile_batch = std::stoi(get("inference", "tile_batch", "1"));
    c.skip_air_tiles = parse_bool(get("inference", "skip_air_tiles", "false"));
    c.air_margin_hu = std::stof(get("inference", "air_margin_hu", "200"));
    return c;
}

}  // namespace fast_nnunet
