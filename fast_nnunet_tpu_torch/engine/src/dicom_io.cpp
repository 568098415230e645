// DICOM series loading for the native engine — the fast_nnunet_dicom_convertor
// capability (ref engine/fast_nnunet.cpp:5-24 loads either NIfTI or a DICOM
// series via fast_nnunet_dicom_convertor.h; there backed by ITK/GDCM, here a
// self-contained parser for uncompressed little-endian DICOM, mirroring the
// Python reader fast_nnunet_tpu/imageio/dicom.py slice-for-slice: sort by
// projection of ImagePositionPatient on the slice normal, HU rescale via
// slope/intercept, spacing from PixelSpacing + median slice distance).
//
// Supported transfer syntaxes: Implicit VR LE (1.2.840.10008.1.2) and
// Explicit VR LE (1.2.840.10008.1.2.1). Compressed series must be
// decompressed upstream — same contract as the Python reader.
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

#include "fast_nnunet/nifti_io.h"

namespace fast_nnunet {
namespace {

struct Reader {
    std::vector<uint8_t> buf;
    size_t pos = 0;

    bool eof() const { return pos >= buf.size(); }
    const uint8_t* take(size_t n, const char* what) {
        if (pos + n > buf.size())
            throw std::runtime_error(std::string("truncated DICOM ") + what);
        const uint8_t* p = buf.data() + pos;
        pos += n;
        return p;
    }
    template <typename T>
    T get() {
        T v;
        std::memcpy(&v, take(sizeof(T), "scalar"), sizeof(T));
        return v;
    }
    void skip(size_t n) { pos = std::min(buf.size(), pos + n); }
};

bool is_long_vr(const char* vr) {
    static const char* kLong[] = {"OB", "OW", "OF", "OL", "OD", "SQ",
                                  "UC", "UR", "UT", "UN"};
    for (const char* v : kLong)
        if (vr[0] == v[0] && vr[1] == v[1]) return true;
    return false;
}

// multi-valued decimal string "a\\b\\c"
std::vector<double> decode_floats(const std::vector<uint8_t>& raw) {
    std::string s(raw.begin(), raw.end());
    std::vector<double> out;
    size_t start = 0;
    while (start <= s.size()) {
        size_t end = s.find('\\', start);
        std::string tok = s.substr(
            start, end == std::string::npos ? std::string::npos : end - start);
        // strip NUL/space padding
        while (!tok.empty() && (tok.back() == '\0' || tok.back() == ' '))
            tok.pop_back();
        while (!tok.empty() && tok.front() == ' ') tok.erase(tok.begin());
        if (!tok.empty()) out.push_back(std::stod(tok));
        if (end == std::string::npos) break;
        start = end + 1;
    }
    return out;
}

struct Slice {
    std::vector<float> pixels;  // rows*cols, row-major (y, x)
    int rows = 0, cols = 0;
    std::array<double, 3> position{0, 0, 0};
    std::array<double, 6> orientation{1, 0, 0, 0, 1, 0};
    double spacing_y = 1, spacing_x = 1, thickness = 1;
    long instance = -1;
};

void skip_undefined_sequence(Reader& r) {
    while (true) {
        uint16_t group = r.get<uint16_t>();
        uint16_t elem = r.get<uint16_t>();
        uint32_t length = r.get<uint32_t>();
        if (group == 0xFFFE && elem == 0xE0DD) return;
        if (group == 0xFFFE && elem == 0xE000) {
            if (length == 0xFFFFFFFF) {
                while (true) {
                    uint16_t g2 = r.get<uint16_t>();
                    uint16_t e2 = r.get<uint16_t>();
                    uint32_t l2 = r.get<uint32_t>();
                    if (g2 == 0xFFFE && e2 == 0xE00D) break;
                    r.skip(l2);
                }
            } else {
                r.skip(length);
            }
        } else {
            throw std::runtime_error("malformed DICOM sequence");
        }
    }
}

Slice read_slice(const std::string& fname) {
    std::ifstream f(fname, std::ios::binary);
    if (!f) throw std::runtime_error("cannot open " + fname);
    Reader r;
    r.buf.assign(std::istreambuf_iterator<char>(f),
                 std::istreambuf_iterator<char>());

    bool explicit_vr = true;
    std::string ts;
    if (r.buf.size() >= 132 && std::memcmp(r.buf.data() + 128, "DICM", 4) == 0) {
        r.pos = 132;
        // file meta group (0002,...): always explicit little endian
        while (!r.eof()) {
            size_t mark = r.pos;
            uint16_t group = r.get<uint16_t>();
            uint16_t elem = r.get<uint16_t>();
            if (group != 0x0002) {
                r.pos = mark;
                break;
            }
            const uint8_t* vrp = r.take(2, "VR");
            char vr[2] = {char(vrp[0]), char(vrp[1])};
            uint32_t length;
            if (is_long_vr(vr)) {
                r.skip(2);
                length = r.get<uint32_t>();
            } else {
                length = r.get<uint16_t>();
            }
            const uint8_t* val = r.take(length, "meta value");
            if (elem == 0x0010) {
                ts.assign(val, val + length);
                while (!ts.empty() && (ts.back() == '\0' || ts.back() == ' '))
                    ts.pop_back();
            }
        }
        if (ts == "1.2.840.10008.1.2")
            explicit_vr = false;
        else if (ts.empty() || ts == "1.2.840.10008.1.2.1")
            explicit_vr = true;
        else
            throw std::runtime_error(
                "unsupported (compressed?) DICOM transfer syntax " + ts +
                " in " + fname + "; decompress the series first");
    } else {
        r.pos = 0;  // headerless implicit-VR stream
        explicit_vr = false;
    }

    Slice s;
    std::map<uint32_t, std::vector<uint8_t>> el;
    uint16_t bits = 16, pixel_rep = 0;
    bool have_pixels = false;
    while (!r.eof()) {
        if (r.pos + 8 > r.buf.size()) break;
        uint16_t group = r.get<uint16_t>();
        uint16_t elem = r.get<uint16_t>();
        uint32_t length;
        if (explicit_vr && group != 0xFFFE) {
            const uint8_t* vrp = r.take(2, "VR");
            char vr[2] = {char(vrp[0]), char(vrp[1])};
            if (is_long_vr(vr)) {
                r.skip(2);
                length = r.get<uint32_t>();
            } else {
                length = r.get<uint16_t>();
            }
        } else {
            length = r.get<uint32_t>();
        }
        if (length == 0xFFFFFFFF) {
            skip_undefined_sequence(r);
            continue;
        }
        uint32_t tag = (uint32_t(group) << 16) | elem;
        switch (tag) {
            case 0x00180050: case 0x00180088: case 0x00200013:
            case 0x00200032: case 0x00200037: case 0x00280030:
            case 0x00281052: case 0x00281053: {
                const uint8_t* v = r.take(length, "value");
                el[tag].assign(v, v + length);
                break;
            }
            case 0x00280010:
                s.rows = *reinterpret_cast<const uint16_t*>(r.take(length, "rows"));
                break;
            case 0x00280011:
                s.cols = *reinterpret_cast<const uint16_t*>(r.take(length, "cols"));
                break;
            case 0x00280100:
                bits = *reinterpret_cast<const uint16_t*>(r.take(length, "bits"));
                break;
            case 0x00280103:
                pixel_rep =
                    *reinterpret_cast<const uint16_t*>(r.take(length, "rep"));
                break;
            case 0x7FE00010: {
                const uint8_t* v = r.take(length, "pixel data");
                size_t n = size_t(s.rows) * s.cols;
                if ((bits == 16 && length < n * 2) || (bits == 8 && length < n))
                    throw std::runtime_error("short PixelData in " + fname);
                s.pixels.resize(n);
                if (bits == 16 && pixel_rep == 1) {
                    auto* p = reinterpret_cast<const int16_t*>(v);
                    for (size_t i = 0; i < n; ++i) s.pixels[i] = float(p[i]);
                } else if (bits == 16) {
                    auto* p = reinterpret_cast<const uint16_t*>(v);
                    for (size_t i = 0; i < n; ++i) s.pixels[i] = float(p[i]);
                } else if (bits == 8 && pixel_rep == 1) {
                    auto* p = reinterpret_cast<const int8_t*>(v);
                    for (size_t i = 0; i < n; ++i) s.pixels[i] = float(p[i]);
                } else if (bits == 8) {
                    for (size_t i = 0; i < n; ++i) s.pixels[i] = float(v[i]);
                } else {
                    throw std::runtime_error("unsupported BitsAllocated in " +
                                             fname);
                }
                have_pixels = true;
                break;
            }
            default:
                r.skip(length);
        }
        if (have_pixels) break;  // PixelData is last in practice
    }
    if (!have_pixels || s.rows == 0 || s.cols == 0)
        throw std::runtime_error("no image in DICOM file " + fname);

    auto fl = [&](uint32_t tag, std::vector<double> dflt) {
        auto it = el.find(tag);
        if (it == el.end()) return dflt;
        auto v = decode_floats(it->second);
        return v.empty() ? dflt : v;
    };
    double slope = fl(0x00281053, {1.0})[0];
    double intercept = fl(0x00281052, {0.0})[0];
    if (slope != 1.0 || intercept != 0.0)
        for (float& p : s.pixels) p = float(p * slope + intercept);

    auto ipp = fl(0x00200032, {0, 0, 0});
    auto iop = fl(0x00200037, {1, 0, 0, 0, 1, 0});
    auto ps = fl(0x00280030, {1, 1});
    for (int i = 0; i < 3; ++i) s.position[i] = ipp[i];
    for (int i = 0; i < 6; ++i) s.orientation[i] = iop[i];
    s.spacing_y = ps[0];
    s.spacing_x = ps.size() > 1 ? ps[1] : ps[0];
    s.thickness = fl(0x00180088, fl(0x00180050, {1.0}))[0];
    auto inst = fl(0x00200013, {});
    if (!inst.empty()) s.instance = long(inst[0]);
    return s;
}

// minimal NIfTI-1 header so Tools::save_mask can write DICOM-derived volumes
std::vector<uint8_t> synth_nifti_header(const Volume& v) {
    std::vector<uint8_t> h(348, 0);
    auto put = [&](size_t off, auto val) {
        std::memcpy(h.data() + off, &val, sizeof(val));
    };
    put(0, int32_t(348));
    put(40, int16_t(3));
    for (int a = 0; a < 3; ++a) put(size_t(40 + 2 * (a + 1)),
                                    int16_t(v.shape[a]));
    put(70, int16_t(16));  // float32 (rewritten by save_mask)
    put(72, int16_t(32));
    put(76, 1.f);  // pixdim[0]
    for (int a = 0; a < 3; ++a) put(size_t(76 + 4 * (a + 1)), v.spacing[a]);
    put(108, 352.f);
    put(112, 1.f);
    // sform: scaled identity (geometry beyond spacing lives in the DICOM)
    put(252, int16_t(1));  // sform_code
    put(280, v.spacing[0]);
    put(296 + 4, v.spacing[1]);
    put(312 + 8, v.spacing[2]);
    std::memcpy(h.data() + 344, "n+1\0", 4);
    return h;
}

}  // namespace

namespace Data {

bool looks_like_dicom(const std::string& path) {
    namespace fs = std::filesystem;
    if (fs::is_directory(path)) return true;
    if (path.size() > 4 &&
        path.compare(path.size() - 4, 4, ".dcm") == 0) return true;
    std::ifstream f(path, std::ios::binary);
    char pre[132];
    return f.read(pre, 132) && std::memcmp(pre + 128, "DICM", 4) == 0;
}

Volume LoadDicomSeries(const std::string& path) {
    namespace fs = std::filesystem;
    std::vector<std::string> files;
    if (fs::is_directory(path)) {
        for (const auto& e : fs::directory_iterator(path)) {
            if (!e.is_regular_file()) continue;
            std::string name = e.path().filename().string();
            if (!name.empty() && name[0] != '.')
                files.push_back(e.path().string());
        }
        std::sort(files.begin(), files.end());
    } else {
        files.push_back(path);
    }
    if (files.empty())
        throw std::runtime_error("empty DICOM series folder " + path);

    std::vector<Slice> slices;
    slices.reserve(files.size());
    for (const auto& f : files) slices.push_back(read_slice(f));

    // sort by projection of ImagePositionPatient onto the slice normal
    const auto& o = slices[0].orientation;
    std::array<double, 3> normal = {o[1] * o[5] - o[2] * o[4],
                                    o[2] * o[3] - o[0] * o[5],
                                    o[0] * o[4] - o[1] * o[3]};
    std::vector<double> keys(slices.size());
    bool distinct = true;
    for (size_t i = 0; i < slices.size(); ++i) {
        keys[i] = slices[i].position[0] * normal[0] +
                  slices[i].position[1] * normal[1] +
                  slices[i].position[2] * normal[2];
        for (size_t j = 0; j < i; ++j)
            if (keys[j] == keys[i]) distinct = false;
    }
    if (!distinct) {
        bool all_inst = true;
        for (const auto& s : slices) all_inst &= s.instance >= 0;
        if (all_inst)
            for (size_t i = 0; i < slices.size(); ++i)
                keys[i] = double(slices[i].instance);
    }
    std::vector<size_t> order(slices.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](size_t a, size_t b) { return keys[a] < keys[b]; });

    const int rows = slices[0].rows, cols = slices[0].cols;
    for (const auto& s : slices)
        if (s.rows != rows || s.cols != cols)
            throw std::runtime_error("inconsistent slice shapes in " + path);

    Volume v;
    v.shape = {cols, rows, int64_t(slices.size())};  // (X, Y, Z), i fastest
    double dz = slices[0].thickness;
    if (slices.size() > 1) {
        std::vector<double> diffs;
        for (size_t k = 1; k < order.size(); ++k)
            diffs.push_back(keys[order[k]] - keys[order[k - 1]]);
        std::nth_element(diffs.begin(), diffs.begin() + diffs.size() / 2,
                         diffs.end());
        double med = diffs[diffs.size() / 2];
        if (std::isfinite(med) && med > 0) dz = med;
    }
    v.spacing = {float(slices[0].spacing_x), float(slices[0].spacing_y),
                 float(std::fabs(dz))};
    v.data.resize(v.voxels());
    for (size_t zi = 0; zi < order.size(); ++zi) {
        const Slice& s = slices[order[zi]];
        for (int y = 0; y < rows; ++y)
            for (int x = 0; x < cols; ++x)
                v.data[x + int64_t(cols) * (y + int64_t(rows) * zi)] =
                    s.pixels[size_t(y) * cols + x];
    }
    v.header = synth_nifti_header(v);
    return v;
}

}  // namespace Data
}  // namespace fast_nnunet
