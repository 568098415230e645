#include "fast_nnunet/nifti_io.h"

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
// zlib's gz* ABI, declared here where the headers are not installed (the
// shared libz.so.1 is linked either way)
extern "C" {
typedef struct gzFile_s* gzFile;
gzFile gzopen(const char* path, const char* mode);
int gzread(gzFile file, void* buf, unsigned len);
int gzwrite(gzFile file, const void* buf, unsigned len);
int gzclose(gzFile file);
}
#endif

#include <cstring>
#include <fstream>
#include <stdexcept>

namespace fast_nnunet {

namespace {

constexpr size_t kHeaderSize = 348;

std::vector<uint8_t> read_file_maybe_gz(const std::string& path) {
    bool gz = path.size() > 3 && path.compare(path.size() - 3, 3, ".gz") == 0;
    if (!gz) {
        std::ifstream f(path, std::ios::binary);
        if (!f) throw std::runtime_error("cannot open " + path);
        return std::vector<uint8_t>(std::istreambuf_iterator<char>(f), {});
    }
    gzFile g = gzopen(path.c_str(), "rb");
    if (!g) throw std::runtime_error("cannot open " + path);
    std::vector<uint8_t> out;
    uint8_t buf[1 << 16];
    int n;
    while ((n = gzread(g, buf, sizeof(buf))) > 0) out.insert(out.end(), buf, buf + n);
    gzclose(g);
    if (n < 0) throw std::runtime_error("gzip error reading " + path);
    return out;
}

void write_file_maybe_gz(const std::string& path, const std::vector<uint8_t>& bytes) {
    bool gz = path.size() > 3 && path.compare(path.size() - 3, 3, ".gz") == 0;
    if (!gz) {
        std::ofstream f(path, std::ios::binary);
        if (!f) throw std::runtime_error("cannot write " + path);
        f.write(reinterpret_cast<const char*>(bytes.data()), bytes.size());
        return;
    }
    gzFile g = gzopen(path.c_str(), "wb");
    if (!g) throw std::runtime_error("cannot write " + path);
    size_t off = 0;
    while (off < bytes.size()) {
        int chunk = static_cast<int>(std::min<size_t>(bytes.size() - off, 1 << 20));
        if (gzwrite(g, bytes.data() + off, chunk) != chunk) {
            gzclose(g);
            throw std::runtime_error("gzip error writing " + path);
        }
        off += chunk;
    }
    gzclose(g);
}

template <typename T>
T get(const std::vector<uint8_t>& b, size_t off) {
    T v;
    std::memcpy(&v, b.data() + off, sizeof(T));
    return v;
}

template <typename T>
void put(std::vector<uint8_t>& b, size_t off, T v) {
    std::memcpy(b.data() + off, &v, sizeof(T));
}

template <typename T>
void convert_to_float(const std::vector<uint8_t>& raw, size_t off, int64_t n,
                      float slope, float inter, std::vector<float>& out) {
    out.resize(n);
    const T* src = reinterpret_cast<const T*>(raw.data() + off);
    for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<float>(src[i]) * slope + inter;
}

}  // namespace

namespace Data {

Volume LoadData(const std::string& path) {
    if (looks_like_dicom(path)) return LoadDicomSeries(path);
    return LoadNifti(path);
}

Volume LoadNifti(const std::string& path) {
    auto raw = read_file_maybe_gz(path);
    if (raw.size() < kHeaderSize + 4)
        throw std::runtime_error(path + ": too small for NIfTI-1");
    if (get<int32_t>(raw, 0) != 348)
        throw std::runtime_error(path + ": not little-endian NIfTI-1");

    Volume v;
    int16_t ndim = get<int16_t>(raw, 40);
    if (ndim < 3) ndim = 3;
    for (int a = 0; a < 3; ++a) {
        int16_t d = get<int16_t>(raw, 40 + 2 * (a + 1));
        v.shape[a] = d > 0 ? d : 1;
    }
    int64_t extra = 1;
    for (int a = 3; a < ndim && a < 7; ++a) {
        int16_t d = get<int16_t>(raw, 40 + 2 * (a + 1));
        if (d > 1) extra *= d;
    }
    if (extra > 1)
        throw std::runtime_error(path + ": 4D volumes not supported by the engine "
                                        "(split channels first)");
    int16_t datatype = get<int16_t>(raw, 70);
    for (int a = 0; a < 3; ++a) {
        float s = get<float>(raw, 76 + 4 * (a + 1));
        v.spacing[a] = s != 0.f ? std::abs(s) : 1.f;
    }
    float vox_offset = get<float>(raw, 108);
    float slope = get<float>(raw, 112);
    float inter = get<float>(raw, 116);
    if (slope == 0.f) slope = 1.f;

    size_t off = static_cast<size_t>(vox_offset);
    if (off < kHeaderSize) off = kHeaderSize + 4;
    int64_t n = v.voxels();

    switch (datatype) {
        case 2:    convert_to_float<uint8_t>(raw, off, n, slope, inter, v.data); break;
        case 4:    convert_to_float<int16_t>(raw, off, n, slope, inter, v.data); break;
        case 8:    convert_to_float<int32_t>(raw, off, n, slope, inter, v.data); break;
        case 16:   convert_to_float<float>(raw, off, n, slope, inter, v.data); break;
        case 64:   convert_to_float<double>(raw, off, n, slope, inter, v.data); break;
        case 256:  convert_to_float<int8_t>(raw, off, n, slope, inter, v.data); break;
        case 512:  convert_to_float<uint16_t>(raw, off, n, slope, inter, v.data); break;
        default:
            throw std::runtime_error(path + ": unsupported NIfTI datatype " +
                                     std::to_string(datatype));
    }
    v.header.assign(raw.begin(), raw.begin() + kHeaderSize);
    return v;
}

}  // namespace Data

namespace Tools {

void save_mask(const std::vector<uint8_t>& mask, const Volume& like,
               const std::string& path) {
    if (static_cast<int64_t>(mask.size()) != like.voxels())
        throw std::runtime_error("mask size does not match volume geometry");
    std::vector<uint8_t> out(kHeaderSize + 4 + mask.size());
    std::memcpy(out.data(), like.header.data(), kHeaderSize);
    // dim: 3D, original shape
    put<int16_t>(out, 40, 3);
    for (int a = 0; a < 3; ++a)
        put<int16_t>(out, 40 + 2 * (a + 1), static_cast<int16_t>(like.shape[a]));
    for (int a = 3; a < 7; ++a) put<int16_t>(out, 40 + 2 * (a + 1), 1);
    put<int16_t>(out, 70, 2);   // datatype uint8
    put<int16_t>(out, 72, 8);   // bitpix
    put<float>(out, 108, 352.f);  // vox_offset
    put<float>(out, 112, 1.f);    // scl_slope
    put<float>(out, 116, 0.f);    // scl_inter
    std::memcpy(out.data() + 344, "n+1\0", 4);
    std::memcpy(out.data() + kHeaderSize + 4, mask.data(), mask.size());
    write_file_maybe_gz(path, out);
}

}  // namespace Tools

}  // namespace fast_nnunet
