// NIfTI-1 volume I/O (the reference engine's Data::LoadData / Tools::save_mask
// capability, ref engine/fast_nnunet.cpp:5-30 — there backed by ITK/SimpleITK;
// here a self-contained reader/writer with zlib for .nii.gz).
#pragma once

#include <array>
#include <cstdint>
#include <string>
#include <vector>

namespace fast_nnunet {

struct Volume {
    // data in on-disk (i, j, k) index order, i fastest (Fortran order),
    // converted to float32
    std::vector<float> data;
    std::array<int64_t, 3> shape{0, 0, 0};   // (ni, nj, nk)
    std::array<float, 3> spacing{1, 1, 1};   // (si, sj, sk)
    // raw header bytes for geometry-exact round trips
    std::vector<uint8_t> header;

    int64_t voxels() const { return shape[0] * shape[1] * shape[2]; }
    float at(int64_t i, int64_t j, int64_t k) const {
        return data[i + shape[0] * (j + shape[1] * k)];
    }
};

namespace Data {
// Loads .nii/.nii.gz files or a DICOM series (a directory of slices, a .dcm
// file, or any file with the DICM magic — ref engine/fast_nnunet.cpp:5-24,
// fast_nnunet_dicom_convertor.h contract); throws std::runtime_error on
// malformed input.
Volume LoadData(const std::string& path);
// Direct entry points for the two formats.
Volume LoadNifti(const std::string& path);
Volume LoadDicomSeries(const std::string& path);
bool looks_like_dicom(const std::string& path);
}  // namespace Data

namespace Tools {
// Writes a uint8 mask with the original geometry taken from `like`.
void save_mask(const std::vector<uint8_t>& mask, const Volume& like,
               const std::string& path);
}  // namespace Tools

}  // namespace fast_nnunet
