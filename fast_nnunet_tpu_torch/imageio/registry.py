"""Reader/writer registry (a copy of fast_nnunet_tpu/imageio/registry.py):
dataset.json's ``overwrite_image_reader_writer`` first, then the file
ending. Only the NIfTI reader/writers are ported (with the reference's
SimpleITK/nibabel names for them); the JAX package's NRRD, MHA, TIFF, DICOM
and natural-image readers raise ``NotImplementedError`` (ROADMAP.md §1
item 5)."""
from typing import Optional

from .nifti import (NibabelIO, NibabelIOWithReorient, NiftiIO,
                    NiftiIOWithReorient, SimpleITKIO, SimpleITKIOWithReorient)

_BY_NAME = {cls.__name__: cls for cls in (
    NiftiIO, SimpleITKIO, NibabelIO, NiftiIOWithReorient,
    SimpleITKIOWithReorient, NibabelIOWithReorient)}
#: the JAX package's other reader/writers, by name and file endings
_NOT_PORTED = {"NrrdIO": (".nrrd", ".nhdr"), "MhaIO": (".mha", ".mhd"),
               "Tiff3DIO": (".tif", ".tiff"),
               "NaturalImage2DIO": (".png", ".bmp", ".tif", ".jpg", ".jpeg"),
               "DicomIO": (".dcm", ".dicom")}


def _not_ported(name: str):
    raise NotImplementedError(
        f"reader/writer {name} is not ported (the port reads and writes "
        "NIfTI only; ROADMAP.md §1 item 5)")


def find_reader_writer_by_name(name: str):
    """The plans' ``image_reader_writer`` name -> class."""
    if name in _BY_NAME:
        return _BY_NAME[name]
    if name in _NOT_PORTED:
        _not_ported(name)
    raise KeyError(f"Unknown reader/writer '{name}'. Known: "
                   f"{sorted(_BY_NAME)}")


def determine_reader_writer_from_file_ending(file_ending: str,
                                             allow_nonmatching: bool = False):
    fe = file_ending.lower()
    if not fe.startswith("."):
        fe = "." + fe
    if fe in NiftiIO.supported_file_endings or fe == ".gz":
        return NiftiIO
    for name, endings in _NOT_PORTED.items():
        if fe in endings:
            _not_ported(name)
    if allow_nonmatching:
        return NiftiIO
    raise RuntimeError(f"No reader/writer for file ending {file_ending}")


def determine_reader_writer_from_dataset_json(
        dataset_json: dict, example_file: Optional[str] = None):
    name = dataset_json.get("overwrite_image_reader_writer")
    if name is not None and name != "None" and \
            (name in _BY_NAME or name in _NOT_PORTED):
        return find_reader_writer_by_name(name)
    fe = dataset_json.get("file_ending")
    if fe is None and example_file is not None:
        fe = "." + ".".join(example_file.split(".")[1:])
    return determine_reader_writer_from_file_ending(fe)
