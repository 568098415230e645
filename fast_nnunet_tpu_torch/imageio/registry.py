"""Reader/writer registry (a copy of fast_nnunet_tpu/imageio/registry.py):
dataset.json's ``overwrite_image_reader_writer`` first, then the file
ending, with the JAX package's precedence (NIfTI, NRRD, MHA, TIFF, natural
image, DICOM: a ``.tif`` is a 3D TIFF stack). The NIfTI reader also answers
to the reference's SimpleITK and nibabel names."""
from typing import Optional

from .dicom import DicomIO
from .mha import MhaIO
from .natural_image import NaturalImage2DIO
from .nifti import (NibabelIO, NibabelIOWithReorient, NiftiIO,
                    NiftiIOWithReorient, SimpleITKIO, SimpleITKIOWithReorient)
from .nrrd import NrrdIO
from .tiff import Tiff3DIO

_BY_NAME = {cls.__name__: cls for cls in (
    NiftiIO, SimpleITKIO, NibabelIO, NiftiIOWithReorient,
    SimpleITKIOWithReorient, NibabelIOWithReorient, NaturalImage2DIO,
    NrrdIO, MhaIO, Tiff3DIO, DicomIO)}


def find_reader_writer_by_name(name: str):
    """The plans' ``image_reader_writer`` name -> class."""
    if name not in _BY_NAME:
        raise KeyError(f"Unknown reader/writer '{name}'. Known: "
                       f"{sorted(_BY_NAME)}")
    return _BY_NAME[name]


def determine_reader_writer_from_file_ending(file_ending: str,
                                             allow_nonmatching: bool = False):
    fe = file_ending.lower()
    if not fe.startswith("."):
        fe = "." + fe
    for cls in (NiftiIO, NrrdIO, MhaIO, Tiff3DIO, NaturalImage2DIO, DicomIO):
        if fe in cls.supported_file_endings or (
                fe == ".gz" and ".nii.gz" in cls.supported_file_endings):
            return cls
    if allow_nonmatching:
        return NiftiIO
    raise RuntimeError(f"No reader/writer for file ending {file_ending}")


def determine_reader_writer_from_dataset_json(
        dataset_json: dict, example_file: Optional[str] = None):
    name = dataset_json.get("overwrite_image_reader_writer")
    if name is not None and name != "None" and name in _BY_NAME:
        return _BY_NAME[name]
    fe = dataset_json.get("file_ending")
    if fe is None and example_file is not None:
        fe = "." + ".".join(example_file.split(".")[1:])
    return determine_reader_writer_from_file_ending(fe)
