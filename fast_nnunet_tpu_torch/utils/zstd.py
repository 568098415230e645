"""zstd frames for the ``.fnnz`` and ``.b2nd`` case stores, from whichever
codec the host has: the ``zstandard`` package where it imports, else the
system ``libzstd.so.1`` through ctypes (``ZSTD_compress``,
``ZSTD_decompress``, ``ZSTD_getFrameContentSize``, ``ZSTD_isError``; no
headers and no build step, as ``utils/fastgz.py`` binds libdeflate). Both
write standard zstd frames with the content size in the header, so a frame
written by one decodes with the other. Neither present raises: the stores
have no other codec. ``backend()`` names the codec taken."""
import ctypes
import ctypes.util
import functools
from typing import Optional

_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


class _ZstandardCodec:
    name = "zstandard"

    def __init__(self, module):
        self._m = module

    def compress(self, data, level: int) -> bytes:
        return self._m.ZstdCompressor(level=level).compress(data)

    def decompress(self, frame, max_output_size: int = 0) -> bytes:
        return self._m.ZstdDecompressor().decompress(
            frame, max_output_size=max_output_size)


class _LibzstdCodec:
    name = "libzstd"

    def __init__(self, lib):
        sz, vp, cp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p
        lib.ZSTD_compressBound.argtypes = [sz]
        lib.ZSTD_compressBound.restype = sz
        lib.ZSTD_compress.argtypes = [vp, sz, cp, sz, ctypes.c_int]
        lib.ZSTD_compress.restype = sz
        lib.ZSTD_decompress.argtypes = [vp, sz, cp, sz]
        lib.ZSTD_decompress.restype = sz
        lib.ZSTD_getFrameContentSize.argtypes = [cp, sz]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_isError.argtypes = [sz]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [sz]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        self._lib = lib

    def _check(self, code: int, what: str) -> int:
        if self._lib.ZSTD_isError(code):
            raise ValueError(f"zstd {what}: "
                             f"{self._lib.ZSTD_getErrorName(code).decode()}")
        return code

    def compress(self, data, level: int) -> bytes:
        src = bytes(data)
        cap = self._lib.ZSTD_compressBound(len(src))
        dst = ctypes.create_string_buffer(cap)
        n = self._check(self._lib.ZSTD_compress(dst, cap, src, len(src),
                                                level), "compress")
        return dst.raw[:n]

    def decompress(self, frame, max_output_size: int = 0) -> bytes:
        src = bytes(frame)
        size = self._lib.ZSTD_getFrameContentSize(src, len(src))
        if size == _CONTENTSIZE_ERROR:
            raise ValueError("zstd decompress: not a zstd frame")
        if size == _CONTENTSIZE_UNKNOWN:
            if not max_output_size:
                raise ValueError("zstd decompress: the frame has no content "
                                 "size and no max_output_size was given")
            size = max_output_size
        dst = ctypes.create_string_buffer(max(1, size))
        n = self._check(self._lib.ZSTD_decompress(dst, size, src, len(src)),
                        "decompress")
        return dst.raw[:n]


def _zstandard() -> Optional[_ZstandardCodec]:
    try:
        import zstandard
    except ImportError:
        return None
    return _ZstandardCodec(zstandard)


def _libzstd() -> Optional[_LibzstdCodec]:
    for cand in ("libzstd.so.1", "libzstd.so",
                 ctypes.util.find_library("zstd") or ""):
        if not cand:
            continue
        try:
            return _LibzstdCodec(ctypes.CDLL(cand))
        except (OSError, AttributeError):
            continue
    return None


_CODECS = {"zstandard": _zstandard, "libzstd": _libzstd}


@functools.lru_cache(maxsize=None)
def _load(name: str):
    return _CODECS[name]()


def codec(name: Optional[str] = None):
    """The zstd codec ``name`` (``zstandard`` or ``libzstd``), or by
    default ``zstandard`` where it imports, else the system libzstd.
    Raises ``RuntimeError`` when the named (or every) backend is
    missing."""
    if name is not None:
        if name not in _CODECS:
            raise ValueError(f"unknown zstd backend {name!r}; "
                             f"choose from {sorted(_CODECS)}")
        found = _load(name)
        if found is None:
            raise RuntimeError(f"zstd backend {name!r} is not available "
                               "on this host")
        return found
    for name in _CODECS:
        found = _load(name)
        if found is not None:
            return found
    raise RuntimeError(
        "no zstd codec: install the 'zstandard' package or the system "
        "libzstd (libzstd.so.1); the .fnnz and .b2nd stores need one")


def backend() -> str:
    """The name of the codec :func:`codec` takes on this host."""
    return codec().name


def decompress(frame, max_output_size: int = 0) -> bytes:
    return codec().decompress(frame, max_output_size)
