"""libdeflate-backed gzip codec for the NIfTI reader and writer (ctypes, no
build step) — the port's copy of fast_nnunet_tpu/utils/fastgz.py.

File I/O on the host, no device: a served request is read -> predict ->
write, and zlib is slow on its two big payloads. The JAX package measured,
on one host core for a 512x512x450 CT: mask gzip, zlib level 1 5.25 s
against libdeflate level 1 0.36 s; CT gunzip, Python gzip 0.80 s against
libdeflate 0.25 s (fast_nnunet_tpu/utils/fastgz.py:7-10).

libdeflate is an all-at-once codec (no streaming state), which fits NIfTI:
the decompressed size is known (the ISIZE trailer), and compression reads
straight out of the numpy buffer with no intermediate ``bytes``.

Loading is best-effort: without the system library (or with
``FNN_NO_LIBDEFLATE=1``) every entry point returns None and callers fall
back to stdlib gzip, so nothing is downloaded or built. Multi-member files
(bgzf, concatenated gzip) are handled by looping
libdeflate_gzip_decompress_ex over the members.
"""
import ctypes
import ctypes.util
import os
import struct
from typing import Optional, Union

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FNN_NO_LIBDEFLATE", "0") == "1":
        return None
    for cand in ("libdeflate.so.0", "libdeflate.so",
                 ctypes.util.find_library("deflate") or ""):
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
            lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
            lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
            lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
            lib.libdeflate_gzip_decompress_ex.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.libdeflate_gzip_compress.restype = ctypes.c_size_t
            lib.libdeflate_gzip_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t]
            lib.libdeflate_gzip_compress_bound.restype = ctypes.c_size_t
            lib.libdeflate_gzip_compress_bound.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t]
            lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
            lib.libdeflate_free_compressor.argtypes = [ctypes.c_void_p]
        except AttributeError:
            continue
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def _isize(raw) -> int:
    """ISIZE trailer of the LAST gzip member: decompressed size mod 2^32.
    Exact for single-member files < 4 GiB (every .nii.gz in practice); the
    decompress loop grows the buffer if it lies."""
    if len(raw) < 18:
        return 0
    return struct.unpack("<I", bytes(raw[-4:]))[0]


def gzip_decompress(raw: Union[bytes, bytearray, memoryview],
                    expected_size: Optional[int] = None
                    ) -> Optional[np.ndarray]:
    """Gzip payload -> writable uint8 array (multi-member safe). None when
    libdeflate is unavailable (caller falls back to stdlib gzip)."""
    lib = _load()
    if lib is None:
        return None
    raw = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) \
        else raw
    d = lib.libdeflate_alloc_decompressor()
    if not d:
        return None
    try:
        cap = int(expected_size) if expected_size else _isize(raw)
        cap = max(cap, 1024, len(raw) * 2)
        out = np.empty(cap, np.uint8)
        in_pos = 0
        out_pos = 0
        n_in = ctypes.c_size_t(0)
        n_out = ctypes.c_size_t(0)
        while in_pos < len(raw):
            rc = lib.libdeflate_gzip_decompress_ex(
                d, raw.ctypes.data + in_pos, len(raw) - in_pos,
                out.ctypes.data + out_pos, out.nbytes - out_pos,
                ctypes.byref(n_in), ctypes.byref(n_out))
            if rc == 3:  # LIBDEFLATE_INSUFFICIENT_SPACE: ISIZE lied -> grow
                grown = np.empty(max(out.nbytes * 2, out.nbytes + len(raw) * 4),
                                 np.uint8)
                grown[:out_pos] = out[:out_pos]
                out = grown
                continue
            if rc != 0:  # BAD_DATA / SHORT_OUTPUT: not our format after all
                return None
            in_pos += n_in.value
            out_pos += n_out.value
            # tolerate trailing zero padding after the last member (some
            # writers block-pad); a valid next member starts 0x1f 0x8b
            if in_pos < len(raw) and not (
                    len(raw) - in_pos >= 2 and raw[in_pos] == 0x1F
                    and raw[in_pos + 1] == 0x8B):
                break
        return out[:out_pos] if out_pos != out.nbytes else out
    finally:
        lib.libdeflate_free_decompressor(d)


def gzip_compress(data, level: int = 1) -> Optional[bytes]:
    """numpy array (any contiguous layout) / bytes -> gzip bytes. None when
    libdeflate is unavailable (caller falls back to stdlib gzip). Reads
    straight from the source buffer — no tobytes() copy."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(data, np.ndarray):
        if data.flags["C_CONTIGUOUS"] or data.flags["F_CONTIGUOUS"]:
            src_ptr, src_len = data.ctypes.data, data.nbytes
            buf_keepalive = data
        else:
            buf_keepalive = np.ascontiguousarray(data)
            src_ptr, src_len = buf_keepalive.ctypes.data, buf_keepalive.nbytes
    else:
        buf_keepalive = bytes(data)
        src_ptr = ctypes.cast(ctypes.c_char_p(buf_keepalive),
                              ctypes.c_void_p).value
        src_len = len(buf_keepalive)
    c = lib.libdeflate_alloc_compressor(int(level))
    if not c:
        return None
    try:
        bound = lib.libdeflate_gzip_compress_bound(c, src_len)
        out = ctypes.create_string_buffer(bound)
        n = lib.libdeflate_gzip_compress(c, src_ptr, src_len, out, bound)
        if n == 0:
            return None
        return out.raw[:n]
    finally:
        lib.libdeflate_free_compressor(c)
        del buf_keepalive
