"""The reference's blosc2 ``.b2nd`` case files, read and written — a copy of
fast_nnunet_tpu/utils/b2nd.py, the migration path for a folder that nnU-Net
v2 preprocessed (zstd at clevel 8, byte shuffle).

``read_b2nd`` takes the ``blosc2`` package where it imports. Elsewhere it
decodes the contiguous frame itself, from the c-blosc2 frame and chunk
specs: the msgpack header and its ``b2nd`` metalayer, the int64 offsets
chunk, special-value (all-zero) chunks, and chunks with the 16-byte blosc1
or 32-byte blosc2 header, split or non-split blocks, byte shuffle,
memcpyed data and the zstd or zlib codec. ``write_b2nd`` writes that
subset (tests, and files for the reference). zstd comes from
``utils/zstd.py``; ``msgpack`` and ``blosc2`` are imported in the
functions that use them, and a missing ``msgpack`` raises naming it.
"""
import struct
from typing import List, Optional, Sequence

import numpy as np

from . import zstd

_MAGIC = b"b2frame\x00"

# chunk flag bits (byte 2, shared by the blosc1 and blosc2 chunk layouts)
_FLAG_SHUFFLE = 0x1
_FLAG_MEMCPYED = 0x2
_FLAG_BITSHUFFLE = 0x4
_FLAG_NONSPLIT = 0x10  # blocks are NOT split into per-typesize streams

# version byte (byte 0) decides the header layout: <=2 is the classic
# 16-byte blosc1 header (c-blosc writes 2), >=3 is the 32-byte blosc2
# extended header (c-blosc2 stable writes 5 = BLOSC2_VERSION_FORMAT_STABLE)
_V_BLOSC1 = 2
_V_BLOSC2 = 5

# codec ids live in the upper 3 bits of flags but the NUMBERING DIFFERS
# between the two layouts (c-blosc blosc.h vs c-blosc2 blosc2.h)
_CODECS_V1 = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_CODECS_V2 = {0: "blosclz", 1: "lz4", 2: "lz4hc", 3: "snappy", 4: "zlib",
              5: "zstd"}
_CODEC_ZSTD = 5  # blosc2 extended numbering (what compress_chunk writes)

# blosc2_flags (byte 0x1F) special-value encoding
_SPECIAL_ZERO = 2


def _have_blosc2():
    try:
        import blosc2  # noqa: F401
        return True
    except ImportError:
        return False


def _msgpack():
    try:
        import msgpack
    except ImportError as e:
        raise RuntimeError("the .b2nd frame's header is msgpack: install "
                           "the 'msgpack' package to read or write .b2nd "
                           "files") from e
    return msgpack


# ---------------------------------------------------------------- chunk codec
def _shuffle(data: bytes, typesize: int) -> bytes:
    a = np.frombuffer(data, np.uint8)
    n = len(a) - len(a) % typesize
    core = a[:n].reshape(-1, typesize).T.tobytes()
    return core + a[n:].tobytes()


def _unshuffle(data: bytes, typesize: int) -> bytes:
    a = np.frombuffer(data, np.uint8)
    n = len(a) - len(a) % typesize
    core = a[:n].reshape(typesize, -1).T.tobytes()
    return core + a[n:].tobytes()


def compress_chunk(data: bytes, typesize: int, blocksize: int,
                   clevel: int = 8, shuffle: bool = True) -> bytes:
    """One blosc2 chunk: 32-byte extended header (version 5, the stable
    c-blosc2 layout), zstd, non-split blocks (zstd never splits —
    README_CHUNK_FORMAT.rst flag bit 0x10)."""
    codec = zstd.codec()
    nbytes = len(data)
    nblocks = max(1, -(-nbytes // blocksize))
    blocks = []
    for i in range(nblocks):
        raw = data[i * blocksize:(i + 1) * blocksize]
        if shuffle:
            raw = _shuffle(raw, typesize)
        comp = codec.compress(raw, min(clevel, 19))
        if len(comp) >= len(raw):
            # stored raw: blosc's convention is csize == uncompressed size
            blocks.append((len(raw), raw))
        else:
            blocks.append((len(comp), comp))

    header = bytearray(32)
    header[0] = _V_BLOSC2
    header[1] = 1
    flags = (_CODEC_ZSTD << 5) | _FLAG_NONSPLIT
    if shuffle:
        flags |= _FLAG_SHUFFLE
    header[2] = flags
    header[3] = typesize if typesize < 256 else 0
    struct.pack_into("<i", header, 4, nbytes)
    struct.pack_into("<i", header, 8, blocksize)
    if shuffle:
        # extended-header filter pipeline (bytes 0x10-0x15): blosc2 readers
        # use THIS, not the compat flag bit; shuffle = filter code 1 in the
        # last slot (where c-blosc2 itself registers it)
        header[0x15] = 1
    bstart_section = 4 * nblocks
    payload = bytearray()
    bstarts = []
    base = 32 + bstart_section
    for csize, blob in blocks:
        bstarts.append(base + len(payload))
        payload += struct.pack("<i", csize) + blob
    cbytes = 32 + bstart_section + len(payload)
    struct.pack_into("<i", header, 12, cbytes)
    return bytes(header) + b"".join(struct.pack("<i", s) for s in bstarts) \
        + bytes(payload)


def _chunk_codec_name(version: int, flags: int) -> str:
    table = _CODECS_V1 if version <= _V_BLOSC1 else _CODECS_V2
    return table.get(flags >> 5, f"unknown({flags >> 5})")


def decompress_chunk(chunk: bytes) -> bytes:
    """Inverse of compress_chunk, and a from-spec decoder for real c-blosc /
    c-blosc2 chunks: 16-byte blosc1 headers (version <= 2, e.g. libblosc1
    output — validated against the actual C library in
    tests/fixtures/blosc1_real.npz), 32-byte extended headers (version >= 3),
    memcpyed chunks, split blocks (flag 0x10 clear: typesize streams per
    block), and the zstd/zlib codecs in both layouts' numberings."""
    version, _, flags, typesize = chunk[0], chunk[1], chunk[2], chunk[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", chunk, 4)
    hdr = 16 if version <= _V_BLOSC1 else 32
    if flags & _FLAG_MEMCPYED:
        return bytes(chunk[hdr:hdr + nbytes])
    if version == _V_BLOSC1 and len(chunk) >= 32:
        # disambiguate our own pre-round-4 writer (version byte 2 but a
        # 32-byte extended header): valid bstarts must point past the
        # bstart table and inside cbytes
        nblocks = max(1, -(-nbytes // blocksize))
        (first,) = struct.unpack_from("<i", chunk, 16)
        if not (16 + 4 * nblocks <= first < cbytes):
            hdr = 32
    codec = _chunk_codec_name(
        _V_BLOSC1 if hdr == 16 else max(version, 3), flags)
    if flags & _FLAG_BITSHUFFLE:
        raise NotImplementedError(
            "b2nd decoder: bitshuffle not supported (install blosc2)")
    nblocks = max(1, -(-nbytes // blocksize))
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, hdr)
    if codec == "zstd":
        zc = zstd.codec()
        dec = lambda blob, n: zc.decompress(blob, max_output_size=n)  # noqa: E731
    elif codec == "zlib":
        import zlib
        dec = lambda blob, n: zlib.decompress(blob)  # noqa: E731
    else:
        raise NotImplementedError(
            f"b2nd decoder: codec {codec} not supported (install blosc2)")
    # split mode (flag 0x10 CLEAR): each block holds `typesize` independent
    # csize-prefixed streams (the shuffle lanes), each blocksize/typesize
    # raw bytes; non-split: one stream of the whole block
    nstreams = 1 if (flags & _FLAG_NONSPLIT) or typesize <= 1 else typesize
    out = bytearray()
    for i, bs in enumerate(bstarts):
        bsize = min(blocksize, nbytes - i * blocksize)
        if bsize % nstreams:
            nstreams = 1  # blosc only splits typesize-aligned blocks
        ssize = bsize // nstreams
        pos = bs
        raws = []
        for s in range(nstreams):
            (csize,) = struct.unpack_from("<i", chunk, pos)
            blob = chunk[pos + 4: pos + 4 + abs(csize)]
            pos += 4 + abs(csize)
            if csize < 0 or csize == ssize:
                # stored uncompressed: blosc marks it csize == raw size
                # (negative csize = our own pre-round-4 writer's marker)
                raws.append(bytes(blob))
            else:
                raws.append(dec(blob, ssize))
        raw = b"".join(raws)
        if flags & _FLAG_SHUFFLE:
            raw = _unshuffle(raw, typesize)
        out += raw
    return bytes(out[:nbytes])


# ---------------------------------------------------------------- frame format
def write_b2nd(path: str, array: np.ndarray,
               chunks: Optional[Sequence[int]] = None,
               blocks: Optional[Sequence[int]] = None,
               clevel: int = 8, _compress=None) -> None:
    """Serialize `array` as a blosc2 NDim contiguous frame (subset).
    `_compress(data, typesize, blocksize, clevel)` overrides the chunk
    compressor (used by the fixture generator to embed chunks produced by
    the real C blosc library)."""
    msgpack = _msgpack()
    if _compress is None:
        _compress = compress_chunk
    a = np.ascontiguousarray(array)
    shape = list(a.shape)
    if chunks is None:
        chunks = [min(s, 64) for s in shape]
    if blocks is None:
        blocks = [min(c, 32) for c in chunks]
    chunks = [int(c) for c in chunks]
    blocks = [int(b) for b in blocks]
    typesize = a.dtype.itemsize
    chunk_elems = int(np.prod(chunks))
    block_elems = int(np.prod(blocks))

    # chunk grid iteration (C order)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunks_bin: List[bytes] = []
    for idx in np.ndindex(*grid):
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        sub = np.zeros(chunks, a.dtype)
        sub[tuple(slice(0, x.stop - x.start) for x in sl)] = a[sl]
        chunks_bin.append(_compress(sub.tobytes(), typesize,
                                         block_elems * typesize, clevel))

    # b2nd metalayer: [version, ndim, shape, chunks, blocks, 0, dtype_str]
    meta = msgpack.packb([0, len(shape), shape, chunks, blocks, 0,
                          a.dtype.str])
    metalayers = {"b2nd": meta}

    cbytes = sum(len(c) for c in chunks_bin)
    nbytes = chunk_elems * typesize * len(chunks_bin)
    # offsets chunk: int64 per chunk, memcpyed
    offs, pos = [], 0
    for c in chunks_bin:
        offs.append(pos)
        pos += len(c)
    off_raw = np.asarray(offs, np.int64).tobytes()
    off_chunk = compress_chunk(off_raw, 8, len(off_raw) or 8, clevel=5)

    p = msgpack.Packer()
    # header: msgpack array [magic, header_size, frame_size, flags,
    # nbytes, cbytes, typesize, chunksize, n_chunks, metalayers]
    items = [
        _MAGIC, 0, 0, b"\x00\x00\x00\x00", nbytes, cbytes, typesize,
        chunk_elems * typesize, len(chunks_bin), metalayers,
    ]
    body = b"".join(p.pack(x) for x in items)
    header = b"\x9a" + body  # fixarray(10)
    # patch header_size / frame_size with real values (repack with knowns)
    header_size = len(header)
    frame_size = header_size + cbytes + len(off_chunk)
    items[1] = header_size
    items[2] = frame_size
    body2 = b"".join(p.pack(x) for x in items)
    # msgpack int widths can change; iterate to fixpoint
    while len(body2) + 1 != header_size:
        header_size = len(body2) + 1
        frame_size = header_size + cbytes + len(off_chunk)
        items[1], items[2] = header_size, frame_size
        body2 = b"".join(p.pack(x) for x in items)
    header = b"\x9a" + body2

    with open(path, "wb") as f:
        f.write(header)
        for c in chunks_bin:
            f.write(c)
        f.write(off_chunk)


def _read_b2nd_fallback(path: str) -> np.ndarray:
    msgpack = _msgpack()
    with open(path, "rb") as f:
        buf = f.read()
    unp = msgpack.Unpacker(max_buffer_size=len(buf) + 1)
    unp.feed(buf)
    items = unp.unpack()
    if not (isinstance(items, (list, tuple)) and items
            and items[0][:7] == _MAGIC[:7]):
        raise ValueError(f"{path}: not a b2frame")
    # locate the named fields robustly: ints in order, first dict = metalayers
    ints = [x for x in items[1:] if isinstance(x, int)]
    metalayers = next((x for x in items if isinstance(x, dict)), None)
    header_size, frame_size, nbytes, cbytes, typesize, chunksize, n_chunks = \
        ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]
    if metalayers is None or not any(k in metalayers
                                     for k in ("b2nd", b"b2nd")):
        raise ValueError(f"{path}: no b2nd metalayer (plain frame?)")
    meta = metalayers.get("b2nd", metalayers.get(b"b2nd"))
    mversion, ndim, shape, chunks, blocks, dt_fmt, dt = msgpack.unpackb(meta)
    if isinstance(dt, bytes):
        dt = dt.decode()
    dtype = np.dtype(dt)

    # offsets chunk sits after the data chunks
    off_pos = header_size + cbytes
    off_chunk = buf[off_pos:]
    offsets = np.frombuffer(decompress_chunk(off_chunk), np.int64)[:n_chunks]

    def plausible(pos):
        return (0 <= pos <= len(buf) - 16
                and struct.unpack_from("<i", buf, pos + 12)[0] > 0
                and struct.unpack_from("<i", buf, pos + 4)[0]
                == chunksize)

    out = np.zeros(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for ci, idx in enumerate(np.ndindex(*grid)):
        off = int(offsets[ci])
        if off < 0:  # special-value chunk (blosc2 encodes all-zeros this way)
            continue
        # offsets may be frame-absolute or header-relative depending on the
        # writer; accept whichever lands on a well-formed chunk header
        pos = header_size + off
        if not plausible(pos) and plausible(off):
            pos = off
        chunk = buf[pos:]
        raw = decompress_chunk(chunk)
        sub = np.frombuffer(raw, dtype)[:int(np.prod(chunks))].reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = sub[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out


def read_b2nd(path: str) -> np.ndarray:
    """Load a blosc2 NDim file as a numpy array."""
    if _have_blosc2():
        import blosc2
        return np.asarray(blosc2.open(urlpath=path, mode="r")[...])
    return _read_b2nd_fallback(path)
