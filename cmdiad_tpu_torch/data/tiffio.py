"""Minimal TIFF codec for MVTec 3D-AD organized point clouds (port copy).

The dataset's .tiff files are float32 (H, W, 3) organized point clouds
written by tifffile (plain little-endian, uncompressed or deflate, stripped).
This module reads the subset that needs: baseline TIFF header parsing, strip
assembly, uncompressed/deflate/PackBits/LZW payloads, the horizontal
predictor, float and int sample formats; and writes uncompressed
single-strip TIFFs (the synthetic-fixture generator's format).  It is a copy
of the JAX package's ``data/tiffio.py`` without that package's native fast
path: the same bytes in give the same array out.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_STRIP_OFFSETS = 273
_TAG_SPP = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PLANAR = 284
_TAG_PREDICTOR = 317
_TAG_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _read_ifd(data: bytes, off: int, en: str) -> Tuple[Dict[int, tuple], int]:
    n = struct.unpack_from(en + "H", data, off)[0]
    tags = {}
    for i in range(n):
        base = off + 2 + i * 12
        tag, typ, count = struct.unpack_from(en + "HHI", data, base)
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            raw = data[base + 8: base + 8 + size]
        else:
            ptr = struct.unpack_from(en + "I", data, base + 8)[0]
            raw = data[ptr: ptr + size]
        if typ in _TYPE_FMT:
            vals = struct.unpack(en + _TYPE_FMT[typ] * count, raw)
        else:
            vals = (raw,)
        tags[tag] = vals
    nxt = struct.unpack_from(en + "I", data, off + 2 + n * 12)[0]
    return tags, nxt


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-flavour LZW (MSB-first; 'early change': the code width grows one
    entry before the table actually fills, i.e. at table size 2^bits - 1)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bitpos = 0
    prev = None
    bits = 9
    n = len(data) * 8
    while bitpos + bits <= n:
        byte = bitpos // 8
        chunk = int.from_bytes(data[byte:byte + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - bits - (bitpos % 8))) & ((1 << bits) - 1)
        bitpos += bits
        if code == 256:  # clear
            table = table[:258]
            bits = 9
            prev = None
            continue
        if code == 257:  # EOI
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) == (1 << bits) - 1 and bits < 12:  # early change
            bits += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def imread(path: str) -> np.ndarray:
    """Read the first IFD of a TIFF file to (H, W[, C]) numpy array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        en = "<"
    elif data[:2] == b"MM":
        en = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, first_ifd = struct.unpack_from(en + "HI", data, 2)
    if magic != 42:
        raise ValueError(f"{path}: unsupported TIFF magic {magic} (bigtiff?)")
    tags, _ = _read_ifd(data, first_ifd, en)

    width = tags[_TAG_WIDTH][0]
    height = tags[_TAG_HEIGHT][0]
    spp = tags.get(_TAG_SPP, (1,))[0]
    bits = tags.get(_TAG_BITS, (1,))[0]
    comp = tags.get(_TAG_COMPRESSION, (1,))[0]
    fmt = tags.get(_TAG_SAMPLE_FORMAT, (1,))[0]
    planar = tags.get(_TAG_PLANAR, (1,))[0]
    predictor = tags.get(_TAG_PREDICTOR, (1,))[0]
    if planar != 1:
        raise ValueError("planar TIFF not supported")

    offsets = tags[_TAG_STRIP_OFFSETS]
    counts = tags[_TAG_STRIP_COUNTS]
    payload = bytearray()
    for off, cnt in zip(offsets, counts):
        strip = bytes(data[off:off + cnt])
        if comp == 1:
            pass
        elif comp in (8, 32946):
            strip = zlib.decompress(strip)
        elif comp == 5:
            strip = _lzw_decode(strip)
        elif comp == 32773:
            strip = _packbits_decode(strip)
        else:
            raise ValueError(f"compression {comp} not supported")
        payload += strip

    dtype = {
        (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
        (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
        (3, 32): np.float32, (3, 64): np.float64,
    }[(fmt, bits)]
    arr = np.frombuffer(bytes(payload), dtype=np.dtype(dtype).newbyteorder(en))
    arr = arr[: height * width * spp].reshape(height, width, spp)
    if predictor == 2:
        arr = np.cumsum(arr, axis=1, dtype=arr.dtype)
    if spp == 1:
        arr = arr[:, :, 0]
    return np.ascontiguousarray(arr)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write (H, W[, C]) float32/uint8/uint16 as uncompressed stripped TIFF."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    fmt = {np.dtype(np.float32): 3, np.dtype(np.float64): 3,
           np.dtype(np.uint8): 1, np.dtype(np.uint16): 1,
           np.dtype(np.int32): 2}[arr.dtype]
    bits = arr.dtype.itemsize * 8
    payload = arr.tobytes()

    tags = [
        (_TAG_WIDTH, 4, 1, w),
        (_TAG_HEIGHT, 4, 1, h),
        (_TAG_BITS, 3, c, None),         # may need external storage
        (_TAG_COMPRESSION, 3, 1, 1),
        (_TAG_PHOTOMETRIC, 3, 1, 1),
        (_TAG_STRIP_OFFSETS, 4, 1, None),
        (_TAG_SPP, 3, 1, c),
        (_TAG_ROWS_PER_STRIP, 4, 1, h),
        (_TAG_STRIP_COUNTS, 4, 1, len(payload)),
        (_TAG_SAMPLE_FORMAT, 3, c, None),
    ]
    header = struct.pack("<2sHI", b"II", 42, 8)
    n = len(tags)
    ifd_size = 2 + n * 12 + 4
    extra = bytearray()
    extra_base = 8 + ifd_size
    entries = b""
    payload_off = None
    for tag, typ, count, val in tags:
        if tag == _TAG_BITS:
            if c * 2 <= 4:
                raw = struct.pack(f"<{c}H", *([bits] * c)).ljust(4, b"\0")
                entries += struct.pack("<HHI4s", tag, typ, count, raw)
            else:
                entries += struct.pack("<HHII", tag, typ, count,
                                       extra_base + len(extra))
                extra += struct.pack(f"<{c}H", *([bits] * c))
        elif tag == _TAG_SAMPLE_FORMAT:
            if c * 2 <= 4:
                raw = struct.pack(f"<{c}H", *([fmt] * c)).ljust(4, b"\0")
                entries += struct.pack("<HHI4s", tag, typ, count, raw)
            else:
                entries += struct.pack("<HHII", tag, typ, count,
                                       extra_base + len(extra))
                extra += struct.pack(f"<{c}H", *([fmt] * c))
        elif tag == _TAG_STRIP_OFFSETS:
            payload_off = len(entries)
            entries += struct.pack("<HHII", tag, typ, count, 0)
        else:
            entries += struct.pack("<HHII", tag, typ, count, val)
    data_start = extra_base + len(extra)
    entries = (entries[:payload_off]
               + struct.pack("<HHII", _TAG_STRIP_OFFSETS, 4, 1, data_start)
               + entries[payload_off + 12:])
    ifd = struct.pack("<H", n) + entries + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(header + ifd + bytes(extra) + payload)
