"""PNG codec on ``zlib`` and numpy, decoding to Pillow's arrays.

The data layer reads the dataset's PNGs without Pillow.  ``imread(path,
mode)`` gives the array that ``np.asarray(PIL.Image.open(path).convert(mode))``
gives, for ``mode`` "RGB" or "L":

  * every chunk's CRC is checked, the IDAT chunks are concatenated and
    inflated, and all five row filters (None, Sub, Up, Average, Paeth) are
    undone;
  * colour types 0 (greyscale at 1, 2, 4 or 8 bits, scaled to 8 bits as
    Pillow's unpackers do: 1 -> 255, 2 -> 85, 4 -> 17 a step), 2 (RGB),
    3 (palette at 1, 2, 4 or 8 bits, looked up in PLTE), 4 (grey + alpha)
    and 6 (RGBA), all at 8 bits a sample;
  * conversion follows Pillow's ``convert``: alpha is dropped, greyscale is
    replicated to RGB, and RGB (also a palette's RGB) goes to L by
    ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``;
  * Adam7 interlacing and 16-bit samples raise ``NotImplementedError``
    naming the file.

``encode``/``imwrite`` write 8-bit L or RGB with one filter a row chosen
by the least sum of absolute (signed) filtered bytes, the usual adaptive
heuristic, so written files can carry all five filter types.

Undoing Average and Paeth is sequential along a row (each pixel needs its
decoded left neighbour) and across rows (it needs the decoded row above).
Rows filtered with None or Sub need no other row and are undone at once;
the remaining rows are undone in one sweep over anti-diagonals: the pixel
(r, x) of a run of dependent rows needs only (r, x-1), (r-1, x) and
(r-1, x-1), so every pixel on one anti-diagonal of every run is decoded by
one vectorised step, about (longest run + width) steps an image.  Those
steps are small numpy calls, each of which lets go of the GIL and takes it
back; several loader threads sweeping at once hand the GIL to each other at
every step and run slower together than one thread alone, so one lock lets
one thread sweep at a time while the others inflate, resize and read TIFFs
(``loader_bench.py`` times the loader with and without it).
"""

from __future__ import annotations

import struct
import threading
import zlib
from pathlib import Path
from typing import Iterator, Tuple, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_SWEEP_LOCK = threading.Lock()


def _chunks(data: bytes, name: str) -> Iterator[Tuple[bytes, bytes]]:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: CRC mismatch in the {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end
    raise ValueError(f"{name}: no IEND chunk")


def _parse(data: bytes, name: str):
    """-> (header dict, palette (n, 3) uint8 or None, inflated IDAT bytes)."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            header = dict(width=w, height=h, depth=depth, color=color,
                          interlace=interlace)
            if comp != 0 or filt != 0:
                raise ValueError(f"{name}: unknown compression or filter method")
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    color, depth = header["color"], header["depth"]
    if header["interlace"]:
        raise NotImplementedError(f"{name}: Adam7-interlaced PNG is not supported")
    if depth == 16:
        raise NotImplementedError(f"{name}: 16-bit PNG is not supported")
    if color not in _CHANNELS or depth not in (1, 2, 4, 8) or (
            color not in (0, 3) and depth != 8):
        raise ValueError(f"{name}: colour type {color} at {depth} bits is not a PNG kind")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    return header, palette, zlib.decompress(b"".join(idat))


def _paeth(a, b, c):
    """PNG's Paeth predictor on int16 arrays."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: filt (H, stride) uint8, ftypes (H,) -> (H, stride)."""
    h, stride = filt.shape
    npix = stride // bpp
    # int16 work image, (row, pixel, byte), with a zero row above the image
    # and a zero pixel left of each row
    buf = np.zeros((h + 1, npix + 1, bpp), np.int16)
    raw = filt.reshape(h, npix, bpp)
    none, sub = ftypes == 0, ftypes == 1
    buf[1:][none, 1:] = raw[none]
    buf[1:][sub, 1:] = np.cumsum(raw[sub], axis=1, dtype=np.uint8)  # wraps mod 256
    rows = np.nonzero(ftypes >= 2)[0]
    if rows.size:
        # each dependent row's index within its run (a run starts after a
        # None or Sub row, or at the top of the image); its pixel x is
        # decoded at step local + x
        starts = np.ones(rows.size, bool)
        starts[1:] = rows[1:] != rows[:-1] + 1
        local = np.arange(rows.size) - np.maximum.accumulate(
            np.where(starts, np.arange(rows.size), 0))
        n_keys = 3 * (int(local.max()) + npix)
        # every dependent pixel, bucketed by (step, filter type); numpy's
        # stable sort of 16-bit keys is a radix sort
        key = ((local[:, None] + np.arange(npix)) * 3
               + (ftypes[rows, None].astype(np.int64) - 2)).ravel()
        order = np.argsort(key.astype(np.uint16 if n_keys <= 1 << 16 else np.int64),
                           kind="stable")
        pos = ((rows[:, None] + 1) * (npix + 1) + 1 + np.arange(npix)).ravel()[order]
        vals = raw[rows].reshape(-1, bpp)[order].astype(np.int16)
        up, left = pos - (npix + 1), pos - 1
        upleft = up - 1
        bounds = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=n_keys))]).tolist()
        pix = buf.reshape(-1, bpp)
        for k in range(n_keys):
            s0, s1 = bounds[k], bounds[k + 1]
            if s0 == s1:
                continue
            t = k % 3 + 2
            pred = np.take(pix, up[s0:s1], axis=0)          # Up
            if t == 3:                                       # Average
                pred += np.take(pix, left[s0:s1], axis=0)
                pred >>= 1
            elif t == 4:                                     # Paeth
                pred = _paeth(np.take(pix, left[s0:s1], axis=0), pred,
                              np.take(pix, upleft[s0:s1], axis=0))
            pred += vals[s0:s1]
            pred &= 255
            pix[pos[s0:s1]] = pred
    return buf[1:, 1:].reshape(h, stride).astype(np.uint8)


def _filtered_rows(header, raw: bytes, name: str) -> np.ndarray:
    """-> (H, 1 + stride) uint8: each row's filter type, then its bytes."""
    h = header["height"]
    bits = _CHANNELS[header["color"]] * header["depth"]
    stride = (header["width"] * bits + 7) // 8
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{name}: image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    if (rows[:, 0] > 4).any():
        raise ValueError(f"{name}: unknown row filter type {int(rows[:, 0].max())}")
    return rows


def _samples(header, rows: np.ndarray) -> np.ndarray:
    """Unfiltered rows -> (H, W, channels) uint8 samples (palette indices
    and low-depth grey values still unscaled)."""
    h, w, depth = header["height"], header["width"], header["depth"]
    ch = _CHANNELS[header["color"]]
    if depth == 8:
        return rows.reshape(h, w, ch)
    per_byte = 8 // depth
    shifts = (8 - depth * (np.arange(per_byte) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def decode(data: bytes, mode: str = "RGB", name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 for ``mode='RGB'``, (H, W) for 'L'."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode must be 'RGB' or 'L', not {mode!r}")
    header, palette, raw = _parse(data, name)
    rows = _filtered_rows(header, raw, name)
    bpp = max(_CHANNELS[header["color"]] * header["depth"] // 8, 1)
    with _SWEEP_LOCK:
        unfiltered = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    s = _samples(header, unfiltered)
    color = header["color"]
    if color == 3:
        if int(s.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index beyond the PLTE chunk")
        rgb = palette[s[..., 0]]
        return rgb if mode == "RGB" else luma(rgb)
    if color in (2, 6):
        rgb = s[..., :3]
        return np.ascontiguousarray(rgb) if mode == "RGB" else luma(rgb)
    grey = s[..., 0]
    if header["depth"] < 8:
        grey = grey * np.uint8(255 // ((1 << header["depth"]) - 1))
    grey = np.ascontiguousarray(grey)
    return np.repeat(grey[..., None], 3, axis=2) if mode == "RGB" else grey


def row_filters(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The filter type of every row of a PNG, in order."""
    header, _, raw = _parse(data, name)
    return _filtered_rows(header, raw, name)[:, 0].copy()


def imread(path: Union[str, Path], mode: str = "RGB") -> np.ndarray:
    """Read a PNG file as Pillow's ``Image.open(path).convert(mode)`` would."""
    with open(path, "rb") as fh:
        return decode(fh.read(), mode, name=str(path))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode(arr: np.ndarray) -> bytes:
    """(H, W) uint8 greyscale or (H, W, 3) uint8 RGB -> PNG bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"encode takes (H, W) or (H, W, 3) uint8, not {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else 3
    x = arr.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)])
    cand = cand.astype(np.uint8)
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)  # (5, H)
    ftypes = np.argmin(cost, axis=0).astype(np.uint8)
    rows = np.concatenate([ftypes[:, None], cand[ftypes, np.arange(h)]], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def imwrite(path: Union[str, Path], arr: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8 as a PNG file."""
    with open(path, "wb") as fh:
        fh.write(encode(arr))
