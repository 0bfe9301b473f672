"""A PNG codec on numpy and the standard library's ``zlib``.

The JAX package reads and writes PNG through libpng (its ``native/``
module) or Pillow; the port carries its own codec so that it needs
neither. It covers what the Cityscapes artifacts use: non-interlaced
gray, gray + alpha, RGB and RGBA images at 8 or 16 bits per sample,
with any of the five row filters (None, Sub, Up, Average, Paeth).
Palette images, bit depths below 8 and Adam7 interlacing raise
``NotImplementedError``.

Decoding undoes Sub and Up rows with whole-row numpy operations. Average
and Paeth make each byte depend on the byte to its left after that one
is decoded, so an image holding such rows is decoded along
anti-diagonals instead: every pixel of one diagonal depends only on the
two diagonals before it, so each diagonal is one vectorised step
(H + W - 1 steps in all).

Encoding writes one filter type on every row (None by default: the
JAX package's ``PNG_IDS`` profile for id maps, ``data/io.py:60-66``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
COLOR_TYPE = {v: k for k, v in CHANNELS.items()}
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _header(data: bytes) -> Tuple[int, int, int, int, bytes]:
    """-> (height, width, bit depth, channels, concatenated IDAT)."""
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if ctype not in CHANNELS or depth not in (8, 16):
        raise NotImplementedError(
            f"PNG colour type {ctype} at {depth} bits is not supported")
    if interlace:
        raise NotImplementedError("interlaced PNG is not supported")
    return h, w, depth, CHANNELS[ctype], b"".join(idat)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of only None, Sub and Up filters, row by row."""
    out = np.empty_like(rows)
    prior = np.zeros(rows.shape[1], np.uint8)
    for r, kind in enumerate(kinds):
        row = rows[r]
        if kind == FILTER_SUB:
            # per byte lane, a running sum mod 256 along the row
            row = np.cumsum(row.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
        elif kind == FILTER_UP:
            row = row + prior
        out[r] = prior = row
    return out


def _unfilter_diagonals(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of filters, one anti-diagonal of pixels at a time."""
    h, stride = rows.shape
    w = stride // bpp
    raw = rows.reshape(h, w, bpp).astype(np.int32)
    # one row and one column of zeros ahead: left, up and up-left of the
    # first row and column read 0, as the filters define
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    kind = kinds.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        k = kind[r][:, None]
        pred = np.where(k == FILTER_SUB, a,
               np.where(k == FILTER_UP, b,
               np.where(k == FILTER_AVERAGE, (a + b) >> 1,
               np.where(k == FILTER_PAETH, _paeth(a, b, c), 0))))
        out[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8/uint16 array."""
    h, w, depth, ch, idat = _header(data)
    bpp = ch * depth // 8
    stride = w * bpp
    buf = np.frombuffer(zlib.decompress(idat), np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = buf[: h * (stride + 1)].reshape(h, stride + 1)
    kinds, rows = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > FILTER_PAETH:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    if np.isin(kinds, (FILTER_AVERAGE, FILTER_PAETH)).any():
        pix = _unfilter_diagonals(rows, kinds, bpp)
    else:
        pix = _unfilter_rows(rows, kinds, bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    shape = (h, w) if ch == 1 else (h, w, ch)
    return pix.reshape(shape)


def _filter(x: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """(H, stride) bytes -> the same rows filtered with ``kind``."""
    if kind == FILTER_NONE:
        return x
    v = x.astype(np.int32)
    left = np.zeros_like(v)
    left[:, bpp:] = v[:, :-bpp]
    up = np.zeros_like(v)
    up[1:] = v[:-1]
    if kind == FILTER_SUB:
        pred = left
    elif kind == FILTER_UP:
        pred = up
    elif kind == FILTER_AVERAGE:
        pred = (left + up) >> 1
    elif kind == FILTER_PAETH:
        upleft = np.zeros_like(v)
        upleft[1:, bpp:] = v[:-1, :-bpp]
        pred = _paeth(left, up, upleft)
    else:
        raise ValueError(f"unknown PNG row filter {kind}")
    return ((v - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, compress_level: int = 6,
               filter_type: int = FILTER_NONE) -> bytes:
    """(H, W) or (H, W, C) uint8/uint16 array -> PNG bytes, every row
    filtered with ``filter_type``."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples must be uint8 or uint16, not {arr.dtype}")
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    if arr.ndim not in (2, 3) or ch not in COLOR_TYPE:
        raise ValueError(f"cannot write an array of shape {arr.shape} as PNG")
    depth = 8 * arr.dtype.itemsize
    bpp = ch * arr.dtype.itemsize
    pix = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder(">"))
    rows = _filter(pix.view(np.uint8).reshape(h, w * bpp), filter_type, bpp)
    body = np.empty((h, w * bpp + 1), np.uint8)
    body[:, 0] = filter_type
    body[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, depth, COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), compress_level))
            + _chunk(b"IEND", b""))
