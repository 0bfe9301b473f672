"""A PNG codec on numpy and the standard library's ``zlib``: the plain
version of the port's host IO layer.

The JAX package reads and writes PNG through libpng (its ``native/``
module) or Pillow; the port needs neither. Its data path reads and
writes through ``native`` (``csrc/native_io.cpp``: the row filters in
C++), which shares this module's chunk parsing, sample expansion
(``decode_png`` with its ``unfilter``) and file assembly
(``sample_rows``, ``png_file``); this module's numpy row filters are
what the tests hold the compiled ones to. The decoder returns what the
JAX package's native reader returns, the rows of libpng's
``png_set_expand`` + ``png_read_image``:

* gray, gray + alpha, RGB and RGBA at 8 or 16 bits per sample, as stored;
* gray at 1, 2 or 4 bits scaled to 8 (``v * 255 / (2**bits - 1)``);
* palette images (colour type 3, at 1, 2, 4 or 8 bits) looked up into
  RGB, or RGBA when a ``tRNS`` chunk is present (entries past the
  chunk's end opaque; indices past the palette's end black);
* gray or RGB with a ``tRNS`` chunk given an alpha channel: 0 where the
  pixel equals the chunk's colour, the largest sample elsewhere;
* Adam7 interlacing: each of the seven passes unfiltered on its own,
  then scattered into the image.

Rows may use any of the five filters (None, Sub, Up, Average, Paeth). A
colour type or bit depth that the PNG standard does not define, or an
interlace method other than 0 and 1, raises ``NotImplementedError``.

Decoding undoes Sub and Up rows with whole-row numpy operations. Average
and Paeth make each byte depend on the byte to its left after that one
is decoded, so an image holding such rows is decoded along
anti-diagonals instead: every pixel of one diagonal depends only on the
two diagonals before it, so each diagonal is one vectorised step
(H + W - 1 steps in all).

Encoding writes one filter type on every row (None by default: the
JAX package's ``PNG_IDS`` profile for id maps, ``data/io.py:60-66``), or
picks each row's filter as libpng does. It writes the bytes libpng
writes for the same image and settings (deflate parameters, window size,
IDAT chunks), so the port's files equal the JAX package's. It writes
8- and 16-bit gray, gray + alpha, RGB and RGBA, never interlaced.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Optional, Tuple

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


# colour type -> samples per pixel as stored (3: one palette index)
STORED_CHANNELS = {**CHANNELS, 3: 1}
# colour type -> the bit depths the PNG standard allows
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _header(data: bytes) -> Dict[str, Any]:
    """The IHDR fields, the PLTE and tRNS chunks and the IDAT stream."""
    ihdr, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
    if ihdr is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth not in DEPTHS.get(ctype, ()):
        raise NotImplementedError(
            f"PNG colour type {ctype} at {depth} bits is not supported")
    if interlace > 1:
        raise NotImplementedError(f"PNG interlace method {interlace} is not supported")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG file has no PLTE chunk")
    return {"height": h, "width": w, "depth": depth, "ctype": ctype,
            "interlace": interlace, "plte": plte, "trns": trns,
            "idat": b"".join(idat)}


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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered rows -> (H, stride) bytes."""
    kinds, rows = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > FILTER_PAETH:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    if np.isin(kinds, (FILTER_AVERAGE, FILTER_PAETH)).any():
        return _unfilter_diagonals(rows, kinds, bpp)
    return _unfilter_rows(rows, kinds, bpp)


def _samples(raw: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(H, stride) unfiltered bytes -> (H, width, channels) samples as
    stored: uint16 at 16 bits, else uint8 (a 1-, 2- or 4-bit sample is
    its value, the first one in the byte's high bits)."""
    h = raw.shape[0]
    if depth == 16:
        pix = raw.view(">u2").astype(np.uint16)
    elif depth == 8:
        pix = raw
    else:
        bits = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pix = (bits * weights).sum(2, dtype=np.uint8)
    return pix[:, : width * channels].reshape(h, width, channels)


def _expand(pix: np.ndarray, ctype: int, depth: int, plte, trns) -> np.ndarray:
    """(H, W, C) stored samples -> what libpng's ``png_set_expand``
    gives: palette to RGB(A), gray below 8 bits to 8, a ``tRNS`` colour
    to an alpha channel."""
    if ctype == 3:
        # libpng keeps 256 entries, zeroed past the PLTE chunk's end, and
        # an alpha of 255 past the tRNS chunk's end
        table = np.zeros((256, 4), np.uint8)
        n = min(len(plte) // 3, 256)
        table[:n, :3] = np.frombuffer(plte[: 3 * n], np.uint8).reshape(n, 3)
        table[:, 3] = 255
        if trns is None:
            return table[pix[..., 0], :3]
        alpha = np.frombuffer(trns[:256], np.uint8)
        table[: len(alpha), 3] = alpha
        return table[pix[..., 0]]
    alpha = None
    if trns is not None and ctype in (0, 2):
        # the colour's samples are 16 bits wide; libpng compares their low
        # ``depth`` bits (the low 8 at 8 bits)
        key = np.array(struct.unpack(f">{pix.shape[-1]}H", trns[: 2 * pix.shape[-1]]))
        key = (key & ((1 << depth) - 1)).astype(pix.dtype)
        alpha = np.where((pix == key).all(-1, keepdims=True),
                         0, np.iinfo(pix.dtype).max)
    if depth < 8:
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    if alpha is not None:
        pix = np.concatenate([pix, alpha.astype(pix.dtype)], -1)
    return pix


def decode_png(data: bytes, unfilter=_unfilter) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8/uint16 array, as libpng
    reads it with ``png_set_expand`` (see the module doc). ``unfilter``
    undoes one pass's row filters, ``(rows, 1 + stride)`` bytes and the
    filters' byte distance -> ``(rows, stride)`` bytes: this module's numpy
    version, or the compiled one of the ``native`` module."""
    hdr = _header(data)
    h, w, depth, ctype = hdr["height"], hdr["width"], hdr["depth"], hdr["ctype"]
    ch = STORED_CHANNELS[ctype]
    bits = ch * depth
    bpp = max(1, bits // 8)  # the filters' byte distance
    passes = []
    for y0, x0, dy, dx in (ADAM7 if hdr["interlace"] else ((0, 0, 1, 1),)):
        if y0 >= h or x0 >= w:
            continue  # an empty pass has no bytes, not even filter bytes
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        passes.append((y0, x0, dy, dx, ph, pw, -(-(pw * bits) // 8)))
    size = sum(ph * (stride + 1) for *_, ph, pw, stride in passes)
    buf = np.frombuffer(zlib.decompress(hdr["idat"], bufsize=max(size, 1)), np.uint8)
    if buf.size < size:
        raise ValueError("PNG image data is truncated")
    pix = (np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
           if hdr["interlace"] else None)
    pos = 0
    for y0, x0, dy, dx, ph, pw, stride in passes:
        rows = unfilter(buf[pos:pos + ph * (stride + 1)].reshape(ph, stride + 1), bpp)
        samples = _samples(rows, pw, ch, depth)
        if pix is None:
            pix = samples  # not interlaced: one pass, the whole image
        else:
            pix[y0::dy, x0::dx] = samples
        pos += ph * (stride + 1)
    pix = _expand(pix, ctype, depth, hdr["plte"], hdr["trns"])
    return pix[..., 0] if pix.shape[-1] == 1 else pix


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


def _adaptive(x: np.ndarray, bpp: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """libpng's per-row choice among the filters: the least sum of the
    filtered bytes read as signed magnitudes, the first on a tie. As in
    libpng, a one-row image drops Up, Average and Paeth, a one-column
    image Sub, Average and Paeth. Returns (filter kind per row, rows)."""
    h = x.shape[0]
    kinds = [FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH]
    if h == 1:
        kinds = [k for k in kinds if k not in (FILTER_UP, FILTER_AVERAGE, FILTER_PAETH)]
    if width == 1:
        kinds = [k for k in kinds if k not in (FILTER_SUB, FILTER_AVERAGE, FILTER_PAETH)]
    cands = np.stack([_filter(x, k, bpp) for k in kinds])  # (K, H, S)
    mag = np.minimum(cands, 256 - cands.astype(np.int32))
    pick = np.argmin(mag.sum(axis=2, dtype=np.int64), axis=0)
    return np.asarray(kinds, np.uint8)[pick], cands[pick, np.arange(h)]


def _zlib_stream(body: bytes, level: int, strategy: int) -> bytes:
    """The zlib stream libpng writes for ``body``: its deflate settings,
    and for a small image the smallest window that holds it (libpng's
    ``png_deflate_claim`` and ``optimize_cmf``)."""
    n = len(body)
    wbits = 15
    if n <= 16384:
        half = 1 << (wbits - 1)
        while n + 262 <= half:
            half >>= 1
            wbits -= 1
        wbits = max(wbits, 9)  # zlib rejects a window of 8 bits
    z = zlib.compressobj(level, zlib.DEFLATED, wbits, 8, strategy)
    out = bytearray(z.compress(body) + z.flush())
    cmf = out[0]
    if n <= 16384 and (cmf & 0x0F) == 8 and (cmf & 0xF0) <= 0x70:
        cinfo = cmf >> 4
        half = 1 << (cinfo + 7)
        if n <= half:
            while True:
                half >>= 1
                cinfo -= 1
                if not (cinfo > 0 and n <= half):
                    break
            cmf = (cmf & 0x0F) | (cinfo << 4)
            flg = out[1] & 0xE0
            flg += 0x1F - ((cmf << 8) + flg) % 0x1F
            out[0], out[1] = cmf, flg
    return bytes(out)


IDAT_SIZE = 8192  # libpng's PNG_ZBUF_SIZE: it writes IDAT chunks this long


def sample_rows(arr: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """A uint8/uint16 (H, W) or (H, W, C) array -> its rows as a PNG
    stores them, (H, W * C * bytes) big-endian bytes, with the bit depth
    and the channel count."""
    if arr.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples must be uint8 or uint16, not {arr.dtype}")
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    if arr.ndim not in (2, 3) or ch not in COLOR_TYPE:
        raise ValueError(f"cannot write an array of shape {arr.shape} as PNG")
    pix = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder(">"))
    return pix.view(np.uint8).reshape(h, -1), 8 * arr.dtype.itemsize, ch


def png_file(body: np.ndarray, width: int, depth: int, channels: int,
             compress_level: int, strategy: int) -> bytes:
    """The PNG file of filtered rows ``body`` ((H, 1 + stride) bytes, a
    filter byte first), as libpng writes it: ``_zlib_stream`` deflated,
    IDAT chunks of ``IDAT_SIZE`` bytes."""
    stream = _zlib_stream(body.tobytes(), compress_level, strategy)
    ihdr = struct.pack(">IIBBBBB", width, body.shape[0], depth,
                       COLOR_TYPE[channels], 0, 0, 0)
    idat = b"".join(_chunk(b"IDAT", stream[i:i + IDAT_SIZE])
                    for i in range(0, len(stream), IDAT_SIZE))
    return SIGNATURE + _chunk(b"IHDR", ihdr) + idat + _chunk(b"IEND", b"")


def encode_png(arr: np.ndarray, compress_level: int = 6,
               filter_type: Optional[int] = FILTER_NONE) -> bytes:
    """(H, W) or (H, W, C) uint8/uint16 array -> PNG bytes, every row
    filtered with ``filter_type``, or with ``None`` the filter libpng
    picks for each row. The bytes are what libpng (the JAX package's
    native writer) writes for the same settings: its deflate parameters,
    window and IDAT chunking."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    raw, depth, ch = sample_rows(arr)
    h, w = arr.shape[:2]
    bpp = ch * arr.dtype.itemsize
    body = np.empty((h, raw.shape[1] + 1), np.uint8)
    if filter_type is None and (h > 1 or w > 1):
        body[:, 0], body[:, 1:] = _adaptive(raw, bpp, w)
    else:
        filter_type = FILTER_NONE if filter_type is None else filter_type
        body[:, 0] = filter_type
        body[:, 1:] = _filter(raw, filter_type, bpp)
    strategy = zlib.Z_DEFAULT_STRATEGY if filter_type == FILTER_NONE else zlib.Z_FILTERED
    return png_file(body, w, depth, ch, compress_level, strategy)
