"""The port's host IO layer: PNG read and write over a compiled row codec,
a threaded batch decode, LUT relabel, the Cityscapes depth and disparity
codecs and a nearest label resize.

Counterpart of ``panoptic_forecasting_tpu/native`` (libpng + zlib behind a
C ABI, in the repo's root ``native/`` directory), with its names and API.
The port links
no libpng: ``csrc/native_io.cpp`` holds the byte loops (the row unfilter
of a read, libpng's row filters and per-row filter choice for a write,
the pixel transforms), built with the host compiler by
``kernels/build.py`` on first use; Python's ``zlib`` inflates and
deflates, and ``data/png.py`` parses the chunks, expands the samples as
libpng's ``png_set_expand`` does and writes libpng's deflate stream and
IDAT chunks. Decoded arrays equal libpng's; written files equal libpng's
byte for byte.

There is no fallback: where the library cannot be built, the first call
raises with the compiler's output. ``data/png.py``'s numpy codec is the
plain version the tests hold this one to.

``zlib`` and every ctypes call release the interpreter lock, so
``load_png_batch`` decodes its files on threads in parallel.
"""

from __future__ import annotations

import ctypes
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

import numpy as np

from ..data import png
from ..kernels import build

# libpng's PNG_FILTER_* mask: NONE alone for flat id/label maps; all five
# filters, chosen per row, for photographic and smooth 16-bit content
FILTER_NONE = 0x08
FILTER_ADAPTIVE = -1

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "pf_png_unfilter": (_P, _I64, _I64, _I32, _P),
    "pf_png_filter": (_P, _I64, _I64, _I32, _I32, _I32, _P, _P),
    "pf_lut_u8": (_P, _I64, _P),
    "pf_decode_depth_png_u16": (_P, _I64, _P, _P),
    "pf_disparity_to_depth_u16": (_P, _I64, ctypes.c_float, _P, _P),
    "pf_resize_nearest_u8": (_P, _I32, _I32, _P, _I32, _I32),
}


def _lib() -> ctypes.CDLL:
    return build.load("native_io", _SIGNATURES)


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def available() -> bool:
    """Build (on first use) and load the library: ``True``, or raises."""
    _lib()
    return True


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(rows, 1 + stride) filtered bytes of one pass -> (rows, stride)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    rc = _lib().pf_png_unfilter(_ptr(rows), out.shape[0], out.shape[1], bpp, _ptr(out))
    if rc == -1:
        raise ValueError(f"unknown PNG row filter {int(rows[:, 0].max())}")
    if rc != 0:
        raise RuntimeError(f"pf_png_unfilter failed: {rc}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8/uint16 array, as libpng's
    ``png_set_expand`` + ``png_read_image`` give it."""
    return png.decode_png(data, _unfilter)


def load_png(path: str) -> np.ndarray:
    """PNG file -> array (H, W[, C]); uint8 or uint16 by bit depth."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def load_png_batch(paths: Sequence[str], num_threads: int = 0) -> np.ndarray:
    """Decode PNG files into one (N, H, W[, C]) array, ``num_threads`` files
    at a time (0: one thread a file, up to the CPU count). Files of
    different geometry stack as ``np.stack`` stacks them: a uint8 and a
    uint16 file of one size give uint16, two sizes raise ``ValueError``."""
    paths = list(paths)
    if num_threads <= 0:
        num_threads = min(len(paths), os.cpu_count() or 1)
    if num_threads <= 1 or len(paths) <= 1:
        return np.stack([load_png(p) for p in paths])
    with ThreadPoolExecutor(max_workers=num_threads,
                            thread_name_prefix="pf-png") as ex:
        return np.stack(list(ex.map(load_png, paths)))


def encode_png(arr: np.ndarray, compress_level: int = 6,
               filters: int = FILTER_ADAPTIVE) -> bytes:
    """Array -> the PNG file libpng writes for it at ``compress_level``
    with ``filters`` (libpng's ``PNG_FILTER_*`` mask, read as libpng 1.6
    reads it, or ``FILTER_ADAPTIVE``). uint8 and uint16 are written as they are; int32
    with every value in [0, 65536) as 16 bits, as the JAX package's native
    writer writes it. Anything else raises ``TypeError``: the JAX package
    hands it to Pillow, which the port does not have."""
    arr = np.asarray(arr)
    if (arr.dtype == np.int32 and arr.min(initial=0) >= 0
            and arr.max(initial=0) < 65536):
        arr = arr.astype(np.uint16)
    if arr.dtype not in (np.uint8, np.uint16):
        raise TypeError(
            f"cannot write a {arr.dtype} array as PNG: the JAX package hands it "
            "to Pillow, which the port does not have; pass uint8, uint16 or "
            "int32 in [0, 65536)")
    raw, depth, ch = png.sample_rows(arr)
    body = np.empty((raw.shape[0], raw.shape[1] + 1), np.uint8)
    used = ctypes.c_int32()
    rc = _lib().pf_png_filter(_ptr(raw), raw.shape[0], raw.shape[1],
                              ch * depth // 8, arr.shape[1], filters, _ptr(body),
                              ctypes.byref(used))
    if rc == -3:
        raise ValueError(f"{filters} is no PNG filter mask (libpng refuses 5-7)")
    if rc != 0:
        raise RuntimeError(f"pf_png_filter failed: {rc}")
    strategy = (zlib.Z_DEFAULT_STRATEGY if used.value == FILTER_NONE
                else zlib.Z_FILTERED)
    return png.png_file(body, arr.shape[1], depth, ch, compress_level, strategy)


def save_png(path: str, arr: np.ndarray, compress_level: int = 6,
             filters: int = FILTER_ADAPTIVE) -> None:
    """Write ``encode_png(arr, compress_level, filters)`` to ``path``,
    making its directory."""
    data = encode_png(arr, compress_level, filters)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def lut_apply_u8(arr: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """256-entry LUT relabel of ``arr`` as uint8; returns a new array."""
    out = np.ascontiguousarray(arr, np.uint8).copy()
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.size != 256:
        raise ValueError(f"a LUT has 256 entries, not {lut.size}")
    _lib().pf_lut_u8(_ptr(out), out.size, _ptr(lut))
    return out


def decode_depth_png_u16(png_: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint16 depth PNG payload -> (depth float32, valid bool): p / 256 - 1,
    p = 0 invalid (depth -1)."""
    png_ = np.ascontiguousarray(png_, np.uint16)
    depth = np.empty(png_.shape, np.float32)
    valid = np.empty(png_.shape, np.uint8)
    _lib().pf_decode_depth_png_u16(_ptr(png_), png_.size, _ptr(depth), _ptr(valid))
    return depth, valid.astype(bool)


def disparity_to_depth_u16(png_: np.ndarray,
                           baseline_fx: float) -> Tuple[np.ndarray, np.ndarray]:
    """uint16 Cityscapes disparity PNG payload -> (depth float32, valid
    bool): ``baseline_fx`` (as a float32) / ((p - 1) / 256), -1 where p is 0
    or the disparity is not positive."""
    png_ = np.ascontiguousarray(png_, np.uint16)
    depth = np.empty(png_.shape, np.float32)
    valid = np.empty(png_.shape, np.uint8)
    _lib().pf_disparity_to_depth_u16(_ptr(png_), png_.size, float(baseline_fx),
                                     _ptr(depth), _ptr(valid))
    return depth, valid.astype(bool)


def resize_nearest_u8(arr: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W) uint8 label map -> (dh, dw) by the NEAREST rule (source
    index ``int((y + 0.5) * H / dh)``, Pillow's), not OpenCV's
    (``data/transforms.py``)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"a label map is 2-D, not of shape {arr.shape}")
    out = np.empty((dh, dw), np.uint8)
    rc = _lib().pf_resize_nearest_u8(_ptr(arr), arr.shape[0], arr.shape[1],
                                     _ptr(out), dh, dw)
    if rc != 0:
        raise ValueError(f"cannot resize a {arr.shape} map to ({dh}, {dw})")
    return out
