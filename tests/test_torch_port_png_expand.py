"""The port's PNG decoder on what libpng's ``png_set_expand`` expands:
palette images with and without ``tRNS``, gray at 1, 2 and 4 bits, gray
and RGB with a ``tRNS`` colour, and Adam7 interlacing at 8 and 16 bits
(and below 8), over every row filter.

The reference is the JAX package's ``data.io.load_png`` on its native
libpng path (``native/pf_native.cpp``: ``png_set_expand`` +
``png_read_image``), not Pillow, which returns palette indices: the
tests require that path and check that it is the one taken. The files
are written by Pillow where it can write the case, else as raw chunks
by ``_write_png`` below (Pillow writes no interlaced file and no 2- or
4-bit gray). Each decode must equal libpng's bit for bit.
"""

import io as pyio
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from panoptic_forecasting_tpu import native
from panoptic_forecasting_tpu.data import io as jax_io
from panoptic_forecasting_tpu_torch.data import io as port_io
from panoptic_forecasting_tpu_torch.data import png

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the JAX package's libpng reader is not built here")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, N) sample values -> (H, stride) bytes, big-endian at 16 bits,
    packed high bits first below 8."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(samples.shape[0], -1).astype(np.uint8), axis=1)


def _write_png(samples, ctype, depth, filters, interlace=False, plte=None, trns=None):
    """(H, W, C) stored samples -> PNG bytes: rows filtered in turn with
    ``filters`` (each pass on its own under Adam7)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = png.ADAM7 if interlace else ((0, 0, 1, 1),)
    body, row = bytearray(), 0
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw = _pack(sub.reshape(sub.shape[0], -1), depth)
        for r in range(raw.shape[0]):
            kind = filters[row % len(filters)]
            row += 1
            filtered = png._filter(raw[max(r - 1, 0):r + 1], kind, bpp)[-1]
            if r == 0:  # the first row of a pass has no row above it
                filtered = png._filter(raw[:1], kind, bpp)[0]
            body += bytes([kind]) + filtered.tobytes()
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    stream = zlib.compress(bytes(body), 6)
    return out + _chunk(b"IDAT", stream[:1000]) + _chunk(b"IDAT", stream[1000:]) \
        + _chunk(b"IEND", b"")


def _check(tmp_path, data: bytes, name: str):
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(data)
    want = jax_io.load_png(path)  # libpng through the native module
    got = port_io.load_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


def _pil_bytes(im: Image.Image, **kw) -> bytes:
    buf = pyio.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def test_reference_is_the_native_path(tmp_path):
    """The reference these tests use is libpng's: it expands a palette
    into RGB, where Pillow returns the indices."""
    im = Image.fromarray(np.arange(12, dtype=np.uint8).reshape(3, 4), "P")
    im.putpalette(_palette(256, 0).reshape(-1).tolist())
    path = str(tmp_path / "p.png")
    im.save(path)
    assert np.array(Image.open(path)).shape == (3, 4)
    want = _palette(256, 0)[np.arange(12).reshape(3, 4)]
    np.testing.assert_array_equal(jax_io.load_png(path), want)
    np.testing.assert_array_equal(port_io.load_png(path), want)


H, W = 37, 53  # not multiples of 8: every Adam7 pass has a ragged edge
FILTERS = [png.FILTER_NONE, png.FILTER_SUB, png.FILTER_UP, png.FILTER_AVERAGE,
           png.FILTER_PAETH]


def _palette(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3)).astype(np.uint8)


@pytest.mark.parametrize("trns", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_matches_libpng(tmp_path, bits, trns):
    """Palette images through Pillow (``bits`` sets the index depth);
    with ``transparency`` Pillow writes a tRNS chunk shorter than the
    palette, so the last entries stay opaque."""
    rng = np.random.RandomState(bits)
    n = 1 << bits
    idx = rng.randint(0, n, (H, W)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(_palette(n, bits).reshape(-1).tolist())
    kw = {"bits": bits} if bits < 8 else {}
    if trns:
        kw["transparency"] = bytes(rng.randint(0, 256, max(1, n // 2)).tolist())
    data = _pil_bytes(im, **kw)
    assert (b"tRNS" in data) == trns
    got = _check(tmp_path, data, f"p{bits}_{trns}")
    assert got.shape == (H, W, 4 if trns else 3)


def test_palette_index_past_the_palette_is_black(tmp_path):
    """A 4-entry palette with indices up to 7 (raw chunks): libpng reads
    the missing entries as black, opaque past the tRNS chunk."""
    idx = (np.arange(H * W) % 8).reshape(H, W, 1)
    plte = _palette(4, 3).tobytes()
    for trns in (None, bytes([10, 20])):
        _check(tmp_path, _write_png(idx, 3, 4, FILTERS, plte=plte, trns=trns),
               f"past_{trns is None}")


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_low_bit_gray_matches_libpng(tmp_path, bits):
    """Gray at 1, 2 and 4 bits scales to 8 as png_set_expand_gray_1_2_4_to_8
    does: 1 bit through Pillow's mode '1', all three as raw chunks."""
    rng = np.random.RandomState(bits)
    v = rng.randint(0, 1 << bits, (H, W, 1))
    got = _check(tmp_path, _write_png(v, 0, bits, FILTERS), f"g{bits}")
    assert got.shape == (H, W) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, v[..., 0] * (255 // ((1 << bits) - 1)))
    if bits == 1:
        _check(tmp_path, _pil_bytes(Image.fromarray(v[..., 0].astype(bool))), "g1_pil")


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgb16", "gray2"])
def test_trns_colour_adds_alpha(tmp_path, kind):
    """Gray and RGB with a tRNS colour: png_set_expand adds an alpha
    channel, 0 on the colour. 8-bit cases through Pillow's
    ``transparency``, the rest as raw chunks."""
    rng = np.random.RandomState(len(kind))
    depth = int(kind[4:] if kind.startswith("gray") else kind[3:])
    ch = 1 if kind.startswith("gray") else 3
    top = (1 << depth) - 1
    v = rng.randint(0, 4, (H, W, ch)) * (top // 3)  # few colours: the key recurs
    key = v[3, 5]
    trns = struct.pack(f">{ch}H", *key.tolist())
    got = _check(tmp_path, _write_png(v, 0 if ch == 1 else 2, depth, FILTERS,
                                      trns=trns), kind)
    assert got.shape == (H, W, ch + 1) and (got[..., -1] == 0).any()
    if depth == 8:
        im = Image.fromarray(v[..., 0].astype(np.uint8) if ch == 1 else v.astype(np.uint8))
        data = _pil_bytes(im, transparency=int(key[0]) if ch == 1 else tuple(
            int(k) for k in key))
        assert b"tRNS" in data
        _check(tmp_path, data, kind + "_pil")


@pytest.mark.parametrize("filt", FILTERS + [None], ids=[
    "none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba16", "gray16", "gray1",
                                  "palette4"])
def test_adam7_matches_libpng(tmp_path, kind, filt):
    """Adam7 files (raw chunks; every pass filtered on its own) at 8 and
    16 bits and below 8, one filter on every row or all five in turn."""
    rng = np.random.RandomState(7)
    filters = FILTERS if filt is None else [filt]
    if kind == "palette4":
        v, ctype, depth = rng.randint(0, 16, (H, W, 1)), 3, 4
    elif kind == "gray1":
        v, ctype, depth = rng.randint(0, 2, (H, W, 1)), 0, 1
    else:
        depth = 16 if kind.endswith("16") else 8
        ch = {"gray": 1, "rgb": 3, "rgba": 4}[kind[:-len(str(depth))]]
        ctype = png.COLOR_TYPE[ch]
        yy, xx = np.mgrid[:H, :W]
        smooth = (np.sin(xx / 5.0)[..., None] + np.cos(yy / 3.0)[..., None]
                  + np.arange(ch) / 3.0)
        v = ((smooth + 3) / 6 * ((1 << depth) - 1)).astype(np.int64)
        v ^= rng.randint(0, 4, v.shape)
    data = _write_png(v, ctype, depth, filters, interlace=True,
                      plte=_palette(16, 1).tobytes() if ctype == 3 else None)
    _check(tmp_path, data, f"{kind}_{filt}")


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 3), (5, 5)])
def test_adam7_small_images_skip_empty_passes(tmp_path, shape):
    """Images smaller than the 8x8 Adam7 block leave passes empty; an
    empty pass has no bytes, not even filter bytes."""
    v = np.random.RandomState(0).randint(0, 256, shape + (3,))
    _check(tmp_path, _write_png(v, 2, 8, FILTERS, interlace=True), f"small{shape}")


def test_decoder_still_refuses_what_png_does_not_define():
    """No fallback: a colour type, bit depth or interlace method outside
    the PNG standard raises, and a palette file without PLTE is an error."""
    def header(w, h, depth, ctype, interlace=0):
        return png.SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))

    tail = _chunk(b"IDAT", zlib.compress(b"\0" * 8)) + _chunk(b"IEND", b"")
    for depth, ctype in ((16, 3), (4, 2), (2, 6), (8, 5)):
        with pytest.raises(NotImplementedError, match=f"colour type {ctype}"):
            png.decode_png(header(2, 2, depth, ctype) + tail)
    with pytest.raises(NotImplementedError, match="interlace method 2"):
        png.decode_png(header(2, 2, 8, 0, 2) + tail)
    with pytest.raises(ValueError, match="no PLTE"):
        png.decode_png(header(2, 2, 8, 3) + tail)
