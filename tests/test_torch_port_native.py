"""The port's host IO layer (``panoptic_forecasting_tpu_torch/native``, a
compiled row codec in ``csrc/native_io.cpp``) against the JAX package's
libpng-backed ``native`` module, and against the port's plain numpy codec
(``data/png.py``).

The library is built here with the host compiler, so the compiled code
itself runs in these tests. Decoded arrays must equal libpng's and the
plain codec's; written files must equal libpng's byte for byte; the pixel
transforms must equal the JAX C functions bit for bit. A failed build
raises: there is no fallback.
"""

import struct
import zlib

import numpy as np
import pytest

from panoptic_forecasting_tpu import native as jax_native
from panoptic_forecasting_tpu.data import io as jax_io
from panoptic_forecasting_tpu_torch import native
from panoptic_forecasting_tpu_torch.data import io as port_io
from panoptic_forecasting_tpu_torch.data import png
from panoptic_forecasting_tpu_torch.kernels import build
from test_torch_port_png_expand import FILTERS, H, W, _palette, _write_png

pytestmark = pytest.mark.skipif(
    not jax_native.available(), reason="the JAX package's libpng library is not built here")


def _file(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _assert_same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---- the decoder ---------------------------------------------------------------

# every colour type at every bit depth the PNG standard allows (png.DEPTHS)
KINDS = [(ctype, depth) for ctype, depths in sorted(png.DEPTHS.items()) for depth in depths]


def _samples(ctype, depth, seed):
    """(H, W, C) stored samples of smooth content with noise: every filter
    predicts something, no row is flat."""
    rng = np.random.RandomState(seed)
    ch = png.STORED_CHANNELS[ctype]
    top = (1 << depth) - 1
    yy, xx = np.mgrid[:H, :W]
    smooth = (np.sin(xx / 5.0)[..., None] + np.cos(yy / 3.0)[..., None]
              + np.arange(ch) / 3.0)
    v = ((smooth + 3) / 6 * top).astype(np.int64)
    return np.clip(v ^ rng.randint(0, 4, v.shape), 0, top)


@pytest.mark.parametrize("interlace", [False, True], ids=["rows", "adam7"])
@pytest.mark.parametrize("ctype,depth", KINDS, ids=[f"c{c}d{d}" for c, d in KINDS])
def test_decoder_matches_libpng(tmp_path, ctype, depth, interlace):
    """Every colour type and bit depth, with and without Adam7, all five
    filters mixed in one image: the compiled decoder equals libpng
    (through the JAX package's native module) and the plain codec."""
    v = _samples(ctype, depth, ctype * 17 + depth)
    plte = _palette(1 << depth, depth).tobytes() if ctype == 3 else None
    data = _write_png(v, ctype, depth, FILTERS, interlace=interlace, plte=plte)
    path = _file(tmp_path, "m.png", data)
    want = jax_native.load_png(path)
    _assert_same(native.load_png(path), want, "native")
    _assert_same(png.decode_png(data), want, "plain")


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "palette4"])
def test_decoder_matches_libpng_with_trns(tmp_path, kind):
    """A tRNS chunk (alpha from a colour, or a palette's alpha table) over
    mixed filters."""
    ctype, depth = {"gray8": (0, 8), "gray16": (0, 16), "rgb8": (2, 8),
                    "palette4": (3, 4)}[kind]
    v = _samples(ctype, depth, 3)
    if ctype == 3:
        plte, trns = _palette(16, 2).tobytes(), bytes(range(0, 200, 25))
    else:
        plte = None
        trns = struct.pack(f">{v.shape[-1]}H", *v[4, 6].tolist())
    data = _write_png(v, ctype, depth, FILTERS, plte=plte, trns=trns)
    path = _file(tmp_path, "t.png", data)
    want = jax_native.load_png(path)
    _assert_same(native.load_png(path), want, "native")
    _assert_same(png.decode_png(data), want, "plain")


@pytest.mark.parametrize("filt", FILTERS, ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("kind", ["gray1", "rgba16"])
def test_decoder_each_filter(tmp_path, kind, filt):
    """One filter on every row at the smallest (1 byte, 1-bit gray) and the
    largest (8 bytes, 16-bit RGBA) byte distance."""
    ctype, depth = (0, 1) if kind == "gray1" else (6, 16)
    data = _write_png(_samples(ctype, depth, filt), ctype, depth, [filt])
    path = _file(tmp_path, "f.png", data)
    want = jax_native.load_png(path)
    _assert_same(native.load_png(path), want, "native")
    _assert_same(png.decode_png(data), want, "plain")


def test_decoder_refuses_an_unknown_filter():
    data = bytearray(_write_png(_samples(0, 8, 0), 0, 8, [png.FILTER_NONE]))
    hdr = png._header(bytes(data))
    raw = bytearray(zlib.decompress(hdr["idat"]))
    raw[3 * (W + 1)] = 5  # the filter byte of row 3
    bad = bytes(data[:33]) + png._chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + png._chunk(b"IEND", b"")
    for decode in (native.decode_png, png.decode_png):
        with pytest.raises(ValueError, match="unknown PNG row filter 5"):
            decode(bad)


# ---- the batch decode ----------------------------------------------------------


def _write_all(tmp_path, arrays, prefix):
    paths = []
    for i, arr in enumerate(arrays):
        paths.append(str(tmp_path / f"{prefix}{i}.png"))
        jax_native.save_png(paths[-1], arr, 1, jax_native.FILTER_ADAPTIVE)
    return paths


@pytest.mark.parametrize("num_threads", [1, 3])
def test_batch_matches_libpng(tmp_path, num_threads):
    """Five same-geometry files on 1 and 3 threads, 8-bit RGB and 16-bit
    gray: equal to libpng's threaded batch and to JAX's ``io`` batch."""
    rng = np.random.RandomState(num_threads)
    for dtype, shape in ((np.uint8, (24, 40, 3)), (np.uint16, (24, 40))):
        arrays = [rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
                  for _ in range(5)]
        paths = _write_all(tmp_path, arrays, f"{np.dtype(dtype).name}_")
        want = jax_native.load_png_batch(paths, num_threads=num_threads)
        _assert_same(want, np.stack(arrays), "libpng")
        _assert_same(native.load_png_batch(paths, num_threads), want, "native")
        _assert_same(port_io.load_png_batch(paths), jax_io.load_png_batch(paths), "io")


def test_batch_of_mixed_files_stacks_as_jax(tmp_path):
    """An 8-bit and a 16-bit file of one size stack as uint16 (JAX: its
    native batch refuses the second geometry, then ``np.stack`` promotes);
    two sizes raise ``ValueError`` in both; no file, too."""
    rng = np.random.RandomState(0)
    mixed = _write_all(tmp_path, [rng.randint(0, 256, (16, 20)).astype(np.uint8),
                                  rng.randint(0, 65536, (16, 20)).astype(np.uint16)], "d")
    want = jax_io.load_png_batch(mixed)
    assert want.dtype == np.uint16
    for threads in (1, 2):
        _assert_same(native.load_png_batch(mixed, threads), want, "promoted")
    _assert_same(port_io.load_png_batch(mixed), want, "io")
    sizes = _write_all(tmp_path, [rng.randint(0, 256, (16, 20)).astype(np.uint8),
                                  rng.randint(0, 256, (16, 21)).astype(np.uint8)], "s")
    for load in (jax_io.load_png_batch, port_io.load_png_batch,
                 lambda p: native.load_png_batch(p, 2)):
        with pytest.raises(ValueError):
            load(sizes)
        with pytest.raises(ValueError):
            load([])


# ---- the writer ----------------------------------------------------------------


def _written(tmp_path, arr, level, filters):
    jax_native.save_png(str(tmp_path / "j.png"), arr, level, filters)
    native.save_png(str(tmp_path / "p.png"), arr, level, filters)
    return (tmp_path / "p.png").read_bytes(), (tmp_path / "j.png").read_bytes()


def _arrays():
    rng = np.random.RandomState(9)
    yy, xx = np.mgrid[:96, :160]
    smooth = ((np.sin(xx / 17.0) + np.cos(yy / 11.0)) * 15000 + 32000).astype(np.uint16)
    return {
        "ids8": rng.randint(0, 12, (256, 512)).astype(np.uint8),
        "rgb8": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
        "ga8": rng.randint(0, 256, (20, 31, 2)).astype(np.uint8),
        "smooth16": smooth,
        "rgba16": rng.randint(0, 65536, (12, 9, 4)).astype(np.uint16),
        # one row and one column, each past one 8192-byte IDAT chunk
        "row16": rng.randint(0, 65536, (1, 5000)).astype(np.uint16),
        "col16": rng.randint(0, 65536, (5000, 1)).astype(np.uint16),
        "pixel8": np.array([[7]], np.uint8),
    }


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("filters", [0x08, 0x80, 0x88, -1], ids=["none", "paeth",
                                                                 "none_paeth", "adaptive"])
def test_writer_writes_libpngs_bytes(tmp_path, filters, level):
    """libpng's file, byte for byte, for its NONE, PAETH, NONE|PAETH and
    default masks at levels 1 and 6: every channel count at 8 and 16 bits,
    one-row and one-column images past one IDAT chunk, a one-pixel image."""
    for name, arr in _arrays().items():
        got, want = _written(tmp_path, arr, level, filters)
        assert got == want, (name, hex(filters), level)
        np.testing.assert_array_equal(png.decode_png(want), arr)


def test_writer_takes_libpngs_mask_as_libpng_reads_it(tmp_path):
    """Masks beyond the four profiles: each filter alone, masks without
    NONE, 0 (libpng's default), filter values 1-4 (libpng keeps them as a
    mask with no filter bit: NONE rows, Z_FILTERED), bits past the low
    byte. 5-7 are libpng's error."""
    arrays = _arrays()
    for filters in (0x10, 0x20, 0x40, 0x58, 0x90, 0xE0, 0, 1, 4, 0x09, 0x108, 0x1F8):
        for name in ("rgb8", "smooth16", "row16", "col16"):
            got, want = _written(tmp_path, arrays[name], 6, filters)
            assert got == want, (name, hex(filters))
    for filters in (5, 6, 7):
        with pytest.raises(OSError):
            jax_native.save_png(str(tmp_path / "j.png"), arrays["rgb8"], 1, filters)
        with pytest.raises(ValueError, match="no PNG filter mask"):
            native.encode_png(arrays["rgb8"], 1, filters)


def test_writer_takes_int32_as_16_bits_and_refuses_pillows_dtypes(tmp_path):
    """In-range int32 is written as 16 bits, as JAX's native writer does;
    what the JAX package hands to Pillow raises ``TypeError``."""
    ids = np.random.RandomState(2).randint(0, 34000, (40, 64)).astype(np.int32)
    got, want = _written(tmp_path, ids, 1, 0x08)
    assert got == want
    np.testing.assert_array_equal(native.load_png(str(tmp_path / "p.png")), ids)
    for arr in (ids > 100, ids.astype(np.float32), ids - 10, ids + 40000,
                ids.astype(np.int64)):
        with pytest.raises(TypeError, match="Pillow"):
            native.save_png(str(tmp_path / "x.png"), arr)
        with pytest.raises(TypeError, match="Pillow"):
            port_io.save_png(str(tmp_path / "x.png"), arr)


def test_writer_equals_the_plain_encoder():
    """The compiled filters and the plain ones write the same bytes for
    each profile the port writes (``PNG_IDS``, ``PNG_SMOOTH16``)."""
    for name, arr in _arrays().items():
        assert native.encode_png(arr, **port_io.PNG_IDS) == png.encode_png(
            arr, 1, png.FILTER_NONE), name
        if arr.size > 1:
            assert native.encode_png(arr, **port_io.PNG_SMOOTH16) == png.encode_png(
                arr, 1, None), name


# ---- the pixel transforms --------------------------------------------------------


def _bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_lut_and_depth_codecs_equal_jax_bitwise():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256, (33, 47)).astype(np.uint8)
    lut = rng.randint(0, 256, 256).astype(np.uint8)
    _bitwise(native.lut_apply_u8(ids, lut), jax_native.lut_apply_u8(ids, lut), "lut")
    _bitwise(native.lut_apply_u8(ids, lut), lut[ids], "lut plain")
    code = rng.randint(0, 65536, (33, 47)).astype(np.uint16)
    code[::4] = 0
    code[1::7] = 1  # disparity 0: invalid
    for got, want in zip(native.decode_depth_png_u16(code),
                         jax_native.decode_depth_png_u16(code)):
        _bitwise(got, want, "depth")
    # baseline * fx that no float32 holds: both round it to float32 once
    for baseline_fx in (0.209313 * 2262.52, 0.2 * 2268.36, 1.0 / 3.0):
        assert float(np.float32(baseline_fx)) != baseline_fx
        for got, want in zip(native.disparity_to_depth_u16(code, baseline_fx),
                             jax_native.disparity_to_depth_u16(code, baseline_fx)):
            _bitwise(got, want, f"disparity {baseline_fx}")


@pytest.mark.parametrize("src,dst", [((37, 53), (50, 71)), ((37, 53), (20, 29)),
                                     ((100, 90), (33, 67)), ((5, 7), (5, 7))])
def test_resize_nearest_equals_jax(src, dst):
    """PIL's NEAREST rule at non-integer up and down ratios (and 1)."""
    arr = np.random.RandomState(sum(src)).randint(0, 256, src).astype(np.uint8)
    _bitwise(native.resize_nearest_u8(arr, *dst), jax_native.resize_nearest_u8(arr, *dst),
             f"{src} -> {dst}")


# ---- the build -------------------------------------------------------------------


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails, into an empty build directory: the first call
    raises ``RuntimeError``, for ``available`` and for a PNG read alike; no
    path falls back to the plain codec."""
    path = str(tmp_path / "a.png")
    native.save_png(path, np.zeros((4, 4), np.uint8))
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="build failed for native_io.cpp"):
        native.available()
    with pytest.raises(RuntimeError, match="build failed"):
        port_io.load_png(path)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_built_from_the_port_source_only():
    """The port's library comes from its own ``csrc/native_io.cpp``: the
    JAX package's source and library are named nowhere in its build."""
    assert build.source("native_io") == build.CSRC / "native_io.cpp"
    assert build.library_path("native_io").parent == build.BUILD_DIR
    text = build.source("native_io").read_text()
    assert "#include <png.h>" not in text and "#include <zlib.h>" not in text
