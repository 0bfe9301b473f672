"""Port parity of the bg training augmentation, ``data/transforms.py``.

The JAX package resizes with OpenCV's ``INTER_NEAREST`` (OpenCV imports
here); the port computes OpenCV's index map in numpy. Inputs are seeded
numpy arrays of the sample's dtypes (uint8 labels, a raw uint16 depth
block, a (H, W, 1) float array). Every output is held bit-equal: shapes,
dtypes and values.
"""

import numpy as np
import pytest

from panoptic_forecasting_tpu.data import transforms as jax_tr
from panoptic_forecasting_tpu_torch.data import transforms as tr

# (source, destination) lengths: the sizes the bg augmentation resizes
# between (crop 800 from a 0.5-2.0 window; the tests' crop 64) and the
# pairs where the index rule i·src/dst is not OpenCV's (1688 -> 128).
SWEEP = sorted({(s, d) for d in (1, 2, 31, 64, 96, 128, 257, 800, 1024)
                for s in (2, 3, 7, 32, 33, 63, 64, 65, 127, 128, 400, 799, 801,
                          1023, 1600, 1688, 2047, 2048, 2199)})


def _sample(rng, h, w):
    segs = [rng.randint(0, 12, (h, w)).astype(np.uint8) for _ in range(3)]
    gt = rng.choice([0, 3, 10, 255], (h, w)).astype(np.uint8)
    arrs = [rng.randint(0, 60000, (h, w, 3)).astype(np.uint16),
            rng.rand(h, w, 1).astype(np.float32)]
    return segs, gt, arrs


def _assert_same(got, want):
    (gs, gg, ga), (ws, wg, wa) = got, want
    for a, b in zip(list(gs) + [gg] + list(ga), list(ws) + [wg] + list(wa)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_resize_nearest_is_opencv_inter_nearest():
    cv2 = pytest.importorskip("cv2")
    rows = np.arange(5, dtype=np.float32)[:, None]
    for src, dst in SWEEP:
        a = np.tile(np.arange(src, dtype=np.float32)[None], (5, 1)) + 10000 * rows
        want = cv2.resize(a, (dst, 5), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(tr._resize_nearest(a, dst, 5), want,
                                      err_msg=f"{src} -> {dst}")
        np.testing.assert_array_equal(tr._resize_nearest(a.T, 5, dst), want.T,
                                      err_msg=f"rows {src} -> {dst}")
    # the JAX package's own numpy fallback differs at 1688 -> 128
    fallback = np.minimum((np.arange(128) * 1688 / 128).astype(int), 1687)
    assert {16, 32, 48} <= set(np.flatnonzero(fallback != tr._nearest_index(128, 1688)))


@pytest.mark.parametrize("shape", [(64, 128), (1024, 2048), (37, 53), (20, 1688)])
def test_resize_nearest_matches_jax(shape):
    rng = np.random.RandomState(1)
    segs, gt, arrs = _sample(rng, *shape)
    for w, h in ((64, 64), (800, 800), (128, 257), shape[::-1]):
        _assert_same(tr.Resize((w, h))(segs, gt, arrs),
                     jax_tr.Resize((w, h))(segs, gt, arrs))


@pytest.mark.parametrize("seed", range(6))
def test_random_scale_crop_and_flip_match_jax(seed):
    """Crop 64 at scale 0.5-2.0 on 64x128 (windows up to 128x128 pad the
    height), then the flip; the same RandomState draws in both."""
    segs, gt, arrs = _sample(np.random.RandomState(100 + seed), 64, 128)
    chains = [[t.RandomScaleCrop(64, 0.5, 2.0, ignore_index=255),
               t.RandomHorizontalFlip()] for t in (tr, jax_tr)]
    padded = 0
    for k in range(8):
        outs = []
        for chain in chains:
            rng = np.random.RandomState(seed * 1000 + k)
            s, g, a = segs, gt, arrs
            for t in chain:
                s, g, a = t(s, g, a, rng)
            outs.append((s, g, a, rng.rand()))
        _assert_same(outs[0][:3], outs[1][:3])
        assert outs[0][3] == outs[1][3]  # the same number of draws
        assert outs[0][0][0].shape == (64, 64)
        padded += int(np.random.RandomState(seed * 1000 + k).uniform(0.5, 2.0) * 64 > 64)
    assert padded  # some windows were larger than the image


def test_flip_draws_once_and_mirrors():
    segs, gt, arrs = _sample(np.random.RandomState(5), 8, 16)
    flips = 0
    for seed in range(20):
        got = tr.RandomHorizontalFlip()(segs, gt, arrs, np.random.RandomState(seed))
        want = jax_tr.RandomHorizontalFlip()(segs, gt, arrs, np.random.RandomState(seed))
        _assert_same(got, want)
        flips += int(np.array_equal(got[1], gt[:, ::-1]))
    assert 0 < flips < 20
