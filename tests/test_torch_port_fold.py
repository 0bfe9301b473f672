"""Port: K1's fused placement + corner fold (``place_min_fold``), the
forecast path's z-buffer placement, on the CPU.

``place_min_fold`` takes its plain version for CPU tensors: a scatter-min
over each entry's <= 4 fold targets (``fold_targets``). It is held to the
JAX composition it replaces (the 4-plane min canvas, then the corner fold
of JAX ``kernels/zbuffer.py`` :238-254, ``fold_corners`` here) and to an
independent numpy scatter-min, bit for bit. The packed z-buffer's parity
with JAX, now through this dispatch, is in ``test_torch_port_zbuffer.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.kernels.placement import place_sorted
from panoptic_forecasting_tpu_torch.kernels.placement import (
    EMPTY,
    fold_corners,
    place_min_fold,
    place_min_fold_plain,
    place_min_plain,
)
from panoptic_forecasting_tpu_torch.kernels.zbuffer import splat_stream
from panoptic_forecasting_tpu_torch.models.pc_transform import reproject
from test_torch_port_common import pc_scene

torch.set_num_threads(2)


def _stream(case, rng, b, h, w):
    """(group, key) int32 streams over the (b, 4 planes, h, w) groups."""
    p = h * w
    if case == "random":  # every plane, ignored groups on both sides
        n = 4000
        g = rng.randint(-40, b * 4 * p + 40, n)
    elif case == "edges":  # ceil corners in the last column and last row
        col = np.arange(h) * w + w - 1
        row = (h - 1) * w + np.arange(w)
        g = np.concatenate([bb * 4 * p + plane * p + pix for bb in range(b)
                            for plane, pix in ((1, col), (3, col), (2, row),
                                               (3, row), (0, col), (2, col))])
        g = np.tile(g, 3)
        n = g.size
    elif case == "one_pixel":  # every entry on one pixel, 4 targets each
        n = 500
        g = np.full(n, (b - 1) * 4 * p + 3 * p + (h // 2) * w + w // 2)
    elif case == "empty":
        n = 0
        g = np.zeros(0)
    else:
        raise ValueError(case)
    k = rng.randint(0, 2**31 - 1, n)
    k[::7] = 0  # key 0 is a valid key, distinct from EMPTY
    return g.astype(np.int32), k.astype(np.int32)


def _numpy_fold(g, k, b, h, w):
    """Independent scatter-min: each entry at its <= 4 pixels."""
    p = h * w
    out = np.full(b * p, EMPTY, np.int32)
    for gi, ki in zip(g.tolist(), k.tolist()):
        if not 0 <= gi < b * 4 * p:
            continue
        bb, rem = divmod(gi, 4 * p)
        plane, base = divmod(rem, p)
        row, col = divmod(base, w)
        fu, fv = plane & 1, plane >> 1
        for du, dv in ((0, 0), (1, 0), (0, 1), (1, 1)):
            if du and not (fu and col < w - 1):
                continue
            if dv and not (fv and row < h - 1):
                continue
            t = bb * p + base + du + dv * w
            out[t] = min(out[t], ki)
    return out.reshape(b, h, w)


CASES = [(case, b, h, w) for case in ("random", "edges", "one_pixel", "empty")
         for b, h, w in ((1, 6, 10), (2, 6, 10), (2, 7, 9))]


@pytest.mark.parametrize("case,b,h,w", CASES)
def test_place_min_fold_plain_matches_fold_of_canvas(case, b, h, w):
    rng = np.random.RandomState(b * 100 + h * 10 + w)
    g, k = _stream(case, rng, b, h, w)
    gt, kt = torch.from_numpy(g), torch.from_numpy(k)
    out = place_min_fold(gt, kt, batch=b, height=h, width=w)
    assert out.shape == (b, h, w) and out.dtype == torch.int32
    folded = fold_corners(place_min_plain(gt, kt, b * 4 * h * w), b, h, w)
    np.testing.assert_array_equal(out.numpy(), folded.numpy())
    np.testing.assert_array_equal(out.numpy(), _numpy_fold(g, k, b, h, w))
    if case == "empty":
        assert (out == EMPTY).all()
    if case == "one_pixel":  # all four targets of the pixel, nothing else
        assert int((out != EMPTY).sum()) == 4
        assert int(out.min()) == int(k.min()) == 0


def test_place_min_fold_matches_jax_place_sorted_folded():
    """On a real reprojected stream: the TPU kernel's 4-plane canvas (in
    interpret mode, fed the sorted stream), folded, is the fused canvas."""
    rng = np.random.RandomState(4)
    b, h, w = 2, 12, 20
    args = [torch.from_numpy(np.array(a)) for a in pc_scene(rng, b, 3, h, w)]
    uv, z, label, valid = reproject(*args, height=h, width=w)
    group, key, num_groups = splat_stream(uv, z, label, valid, height=h, width=w)
    g, k = group.numpy(), key.numpy()
    order = np.lexsort((k, g))
    canvas4 = np.asarray(place_sorted(
        jnp.asarray(g[order]), jnp.asarray(k[order]), num_groups=num_groups,
        interpret=True, block=512, sw=1024,
    ))
    want = fold_corners(torch.from_numpy(canvas4.copy()), uv.shape[0], h, w)
    got = place_min_fold(group, key, batch=uv.shape[0], height=h, width=w)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), _numpy_fold(g, k, uv.shape[0], h, w))
    assert (got != EMPTY).float().mean() > 0.5  # the scene really splats


def test_place_min_fold_plain_is_the_composition_on_large_random():
    rng = np.random.RandomState(11)
    b, h, w = 3, 33, 70
    g = rng.randint(-100, b * 4 * h * w + 100, 60000).astype(np.int32)
    k = rng.randint(0, 2**31 - 1, 60000).astype(np.int32)
    gt, kt = torch.from_numpy(g), torch.from_numpy(k)
    np.testing.assert_array_equal(
        place_min_fold_plain(gt, kt, batch=b, height=h, width=w).numpy(),
        fold_corners(place_min_plain(gt, kt, b * 4 * h * w), b, h, w).numpy())


def test_place_min_fold_rejects_bad_inputs():
    g = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        place_min_fold(g.long(), g, batch=1, height=2, width=2)
    with pytest.raises(TypeError):
        place_min_fold(g, g.float(), batch=1, height=2, width=2)
    with pytest.raises(ValueError):
        place_min_fold(g, g[:3], batch=1, height=2, width=2)
    with pytest.raises(ValueError):
        place_min_fold(g.view(2, 2), g.view(2, 2), batch=1, height=2, width=2)
    with pytest.raises(ValueError):  # batch·4·P >= 2^31
        place_min_fold(g, g, batch=4, height=16384, width=8192)
    with pytest.raises(ValueError):
        place_min_fold(g, g, batch=0, height=2, width=2)
