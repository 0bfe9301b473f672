"""Port parity: the exact z-buffer paths (``sort``, ``scatter``, and
``auto`` routed to them) and ``PCTransformModel`` against the JAX
package, bit for bit.

Inputs are made with numpy from a seed: panoptic ids (>= 26001, far past
the packed path's 8 label bits), RGB payloads, leading batch dims,
integral and off-screen coordinates, and depths drawn from a few values
so that depth ties are common (JAX's stable sort gives a tie to the
smallest index of the 4N-entry stream; so must the port).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.kernels.zbuffer import (
    splat_four_neighbors as jax_four,
    zbuffer_splat as jax_splat,
)
from panoptic_forecasting_tpu.models.pc_transform import (
    PCTransformModel as JaxPCTransformModel,
)
from panoptic_forecasting_tpu_torch.kernels.zbuffer import (
    splat_four_neighbors,
    zbuffer_splat,
)
from panoptic_forecasting_tpu_torch.models import PCTransformModel
from test_torch_port_common import pc_scene

torch.set_num_threads(2)


def _points(rng, lead, n, h, w, payload):
    """uv (lead, N, 2), depth, label, valid; about a third of the points
    off screen, some on exact integers, depths from 6 values (ties)."""
    shape = tuple(lead) + (n,)
    uv = rng.rand(*shape, 2) * [w + 4, h + 4] - 2
    flat = uv.reshape(-1, 2)
    flat[::7] = np.round(flat[::7])
    flat[3::11] = rng.choice([1e11, -1e11, np.inf], (flat[3::11].shape[0], 2))
    depth = rng.choice([1.5, 2.0, 2.0000002, 7.25, 30.0, 0.5], shape)
    valid = rng.rand(*shape) > 0.25
    if payload == "panoptic":
        label = 26001 + rng.randint(0, 300, shape)
        label = label.astype(np.int32)
    elif payload == "rgb_u8":
        label = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    else:  # rgb_f32
        label = rng.rand(*shape, 3).astype(np.float32)
    return uv.astype(np.float32), depth.astype(np.float32), label, valid


def _both(uv, depth, label, valid, h, w, **kw):
    jl, jd = jax_splat(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(label),
                       jnp.asarray(valid), height=h, width=w, **kw)
    tl, td = zbuffer_splat(torch.from_numpy(uv), torch.from_numpy(depth),
                           torch.from_numpy(label), torch.from_numpy(valid),
                           height=h, width=w, **kw)
    return (np.asarray(jl), np.asarray(jd)), (tl.numpy(), td.numpy())


def _assert_same(jax_out, port_out):
    (jl, jd), (tl, td) = jax_out, port_out
    assert tl.dtype == jl.dtype and tl.shape == jl.shape
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))


@pytest.mark.parametrize("method", ["sort", "scatter", "auto"])
@pytest.mark.parametrize("payload", ["panoptic", "rgb_u8", "rgb_f32"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)], ids=["flat", "b3", "b2x2"])
def test_exact_zbuffer_bit_equal_to_jax(method, payload, lead):
    rng = np.random.RandomState(7)
    h, w, n = 9, 13, 150
    uv, depth, label, valid = _points(rng, lead, n, h, w, payload)
    kw = dict(method=method)
    if payload == "panoptic":
        kw["max_label"] = 32767  # 'auto' must take the sort path
    jax_out, port_out = _both(uv, depth, label, valid, h, w, **kw)
    _assert_same(jax_out, port_out)
    tl, td = port_out
    assert (td > 0).any()
    if payload == "panoptic":
        assert tl.max() > 255  # the labels survive whole


def test_exact_zbuffer_dense_canvas_with_ties():
    """Many points per pixel, all at one depth: every pixel's winner is
    the first point of the 4N stream that reaches it."""
    rng = np.random.RandomState(5)
    h, w, n = 16, 24, 2000
    uv = np.stack([rng.rand(n) * w, rng.rand(n) * h], -1).astype(np.float32)
    uv[::3] = np.floor(uv[::3])
    depth = np.full(n, 4.0, np.float32)
    label = (11000 + np.arange(n)).astype(np.int32)
    valid = np.ones(n, bool)
    for method in ("sort", "scatter"):
        _assert_same(*_both(uv, depth, label, valid, h, w, method=method,
                            max_label=20000))


def test_splat_four_neighbors_matches_jax():
    rng = np.random.RandomState(2)
    uv, *_ = _points(rng, (), 300, 7, 11, "panoptic")
    uv[5] = [np.nan, 2.5]
    want = np.asarray(jax_four(jnp.asarray(uv), 7, 11))
    got = splat_four_neighbors(torch.from_numpy(uv), 7, 11)
    np.testing.assert_array_equal(got.numpy(), want)


def _pc_batch(rng, b, t, h, w, payload):
    seg, depth, depth_mask, K, E, Ts = pc_scene(rng, b, t, h, w)
    if payload == "panoptic":
        seg = (seg * 1000 + 11000 + rng.randint(0, 5, seg.shape)).astype(np.int32)
    elif payload == "rgb":
        seg = rng.randint(0, 256, seg.shape + (3,)).astype(np.uint8)
    return {"inputs": {"seg": seg, "depth": depth, "depth_mask": depth_mask,
                       "intrinsics": K, "extrinsics": E, "target_T": Ts}}


@pytest.mark.parametrize("model", [
    {"zbuffer_method": "sort"},
    {"zbuffer_method": "scatter", "only_this_ind": 1},
    {"zbuffer_method": "auto", "only_this_ind": 2},
    {"zbuffer_method": "packed"},
    {"is_img": True},
], ids=["sort", "scatter_ind1", "auto_ind2", "packed", "is_img"])
def test_pc_transform_model_matches_jax(model):
    """PCTransformModel.predict on the fixture camera: the reprojection
    rounds as JAX's, so the splat is bit-equal whatever the method."""
    rng = np.random.RandomState(4)
    b, t, h, w = 2, 3, 24, 48
    payload = ("rgb" if model.get("is_img") else
               "panoptic" if model.get("zbuffer_method") in ("sort", "scatter")
               else "labels")
    batch = _pc_batch(rng, b, t, h, w, payload)
    cfg = {"model": model}
    jout = JaxPCTransformModel(cfg).predict({}, batch)
    tout = PCTransformModel(cfg, device="cpu").predict(batch)
    jl, jd = np.asarray(jout["seg"]), np.asarray(jout["depth"])
    tl, td = tout["seg"].numpy(), tout["depth"].numpy()
    want_shape = (b, h, w, 3) if payload == "rgb" else (b, h, w)
    assert tl.shape == jl.shape == want_shape and tl.dtype == jl.dtype
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))
    assert (td > 0).mean() > 0.3  # the scene really splats


def test_pc_transform_model_defaults_to_cuda():
    model = {"model": {}}
    if torch.cuda.is_available():
        assert PCTransformModel(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            PCTransformModel(model)
