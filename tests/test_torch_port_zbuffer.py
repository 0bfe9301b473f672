"""Port parity: K1 placement, the packed z-buffer and the point-cloud
transform (panoptic_forecasting_tpu_torch) against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. The JAX
side runs as its own tests run it on the CPU: ``place_sorted`` in
interpret mode with small blocks, ``zbuffer_splat(method='packed')``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.geometry import rdf_T_flu as jax_rdf_T_flu
from panoptic_forecasting_tpu.geometry import unicycle_now_T_prev as jax_unicycle
from panoptic_forecasting_tpu.geometry.boxes import bbox_cwh_to_ulbr as jax_cwh_to_ulbr
from panoptic_forecasting_tpu.kernels.placement import place_sorted
from panoptic_forecasting_tpu.kernels.zbuffer import zbuffer_splat as jax_splat
from panoptic_forecasting_tpu.models.pc_transform import (
    pc_transform_predict as jax_pc_predict,
)
from panoptic_forecasting_tpu_torch.geometry import (
    bbox_cwh_to_ulbr,
    rdf_T_flu,
    unicycle_now_T_prev,
)
from panoptic_forecasting_tpu_torch.kernels.placement import (
    EMPTY,
    place_min,
    place_min_plain,
)
from panoptic_forecasting_tpu_torch.kernels.zbuffer import zbuffer_splat
from panoptic_forecasting_tpu_torch.models.pc_transform import (
    pc_transform_predict,
)
from test_torch_port_common import pc_scene

torch.set_num_threads(2)


def _stream(case, rng):
    """(groups, keys, num_groups) for the tests/test_kernels.py cases."""
    if case == "uniform":
        num_groups, n = 5000, 9000
        g = rng.randint(0, num_groups, n)
        k = rng.randint(1, 2**30, n)
    elif case == "pileup":  # many entries in one (border) group
        num_groups, n = 9321, 9000
        g = rng.randint(0, num_groups, n)
        g[:3000] = num_groups - 1
        k = rng.randint(1, 2**30, n)
    elif case == "sparse":  # wide empty spans, mostly empty canvas
        num_groups, n = 40000, 800
        g = rng.randint(0, num_groups, n)
        k = rng.randint(1, 2**30, n)
    elif case == "key_zero":  # key 0 is a valid key, distinct from EMPTY
        num_groups, n = 2048, 600
        g = rng.randint(0, num_groups, n)
        k = rng.randint(0, 2**31 - 1, n)
        k[::7] = 0
    elif case == "sentinels":  # entries past the canvas are ignored
        num_groups, n = 3000, 4000
        g = rng.randint(0, num_groups, n)
        g[::5] = EMPTY
        g[1::11] = num_groups
        k = rng.randint(0, 2**30, n)
    else:
        raise ValueError(case)
    return g.astype(np.int32), k.astype(np.int32), num_groups


@pytest.mark.parametrize(
    "case", ["uniform", "pileup", "sparse", "key_zero", "sentinels"]
)
def test_place_min_plain_matches_place_sorted(case):
    """K1's plain version takes the stream UNSORTED; the canvas must equal
    the TPU kernel's (fed the lexsorted stream) and numpy's scatter-min
    bit for bit."""
    rng = np.random.RandomState(7)
    g, k, num_groups = _stream(case, rng)
    order = np.lexsort((k, g))
    jax_out = np.asarray(place_sorted(
        jnp.asarray(g[order]), jnp.asarray(k[order]), num_groups=num_groups,
        interpret=True, block=512, sw=1024,
    ))
    ref = np.full(num_groups, EMPTY, np.int32)
    keep = g < num_groups
    np.minimum.at(ref, g[keep], k[keep])
    out = place_min(torch.from_numpy(g), torch.from_numpy(k), num_groups)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), jax_out)
    np.testing.assert_array_equal(out.numpy(), ref)
    if case == "key_zero":
        assert (out == 0).any()


def test_place_min_plain_multi_run_overlapping_groups():
    """Three independently sorted runs hitting the same groups (the
    per-frame sort_runs layout) reduce to one global min."""
    rng = np.random.RandomState(13)
    num_groups, runs, rl = 9000, 3, 2000
    g = rng.randint(0, num_groups, runs * rl).astype(np.int32)
    k = rng.randint(0, 2**30, runs * rl).astype(np.int32)
    gs, ks = g.reshape(runs, rl).copy(), k.reshape(runs, rl).copy()
    for r in range(runs):
        o = np.lexsort((ks[r], gs[r]))
        gs[r], ks[r] = gs[r][o], ks[r][o]
    jax_out = np.asarray(place_sorted(
        jnp.asarray(gs.reshape(-1)), jnp.asarray(ks.reshape(-1)),
        num_groups=num_groups, runs=runs, interpret=True, block=512, sw=1024,
    ))
    out = place_min_plain(torch.from_numpy(g), torch.from_numpy(k), num_groups)
    np.testing.assert_array_equal(out.numpy(), jax_out)


def test_place_min_rejects_bad_inputs():
    g = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        place_min(g.long(), g, 8)
    with pytest.raises(ValueError):
        place_min(g, g[:3], 8)


def _splat_case(case, rng):
    if case == "offscreen":  # test_kernels golden case: out-of-bounds uv
        h, w, n = 6, 9, 40
        uv = rng.rand(n, 2) * [w + 2, h + 2] - 1
        depth = rng.rand(n) * 10 + 0.5
        label = rng.randint(1, 12, size=n)
        valid = rng.rand(n) > 0.3
    elif case == "dense":  # full coverage + exactly integral coordinates
        h, w = 32, 64
        n = 3 * h * w
        uv = np.stack([rng.rand(n) * (w + 4) - 2, rng.rand(n) * (h + 4) - 2], -1)
        uv[:50] = np.round(uv[:50])
        depth = rng.rand(n) * 30 + 1
        label = rng.randint(0, 19, size=n)
        valid = rng.rand(n) > 0.2
    elif case == "behind_camera":
        # safe_z makes u, v huge for points at/behind the camera: the f32
        # -> int32 casts saturate in XLA (1e11 -> 2^31-1, NaN -> 0); they
        # must still pile onto the same clamped border pixels.
        h, w, n = 8, 12, 300
        uv = rng.rand(n, 2) * [w + 2, h + 2] - 1
        big = rng.choice([1e11, -1e11, 3e9, -3e9, np.inf, -np.inf], (n // 2, 2))
        uv[: n // 2] = big
        uv[5] = [np.nan, 3.5]
        uv[6] = [2.5, np.nan]
        depth = rng.rand(n) * 20 + 0.5
        label = rng.randint(0, 12, size=n)
        valid = rng.rand(n) > 0.5
    elif case == "batched":  # per-batch sentinels and group offsets
        h, w, b, n = 7, 9, 3, 60
        uv = rng.rand(b, n, 2) * [w + 2, h + 2] - 1
        depth = rng.rand(b, n) * (10 ** rng.randint(0, 3, (b, 1))) + 0.5
        label = rng.randint(1, 12, size=(b, n))
        valid = rng.rand(b, n) > 0.3
    else:
        raise ValueError(case)
    return (uv.astype(np.float32), depth.astype(np.float32),
            label.astype(np.int32), valid, h, w)


@pytest.mark.parametrize("case", ["offscreen", "dense", "behind_camera", "batched"])
def test_zbuffer_splat_bit_equal_to_jax_packed(case):
    uv, depth, label, valid, h, w = _splat_case(case, np.random.RandomState(3))
    jl, jd = jax_splat(
        jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(label),
        jnp.asarray(valid), height=h, width=w, method="packed",
    )
    tl, td = zbuffer_splat(
        torch.from_numpy(uv), torch.from_numpy(depth), torch.from_numpy(label),
        torch.from_numpy(valid), height=h, width=w,
    )
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))


def test_zbuffer_splat_matches_pallas_interpret():
    """Against the TPU kernel itself (interpret mode), not only the XLA
    scatter path."""
    uv, depth, label, valid, h, w = _splat_case("dense", np.random.RandomState(9))
    jl, jd = jax_splat(
        jnp.asarray(uv)[None], jnp.asarray(depth)[None],
        jnp.asarray(label)[None], jnp.asarray(valid)[None],
        height=h, width=w, method="pallas_interpret",
    )
    tl, td = zbuffer_splat(
        torch.from_numpy(uv)[None], torch.from_numpy(depth)[None],
        torch.from_numpy(label)[None], torch.from_numpy(valid)[None],
        height=h, width=w,
    )
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_zbuffer_splat_raises_on_unported_paths():
    """The packed requests JAX rejects (a label that would alias in 8
    bits, a vector payload) raise ValueError in both; so does a method
    name the port does not know."""
    uv = np.zeros((4, 2), np.float32)
    depth = np.ones(4, np.float32)
    valid = np.ones(4, bool)
    for label, kw in ((np.zeros(4, np.int32), dict(max_label=512)),
                      (np.zeros((4, 3), np.float32), {})):
        for method in ("packed", "pallas"):
            with pytest.raises(ValueError):
                jax_splat(jnp.asarray(uv), jnp.asarray(depth),
                          jnp.asarray(label), jnp.asarray(valid), height=4,
                          width=4, method=method, **kw)
            with pytest.raises(ValueError):
                zbuffer_splat(torch.from_numpy(uv), torch.from_numpy(depth),
                              torch.from_numpy(label), torch.from_numpy(valid),
                              height=4, width=4, method=method, **kw)
    with pytest.raises(ValueError):
        zbuffer_splat(torch.from_numpy(uv), torch.from_numpy(depth),
                      torch.zeros(4, dtype=torch.int32),
                      torch.from_numpy(valid), height=4, width=4,
                      method="bitonic")


@pytest.mark.parametrize("rotated", [False, True], ids=["fixture", "rotated"])
def test_pc_transform_predict_matches_jax(rotated):
    """Labels may differ on <= 1e-3 of pixels: ulp-level differences in
    the 4x4 chain (LU inverses, products) can move a point across a pixel
    edge. On the fixture's camera the chain rounds exactly as JAX's and
    wherever labels agree depths agree to 1e-6 relative; with a tilted
    camera an ulp of z may also cross a truncation step of the packed key
    (2^-15 relative), on <= 1e-3 of pixels."""
    rng = np.random.RandomState(0)
    b, t, h, w = 2, 3, 48, 96
    args = pc_scene(rng, b, t, h, w, rotated)
    jout = jax_pc_predict(*[jnp.asarray(a) for a in args], height=h, width=w)
    tout = pc_transform_predict(*[torch.from_numpy(np.asarray(a)) for a in args],
                                height=h, width=w, device="cpu")
    jl, jd = np.asarray(jout["seg"]), np.asarray(jout["depth"])
    tl, td = tout["seg"].numpy(), tout["depth"].numpy()
    assert tl.shape == jl.shape == (b, h, w)
    same = tl == jl
    assert (~same).mean() <= 1e-3
    close = np.isclose(td, jd, rtol=1e-6, atol=0)
    if rotated:
        assert (same & ~close).mean() <= 1e-3
        assert np.allclose(td[same], jd[same], rtol=2.0**-15, atol=0)
    else:
        assert close[same].all()
    assert (td > 0).mean() > 0.5  # the scene really splats


def test_geometry_matches_jax():
    speed = np.array([3.0, 2.0, 1.0, 8.0], np.float32)
    yaw = np.array([0.02, 0.0, -0.01, 1e-5], np.float32)
    np.testing.assert_allclose(
        unicycle_now_T_prev(speed, yaw, 0.35).numpy(),
        np.asarray(jax_unicycle(speed, yaw, 0.35)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_array_equal(rdf_T_flu(), jax_rdf_T_flu())
    boxes = np.random.RandomState(1).rand(5, 4).astype(np.float32) * 100
    np.testing.assert_array_equal(
        bbox_cwh_to_ulbr(torch.from_numpy(boxes)).numpy(),
        np.asarray(jax_cwh_to_ulbr(jnp.asarray(boxes))),
    )


@pytest.mark.parametrize("seed", range(3))
def test_camera_chain_rounds_as_jax(seed):
    """The host 4x4 chain (E⁻¹·target_T·E, then R·K⁻¹) is bit-equal to
    the JAX package's jitted chain on the CPU, for tilted and yawed
    Cityscapes-like cameras and random ego motion; so is the 4x4
    inverse for general matrices (LAPACK getrf + getrs rounding)."""
    import jax
    from panoptic_forecasting_tpu.models import pc_transform as jax_pc

    from panoptic_forecasting_tpu_torch.models.pc_transform import _camera_maps, _inv

    rng = np.random.RandomState(seed)
    b, t = 2, 3
    K = np.tile(np.array([[2262.52, 0, 1096.98], [0, 2265.30, 513.137], [0, 0, 1]],
                         np.float32)[None], (b, 1, 1)) * rng.uniform(0.1, 1, (b, 1, 1))
    K[:, 2, 2] = 1
    E = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    for i in range(b):
        a, c = rng.randn(3) * 0.05, rng.randn(3)
        cx, sx, cy, sy, cz, sz = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]), np.cos(a[2]), np.sin(a[2])
        R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
             @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
             @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
        E[i, :3, :3], E[i, :3, 3] = R @ rdf_T_flu()[:3, :3], c
    T = np.stack([np.stack([np.asarray(unicycle_now_T_prev(
        np.float32(rng.uniform(2, 12)), np.float32(rng.randn() * 0.05),
        float(rng.uniform(0.1, 0.6))).numpy()) for _ in range(t)]) for _ in range(b)])
    K, E, T = (x.astype(np.float32) for x in (K, E, T))

    def chain(K, E, T):
        A = jnp.einsum("ij,tjk,kl->til", jnp.linalg.inv(E), T, E, precision=jax_pc._HP)
        B = jnp.einsum("tij,jk->tik", A[:, :3, :3], jnp.linalg.inv(K), precision=jax_pc._HP)
        return B, A[:, :3, 3]

    jB, jt = jax.jit(jax.vmap(chain))(K, E, T)
    B, tr = _camera_maps(torch.from_numpy(K), torch.from_numpy(E), torch.from_numpy(T))
    np.testing.assert_array_equal(B.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jt))
    general = (rng.randn(16, 4, 4) * np.exp(rng.randn(16, 4, 4))).astype(np.float32)
    np.testing.assert_array_equal(_inv(general).astype(np.float32),
                                  np.asarray(jax.jit(jax.vmap(jnp.linalg.inv))(general)))
