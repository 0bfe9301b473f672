"""Port parity: K3 ``place_minwin`` (panoptic_forecasting_tpu_torch.
kernels.experimental.minwin) against the JAX package's TPU kernel.

The streams are the seven cases of tests/test_place_minwin.py plus one
with negative groups, made with numpy from a seed. The JAX side runs as
its own tests run it on the CPU: ``interpret=True``, block=512,
sw=1024. Tolerance is exact everywhere: ``overflow`` must be equal in
every case; the port's canvas must always equal numpy's scatter-min, and
equal JAX's whenever JAX reports overflow 0 (with overflow > 0 the TPU
kernel truncates its coverage; the port's canvas stays exact).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.kernels.experimental.minwin import (
    place_minwin as jax_place_minwin,
)
from panoptic_forecasting_tpu.kernels.placement import place_sorted
from panoptic_forecasting_tpu_torch.kernels.experimental.minwin import (
    EMPTY,
    minwin_overflow,
    place_minwin,
    place_minwin_plain,
)
from panoptic_forecasting_tpu_torch.scripts import prof_minwin

torch.set_num_threads(2)

KW = dict(block=512, sw=1024)


def _case(name):
    """(group, key, num_groups, extra kwargs) of one test stream."""
    kw = {}
    if name == "unsorted_with_duplicates":
        rng = np.random.RandomState(0)
        n, g = 4096, 3000
        group = rng.randint(0, g, n)
        key = rng.randint(0, 2**30, n)
    elif name == "key_zero_and_sentinels":
        g = 16
        group = np.array([5, 5, 7, 2**30, 9, 5])
        key = np.array([3, 0, 11, 1, 0, 2])
    elif name == "locally_coherent_wide_canvas":
        rng = np.random.RandomState(1)
        n, g = 8192, 6000
        base = np.linspace(0, g - 50, n).astype(np.int64)
        group = np.clip(base + rng.randint(-40, 40, n), 0, g - 1)
        key = rng.randint(0, 2**28, n)
    elif name == "sorted_stream":
        rng = np.random.RandomState(2)
        n, g = 2048, 1500
        group = np.sort(rng.randint(0, g, n))
        key = rng.randint(0, 2**29, n)
        order = np.lexsort((key, group))
        group, key = group[order], key[order]
    elif name == "overflow_detection":
        rng = np.random.RandomState(3)
        n, g = 512 * 40, 1024 * 30
        group = rng.randint(0, g, n)
        key = rng.randint(0, 2**28, n)
    elif name == "pile_plus_interior":
        rng = np.random.RandomState(4)
        n, g = 4096, 5000
        base = np.linspace(1024, g - 50, n).astype(np.int64)
        group = np.clip(base + rng.randint(-30, 30, n), 0, g - 1)
        pile = rng.rand(n) < 0.02
        group = np.where(pile, rng.randint(0, 64, n), group)
        key = rng.randint(0, 2**28, n)
    elif name == "pile_classification_multi_plane":
        rng = np.random.RandomState(6)
        plane, pile_w, nplanes = 4096, 128, 3
        g = plane * nplanes
        per = 16384 // nplanes
        parts = []
        for p in range(nplanes):
            base = np.linspace(pile_w, plane - pile_w - 40, per).astype(np.int64)
            loc = np.clip(base + rng.randint(-30, 30, per), 0, plane - 1)
            r = rng.rand(per)
            loc = np.where(r < 0.05, rng.randint(0, pile_w, per), loc)
            loc = np.where(r > 0.95, plane - 1 - rng.randint(0, pile_w, per), loc)
            parts.append(loc + p * plane)
        group = np.concatenate(parts)
        key = rng.randint(0, 2**28, per * nplanes)
        kw = dict(plane_size=plane, pile_width=pile_w)
    elif name == "negative_groups":
        # Negative groups are ignored by every canvas but count as valid
        # in JAX's spans (g < num_groups): they widen a block's interval
        # down to supertile 0, and with the pile split they are classified
        # by floor mod.
        rng = np.random.RandomState(8)
        n, g = 6144, 8192
        base = np.linspace(0, g - 50, n).astype(np.int64)
        group = np.clip(base + rng.randint(-30, 30, n), 0, g - 1)
        neg = rng.rand(n) < 0.03
        group = np.where(neg, -rng.randint(1, 3000, n), group)
        key = rng.randint(0, 2**28, n)
        kw = dict(plane_size=2048, pile_width=64)
    else:
        raise ValueError(name)
    return group.astype(np.int32), key.astype(np.int32), g, kw


CASES = ["unsorted_with_duplicates", "key_zero_and_sentinels",
         "locally_coherent_wide_canvas", "sorted_stream", "overflow_detection",
         "pile_plus_interior", "pile_classification_multi_plane",
         "negative_groups"]


def _scatter_min(group, key, num_groups):
    ref = np.full(num_groups, EMPTY, np.int32)
    keep = (group >= 0) & (group < num_groups)
    np.minimum.at(ref, group[keep], key[keep])
    return ref


@pytest.mark.parametrize("name", CASES)
def test_place_minwin_matches_jax(name):
    group, key, g, kw = _case(name)
    jc, jov = jax_place_minwin(jnp.asarray(group), jnp.asarray(key),
                               num_groups=g, interpret=True, **KW, **kw)
    jc, jov = np.asarray(jc), int(jov)
    canvas, ov = place_minwin(torch.from_numpy(group), torch.from_numpy(key),
                              num_groups=g, **KW, **kw)
    assert canvas.dtype == torch.int32 and ov.dtype == torch.int32
    assert ov.shape == ()
    assert int(ov) == jov
    if name == "overflow_detection":
        assert jov == 935
    else:
        assert jov == 0
    np.testing.assert_array_equal(canvas.numpy(), _scatter_min(group, key, g))
    if jov == 0:
        np.testing.assert_array_equal(canvas.numpy(), jc)
    else:  # the TPU kernel truncated its coverage; the port did not
        assert int((jc != canvas.numpy()).sum()) == 11725
    if name == "sorted_stream":
        ps = np.asarray(place_sorted(jnp.asarray(group), jnp.asarray(key),
                                     num_groups=g, interpret=True, **KW))
        np.testing.assert_array_equal(canvas.numpy(), ps)


def test_place_minwin_empty_stream():
    empty = np.zeros(0, np.int32)
    jc, jov = jax_place_minwin(jnp.asarray(empty), jnp.asarray(empty),
                               num_groups=300, interpret=True, **KW)
    canvas, ov = place_minwin(torch.from_numpy(empty), torch.from_numpy(empty),
                              num_groups=300, **KW)
    assert int(ov) == int(jov) == 0
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jc))
    assert (canvas == EMPTY).all()


@pytest.mark.parametrize("bad", [
    dict(block=500),            # block % sub
    dict(win=200),              # win % LANE
    dict(sw=1000),              # sw % LANE
    dict(sw=131072, win=384),   # sw <= 65536
    dict(win=2048),             # win <= sw
    dict(block=384),            # odd number of sub-chunks (:334)
], ids=["block_sub", "win_lane", "sw_lane", "sw_max", "win_sw", "odd_subs"])
def test_place_minwin_validates_like_jax(bad):
    group = np.arange(64, dtype=np.int32)
    kw = dict(KW, **bad)
    with pytest.raises(AssertionError):
        jax_place_minwin(jnp.asarray(group), jnp.asarray(group),
                         num_groups=64, interpret=True, **kw)
    with pytest.raises(ValueError):
        place_minwin(torch.from_numpy(group), torch.from_numpy(group),
                     num_groups=64, **kw)


def test_place_minwin_rejects_debug_modes_and_bad_inputs():
    g = torch.zeros(8, dtype=torch.int32)
    for mode in ("nofix", "alwaysfix"):
        with pytest.raises(NotImplementedError):
            place_minwin(g, g, num_groups=8, debug_mode=mode)
    with pytest.raises(TypeError):
        place_minwin(g.long(), g, num_groups=8)
    with pytest.raises(ValueError):
        place_minwin(g, g[:3], num_groups=8)


def test_overflow_counts_supertile_block_pairs():
    """The inclusion-exclusion count against a dense (supertile, block)
    overlap matrix built as the JAX code builds it (minwin.py:266-282)."""
    rng = np.random.RandomState(11)
    block, sw, g, plane, pw = 256, 512, 9000, 3000, 200
    group = rng.randint(-500, g + 500, 256 * 23).astype(np.int32)
    half = group.size // 2
    group[:half] = np.sort(group[:half])  # coherent blocks, then scattered ones
    gp = np.concatenate([group, np.full((-group.size) % block + block,
                                        0x7FFFFFFF, np.int32)]).astype(np.int64)
    g2 = gp.reshape(-1, block)
    valid = g2 < g
    local = g2 % plane
    top, bot = valid & (local < pw), valid & (local >= plane - pw)
    n_super = -(-g // sw)
    s_lo = np.arange(n_super)[:, None] * sw
    overlap = np.zeros((n_super, g2.shape[0]), bool)
    for m in (valid & ~top & ~bot, top, bot):
        mn = np.where(m, g2, 0x7FFFFFFF).min(1)
        mx = np.where(m, g2, -1).max(1)
        overlap |= (mn[None] <= s_lo + sw - 1) & (mx[None] >= s_lo)
    want = max(int(overlap.sum()) - (5 * g2.shape[0] + 2 * n_super), 0)
    got = minwin_overflow(torch.from_numpy(group), num_groups=g, block=block,
                          sw=sw, plane_size=plane, pile_width=pw)
    assert int(got) == want


def test_prof_minwin_entry_point_cpu(capsys):
    """The entry point on the CPU at a small plane: K3 against K1 on the
    script's stream, equal canvases, the (block, win) sweep, DONE; the
    reported overflow equals JAX's on the same stream."""
    h, w = 32, 64
    assert prof_minwin.main(["--device", "cpu", "--height", str(h),
                             "--width", str(w)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("mismatches: 0")
    assert out[-1] == "DONE"
    assert sum("overflow:" in line for line in out) == 1 + 9
    group, key = prof_minwin.make_stream(h, w)
    pk = prof_minwin.pile_kwargs(h, w)
    _, jov = jax_place_minwin(jnp.asarray(group), jnp.asarray(key),
                              num_groups=3 * h * w, interpret=True, **KW, **pk)
    canvas, ov = place_minwin_plain(torch.from_numpy(group),
                                    torch.from_numpy(key),
                                    num_groups=3 * h * w, **KW, **pk)
    assert int(ov) == int(jov)
    np.testing.assert_array_equal(canvas.numpy(),
                                  _scatter_min(group, key, 3 * h * w))
