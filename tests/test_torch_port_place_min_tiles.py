"""Port parity: the tile-owned passes of K1 ``place_min``
(panoptic_forecasting_tpu_torch/csrc/placement.cu) on the CPU.

The CUDA passes run only on the card. What surrounds them runs here: the
host's plan (``place_min_plan``: tile size, tile count, scratch sizes,
grids) on the edge shapes, and a numpy emulation of the three passes
under that plan (count and exclusive scan, partition into per-tile
buckets CTA by CTA, place each tile's bucket into an EMPTY window, a
bucket longer than a place chunk a chunk a window, taken in by min). The
emulation's canvas is held bit for bit to ``place_min_plain`` and to the
TPU kernel ``place_sorted``, run as tests/test_torch_port_zbuffer.py runs
it (interpret mode on the lexsorted stream, block 512, sw 1024).
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.kernels.placement import place_sorted
from panoptic_forecasting_tpu_torch.kernels import build, placement
from panoptic_forecasting_tpu_torch.kernels.placement import (
    EMPTY,
    place_min,
    place_min_plain,
    place_min_plan,
)
from test_torch_port_zbuffer import _stream

torch.set_num_threads(2)
TILE = 1 << placement.TILE_SHIFT


def emulate(g, k, num_groups, plan, place_chunk=placement.PLACE_CHUNK):
    """The passes of csrc/placement.cu::place_min in numpy, CTA by CTA in
    grid order, with ``place_chunk`` bucket entries a place CTA. Returns
    (canvas, bucket starts, bucket ends, bucket): the bucket's rows past
    the kept entries stay -7."""
    shift, tile, tiles = plan["tile_shift"], plan["tile"], plan["tiles"]
    keep = (g >= 0) & (g < num_groups)
    tile_of = np.where(keep, g >> shift, -1)
    # 1. count, then the last CTA's scans: bucket starts, the chunk
    # prefix of the hot tiles (buckets longer than one chunk)
    count = np.bincount(tile_of[keep], minlength=tiles).astype(np.int64)
    counters = np.concatenate([[0], np.cumsum(count)[:-1]])
    starts = counters.copy()
    hot = np.where(count > place_chunk, -(-count // place_chunk), 0)
    chunks = np.concatenate([[0], np.cumsum(hot)])
    # 2. partition: each CTA sorts its entries by tile and reserves its
    # run in every touched bucket; the hot tiles' canvas to EMPTY
    chunk = placement.PART_CHUNK
    bucket = np.full((g.size, 2), -7, np.int32)
    for c in range(plan["part_ctas"]):
        idx = np.nonzero(tile_of[c * chunk:(c + 1) * chunk] >= 0)[0] + c * chunk
        idx = idx[np.argsort(tile_of[idx], kind="stable")]
        tiles_c, first, n_c = np.unique(tile_of[idx], return_index=True,
                                        return_counts=True)
        base = counters[tiles_c]
        counters[tiles_c] += n_c
        pos = np.repeat(base - first, n_c) + np.arange(idx.size)
        bucket[pos] = np.stack([g[idx] & (tile - 1), k[idx]], 1)
    ends = counters
    canvas = np.full(num_groups, -7, np.int32)
    for t in np.nonzero(hot)[0]:
        canvas[t * tile:(t + 1) * tile] = EMPTY
    placed = np.zeros(g.size, np.int64)  # how often each bucket row is placed

    def window_of(begin, end):
        placed[begin:end] += 1
        window = np.full(tile, EMPTY, np.int32)
        np.minimum.at(window, bucket[begin:end, 0], bucket[begin:end, 1])
        return window

    # 3. place: CTA b < tiles writes a cold tile once; CTA tiles + j finds
    # hot chunk j's tile in the chunk prefix and takes the min into it
    place_ctas = tiles + 2 * (g.size // place_chunk)  # the plan's grid
    assert place_chunk != placement.PLACE_CHUNK or place_ctas == plan["place_ctas"]
    assert chunks[-1] <= place_ctas - tiles  # an upper bound
    for b in range(place_ctas):
        if b < tiles:
            if hot[b]:
                continue
            t, begin = b, (ends[b - 1] if b else 0)
        elif b - tiles < chunks[-1]:
            j = b - tiles
            t = int(np.searchsorted(chunks[:-1], j, side="right")) - 1
            begin = (ends[t - 1] if t else 0) + (j - chunks[t]) * place_chunk
            assert begin < ends[t]
        else:
            continue
        window = window_of(begin, min(ends[t], begin + place_chunk))
        seg = canvas[t * tile:(t + 1) * tile]
        if b < tiles:
            seg[:] = window[:seg.size]
        else:
            np.minimum(seg, window[:seg.size], out=seg)
    kept = int(keep.sum())
    assert (placed[:kept] == 1).all() and (placed[kept:] == 0).all()
    return canvas, starts, ends, bucket


def check_emulation(g, k, num_groups, plan, place_chunk=placement.PLACE_CHUNK):
    """The emulated passes under ``plan``: buckets that tile the kept
    entries, offsets inside their tile, dropped groups never written, and
    the plain version's canvas. Returns the canvas."""
    canvas, starts, ends, bucket = emulate(g, k, num_groups, plan,
                                           place_chunk)
    kept = int(((g >= 0) & (g < num_groups)).sum())
    assert starts[0] == 0 and ends[-1] == kept
    np.testing.assert_array_equal(ends[:-1], starts[1:])
    assert (bucket[kept:] == -7).all() and (bucket[:kept, 0] >= 0).all()
    last = slice(starts[-1], ends[-1])
    assert (bucket[last, 0] < plan["last_tile"]).all()
    want = place_min_plain(torch.from_numpy(g), torch.from_numpy(k),
                           num_groups).numpy()
    np.testing.assert_array_equal(canvas, want)
    return canvas


@pytest.mark.parametrize("n,num_groups,want", [
    # num_groups = 1: one tile of the smallest size
    (5, 1, dict(tile_shift=2, tiles=1, last_tile=1, part_ctas=1)),
    # below one tile: the next power of two
    (20_000, 5000, dict(tile_shift=13, tiles=1, last_tile=5000)),
    # whole tiles, and one group past them
    (7, 3 * TILE, dict(tile_shift=14, tiles=3, last_tile=TILE)),
    (7, 3 * TILE + 1, dict(tile_shift=14, tiles=4, last_tile=1)),
    # N = 0: only the place pass, every tile EMPTY
    (0, 3 * TILE + 1, dict(tiles=4, count_ctas=0, part_ctas=0, place_ctas=4,
                           bucket_entries=0, counters=10)),
    # the forecast stream: 3 frames x 4 planes x 1024 x 2048
    (6_291_456, 25_165_824, dict(tiles=1536, count_ctas=264, part_ctas=1536,
                                 place_ctas=1536 + 768, counters=3074,
                                 window_bytes=65536, shared_histogram=True)),
    # past kHistMax tiles the entries go straight to the global cursors
    (1, 2**31 - 1, dict(tiles=131072, last_tile=TILE - 1,
                        shared_histogram=False)),
])
def test_plan_on_edge_shapes(n, num_groups, want):
    plan = place_min_plan(n, num_groups)
    got = {key: plan[key] for key in want}
    assert got == want
    assert plan["tile"] == 1 << plan["tile_shift"]
    assert plan["place_ctas"] == plan["tiles"] + 2 * (n // placement.PLACE_CHUNK)
    assert (plan["tiles"] - 1) * plan["tile"] + plan["last_tile"] == num_groups
    assert 0 < plan["last_tile"] <= plan["tile"]
    assert plan["part_ctas"] * placement.PART_CHUNK >= n
    assert (plan["part_ctas"] - 1) * placement.PART_CHUNK < max(n, 1)


def test_plan_rejects_what_the_kernel_cannot_take():
    for n, groups, shift in ((1, 0, 14), (1, 2**31, 14), (-1, 8, 14),
                             (1, 8, 1), (1, 8, 16)):
        with pytest.raises(ValueError):
            place_min_plan(n, groups, shift)


def test_plan_constants_match_the_source():
    """The plan's sizes are those csrc/placement.cu launches with."""
    src = (build.CSRC / "placement.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert placement.PART_CHUNK == const("kPartThreads") * const("kPartSlots")
    assert placement.PLACE_CHUNK == const("kPlaceChunk")
    assert placement.HIST_TILES == const("kHistMax")
    assert (placement.MIN_TILE_SHIFT, placement.MAX_TILE_SHIFT) == (
        const("kMinTileShift"), const("kMaxTileShift"))


def _one_tile_stream(rng):
    """Every entry in one tile of a four-tile canvas, a run of equal
    groups among them (the skewed bucket of the design)."""
    num_groups, n = 4 * 512 + 9, 9000
    g = 2 * 512 + rng.randint(0, 512, n)
    g[100:400] = 2 * 512 + 7
    return g.astype(np.int32), rng.randint(0, 2**30, n).astype(np.int32), num_groups


@pytest.mark.parametrize(
    "case", ["uniform", "pileup", "sparse", "key_zero", "sentinels", "one_tile"]
)
def test_emulated_passes_match_place_sorted(case):
    """Under the real plan, and under tiles of 512 and 64 groups (many
    tiles, a ragged last one) with buckets longer than a place CTA's chunk
    (the spill pass), the emulated passes give the plain version's canvas
    and the TPU kernel's."""
    rng = np.random.RandomState(7)
    if case == "one_tile":
        g, k, num_groups = _one_tile_stream(rng)
    else:
        g, k, num_groups = _stream(case, rng)
    order = np.lexsort((k, g))
    jax_out = np.asarray(place_sorted(
        jnp.asarray(g[order]), jnp.asarray(k[order]), num_groups=num_groups,
        interpret=True, block=512, sw=1024,
    ))
    for shift, place_chunk in ((placement.TILE_SHIFT, placement.PLACE_CHUNK),
                               (9, 700), (6, 64)):
        plan = place_min_plan(g.size, num_groups, shift)
        np.testing.assert_array_equal(
            check_emulation(g, k, num_groups, plan, place_chunk), jax_out)


def test_emulated_passes_drop_ignored_groups():
    """Negative groups, groups >= num_groups (2^31 - 1 and -2^31 among
    them), keys 0 and 2^31 - 2, over a canvas one group past whole tiles
    and over one group; N = 0 leaves every tile EMPTY."""
    rng = np.random.RandomState(11)
    n = 3 * placement.PART_CHUNK + 5
    g = rng.randint(-700, 1700, n).astype(np.int32)
    g[::7] = 2**31 - 1
    g[3::7] = -2**31
    k = rng.randint(0, 2**31 - 1, n).astype(np.int32)
    k[::9] = 0
    k[1::9] = 2**31 - 2
    for num_groups, shift in ((2 * 512 + 1, 9), (1, 14), (1500, 14)):
        canvas = check_emulation(g, k, num_groups,
                                 place_min_plan(n, num_groups, shift), 1000)
        assert (canvas == 0).any() or num_groups == 1
    empty = np.zeros(0, np.int32)
    canvas = check_emulation(empty, empty, 1025,
                             place_min_plan(0, 1025, 9))
    assert (canvas == EMPTY).all()


def test_place_min_cpu_runs_the_plain_version():
    """A CPU tensor takes place_min_plain and launches nothing."""
    before = place_min.launches
    g = torch.tensor([3, -1, 3, 9, 0], dtype=torch.int32)
    k = torch.tensor([5, 1, 2, 7, 0], dtype=torch.int32)
    out = place_min(g, k, 4)
    assert out.tolist() == [0, EMPTY, EMPTY, 2]
    assert place_min.launches == before
