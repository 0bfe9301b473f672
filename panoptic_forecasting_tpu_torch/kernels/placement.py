"""K1: dense per-group min canvas of int32 keys (the z-buffer placement).

Counterpart of ``panoptic_forecasting_tpu/kernels/placement.py::
place_sorted``. The TPU kernel needs its stream sorted by (group, key);
min does not depend on order, so these take the stream as it comes. Two
entry points, both in ``csrc/placement.cu``:

* ``place_min``: the generic (num_groups,) canvas of any size, tile-owned:
  the canvas is cut into tiles that fit in shared memory, the stream is
  counted and partitioned into per-tile buckets, and one CTA per tile
  places its bucket in shared memory and writes its tile once (K3's
  entry point compares against it). ``place_min_plan`` is the host's plan
  of those passes;
* ``place_min_fold``: the forecast path's placement, fused with the
  packed z-buffer's corner fold: each entry of the (batch, corner plane,
  pixel) stream takes the min at its <= 4 pixels of a one-plane
  (batch, H, W) canvas, which is what ``fold_corners`` makes of
  ``place_min``'s 4-plane canvas.

For a CUDA tensor each launches its kernel (and counts the launch); for a
CPU tensor it runs its plain PyTorch version. The canvas is bit-identical
either way.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

EMPTY = 0x7FFFFFFF  # untouched group; a key of 0 is a valid key

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "place_min": (_P, _P, _I64, _P, _I64, _INT, _INT, _I64, _P, _P, _P),
    "place_min_fold": (_P, _P, _I64, _P, _INT, _INT, _INT, _P),
}

# place_min's passes (csrc/placement.cu): tiles of 2^TILE_SHIFT groups, a
# 64 KB shared-memory window each, so that three place CTAs fit an SM and
# one's fill and write overlap another's atomics; at most HIST_TILES tiles
# a partition CTA sorts locally (kHistMax; past it the entries go
# straight to the global cursors); at most COUNT_CTAS count CTAs (2 an SM
# of 132); PART_CHUNK = kPartThreads x kPartSlots entries a partition CTA;
# PLACE_CHUNK bucket entries a place CTA takes (kPlaceChunk): a longer
# (hot) bucket is placed a chunk a CTA, by at most 2 N / PLACE_CHUNK CTAs
# after the tiles' own.
TILE_SHIFT = 14
MIN_TILE_SHIFT, MAX_TILE_SHIFT = 2, 15
HIST_TILES = 8192
COUNT_CTAS = 132 * 2
PART_CHUNK = 256 * 16
PLACE_CHUNK = 16384


def place_min_plan(n: int, num_groups: int,
                   tile_shift: int = TILE_SHIFT) -> dict:
    """The host's plan of ``place_min``'s passes for N entries over
    ``num_groups`` groups: tiles of 2^shift groups (the smallest power of
    two >= num_groups, at least 4, when that is below 2^tile_shift), the
    tile count and the last tile's length, whether the counts go through
    a shared histogram, the scratch sizes (bucket entries of 8 bytes and
    64-bit counters: a cursor per tile, the ticket, the hot tiles' chunk
    prefix) and each pass's grid (the place pass's an upper bound: its
    CTAs past the chunks the hot buckets need return at once). N = 0
    launches only the place pass: every tile all EMPTY."""
    if not 0 < num_groups < 2**31 or n < 0:
        raise ValueError(f"need 0 < num_groups < 2^31 and n >= 0, got "
                         f"num_groups={num_groups} n={n}")
    if not MIN_TILE_SHIFT <= tile_shift <= MAX_TILE_SHIFT:
        raise ValueError(f"tile_shift {tile_shift} outside "
                         f"[{MIN_TILE_SHIFT}, {MAX_TILE_SHIFT}]")
    shift = min(tile_shift, max(MIN_TILE_SHIFT, (num_groups - 1).bit_length()))
    tile = 1 << shift
    tiles = -(-num_groups // tile)
    return {
        "tile_shift": shift, "tile": tile, "tiles": tiles,
        "last_tile": num_groups - (tiles - 1) * tile,
        "shared_histogram": tiles <= HIST_TILES,
        "bucket_entries": n, "counters": 2 * tiles + 2,
        "count_ctas": min(-(-n // PART_CHUNK), COUNT_CTAS),
        "part_ctas": -(-n // PART_CHUNK),
        "place_ctas": tiles + 2 * (n // PLACE_CHUNK),
        "window_bytes": 4 * tile,
    }


def place_min_plain(group: torch.Tensor, key: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """Plain PyTorch version of K1: ``scatter_reduce_`` with ``amin``."""
    canvas = torch.full((num_groups,), EMPTY, dtype=torch.int32,
                        device=group.device)
    keep = (group >= 0) & (group < num_groups)
    return canvas.scatter_reduce_(
        0, group[keep].long(), key[keep], "amin", include_self=True
    )


def _check(group: torch.Tensor, key: torch.Tensor, num_groups: int):
    if group.dtype != torch.int32 or key.dtype != torch.int32:
        raise TypeError(f"group/key must be int32, got {group.dtype}/{key.dtype}")
    if group.dim() != 1 or group.shape != key.shape:
        raise ValueError(
            f"group/key must be 1-D of one length, got {tuple(group.shape)}"
            f" and {tuple(key.shape)}"
        )
    if group.device != key.device:
        raise ValueError("group and key lie on different devices")
    if not 0 < num_groups < 2**31:
        raise ValueError(f"num_groups={num_groups} outside (0, 2^31)")


def place_min(group: torch.Tensor, key: torch.Tensor,
              num_groups: int) -> torch.Tensor:
    """(num_groups,) int32: per-group min key, EMPTY where no entry lands.

    ``group``/``key``: (N,) int32 in any order; entries whose group lies
    outside [0, num_groups) are ignored. CUDA tensors run the tile-owned
    CUDA passes of ``place_min_plan`` (a memset and up to three kernels;
    ``place_min.launches`` counts calls of this entry point, not CUDA
    launches); CPU tensors run ``place_min_plain``.
    """
    _check(group, key, num_groups)
    if group.device.type == "cpu":
        return place_min_plain(group, key, num_groups)
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    group = group.contiguous()
    key = key.contiguous()
    n = group.numel()
    plan = place_min_plan(n, num_groups)
    dev = group.device
    canvas = torch.empty((num_groups,), dtype=torch.int32, device=dev)
    bucket = torch.empty((plan["bucket_entries"],), dtype=torch.int64,
                         device=dev)
    counters = torch.empty((plan["counters"],), dtype=torch.int64, device=dev)
    lib = build.load("placement", _SIGNATURES)
    build.launch(lib.place_min, dev, group.data_ptr(), key.data_ptr(), n,
                 canvas.data_ptr(), num_groups, plan["tile_shift"],
                 plan["count_ctas"], plan["part_ctas"], bucket.data_ptr(),
                 counters.data_ptr())
    place_min.launches += 1
    return canvas


place_min.launches = 0


def _shift2(c: torch.Tensor, dv: int, du: int) -> torch.Tensor:
    """Shift (b, H, W) down by dv rows and right by du columns, EMPTY in."""
    out = torch.full_like(c, EMPTY)
    h, w = c.shape[-2:]
    out[:, dv:, du:] = c[:, : h - dv, : w - du]
    return out


def fold_corners(canvas4: torch.Tensor, batch: int, height: int,
                 width: int) -> torch.Tensor:
    """(batch·4·P,) corner canvases -> (batch, H, W) min canvas (JAX
    ``kernels/zbuffer.py`` :238-254): plane fv·2 + fu holds the points
    whose ceil corner lies fu columns right and fv rows down; what would
    leave the last column or row is dropped."""
    g = canvas4.view(batch, 4, height, width)
    g0, g1, g2, g3 = g.unbind(1)
    m00 = torch.minimum(torch.minimum(g0, g1), torch.minimum(g2, g3))
    m10 = torch.minimum(g1, g3)  # points whose ceil-u corner is base+1
    m01 = torch.minimum(g2, g3)
    return torch.minimum(
        torch.minimum(m00, _shift2(m10, 0, 1)),
        torch.minimum(_shift2(m01, 1, 0), _shift2(g3, 1, 1)),
    )


def fold_targets(group: torch.Tensor, key: torch.Tensor, *, batch: int,
                 height: int, width: int):
    """The (canvas index, key) pairs ``place_min_fold`` takes the min over:
    each entry with group b·4P + plane·P + row·W + col in [0, batch·4P) at
    b·P + row·W + col, and by its plane's ceil offsets (fu = plane & 1,
    fv = plane >> 1) one column right (fu, col < W - 1), one row down (fv,
    row < H - 1) and both. Returns (index int64 (M,), key int32 (M,))."""
    p = height * width
    keep = (group >= 0) & (group < batch * 4 * p)
    g, k = group[keep].long(), key[keep]
    b, rem = g // (4 * p), g % (4 * p)
    plane, base = rem // p, rem % p
    row, col = base // width, base % width
    t0 = b * p + base
    right = (plane % 2 == 1) & (col < width - 1)
    down = (plane // 2 == 1) & (row < height - 1)
    both = right & down
    return (torch.cat([t0, t0[right] + 1, t0[down] + width,
                       t0[both] + width + 1]),
            torch.cat([k, k[right], k[down], k[both]]))


def place_min_fold_plain(group: torch.Tensor, key: torch.Tensor, *,
                         batch: int, height: int,
                         width: int) -> torch.Tensor:
    """Plain PyTorch version of ``place_min_fold``: ``scatter_reduce_``
    with ``amin`` over ``fold_targets``. Equal to the JAX composition,
    ``fold_corners`` of the 4-plane canvas (tested)."""
    tgt, keys = fold_targets(group, key, batch=batch, height=height,
                             width=width)
    canvas = torch.full((batch * height * width,), EMPTY, dtype=torch.int32,
                        device=group.device)
    canvas.scatter_reduce_(0, tgt, keys, "amin", include_self=True)
    return canvas.view(batch, height, width)


def place_min_fold(group: torch.Tensor, key: torch.Tensor, *, batch: int,
                   height: int, width: int) -> torch.Tensor:
    """(batch, H, W) int32 one-plane min canvas of a packed z-buffer stream,
    EMPTY where no entry lands; equal to ``fold_corners(place_min(group,
    key, batch·4·H·W), ...)`` on any stream.

    ``group``/``key``: (N,) int32 in any order, groups b·4P + plane·P +
    pixel (P = H·W); groups outside [0, batch·4P) are ignored. CUDA tensors
    run the fused CUDA kernel (and count a launch); CPU tensors run
    ``place_min_fold_plain``.
    """
    if batch <= 0 or height <= 0 or width <= 0:
        raise ValueError(f"batch, height, width must be positive, got "
                         f"{batch}, {height}, {width}")
    _check(group, key, batch * 4 * height * width)
    if group.device.type == "cpu":
        return place_min_fold_plain(group, key, batch=batch, height=height,
                                    width=width)
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    group = group.contiguous()
    key = key.contiguous()
    canvas = torch.empty((batch, height, width), dtype=torch.int32,
                         device=group.device)
    lib = build.load("placement", _SIGNATURES)
    build.launch(lib.place_min_fold, group.device, group.data_ptr(),
                 key.data_ptr(), group.numel(), canvas.data_ptr(), batch,
                 height, width)
    place_min_fold.launches += 1
    return canvas


place_min_fold.launches = 0
