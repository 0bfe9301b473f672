"""K3: sortless min-window placement (the unsorted-stream min canvas).

Counterpart of ``panoptic_forecasting_tpu/kernels/experimental/
minwin.py::place_minwin``. Like the JAX module it is off every
production path: the forecast places its stream with K1
(``kernels/placement.py``); this one is reached by its profiling entry
point ``scripts/prof_minwin.py``.

``place_minwin`` returns ``(canvas, overflow)``. For a CUDA tensor both
come from ONE launch of the hand-written kernel ``csrc/minwin.cu``, after
the canvas fill (per block of ``block`` entries: spans and chunk count,
placement through a window of the canvas in shared memory, flush;
counted on ``place_minwin.launches``); for a CPU tensor from
``place_minwin_plain``:

* ``canvas`` (num_groups,) int32, the per-group min key, EMPTY where no
  entry lands. It is EXACT, whatever ``overflow`` says. The TPU kernel's
  canvas is exact only when its overflow is 0: with overflow > 0 it
  truncates its coverage and loses entries.
* ``overflow`` int32 scalar, equal to the JAX code's (minwin.py:226-282,
  computed there outside its pallas_call): the (supertile, block) chunks
  the stream's per-block group intervals need beyond the TPU kernel's
  static capacity ``5·nblocks + 2·n_super``. ``minwin_block_chunks`` is
  the per-block count the kernel adds up, ``minwin_overflow`` its plain
  total. It reports what the TPU kernel would do with this stream; the
  canvas here does not depend on it.

``win`` and ``sub`` are validated as in JAX and have no further effect
(they shape the TPU kernel's windows, which have no counterpart).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..placement import EMPTY, _check as _check_stream, place_min_plain

# Copies of panoptic_forecasting_tpu/kernels/placement.py:60-65.
_BIG = 0x7FFFFFFF
LANE = 128
SUB = 128
WIN = 384

_SIGNATURES = {
    "place_minwin": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                     ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p),
}


def _check(group, key, num_groups, block, sw, win, sub, plane_size,
           pile_width, debug_mode):
    if debug_mode != "":
        raise NotImplementedError(
            f"debug_mode={debug_mode!r} is a TPU timing probe that drops "
            "duplicate groups; it has no counterpart"
        )
    _check_stream(group, key, num_groups)
    # The JAX asserts (minwin.py:227-228, 334).
    if not (block > 0 and sub > 0 and block % sub == 0 and win % LANE == 0
            and sw % LANE == 0 and 0 < sw <= 65536 and win <= sw):
        raise ValueError(
            f"need block % sub == 0, win and sw multiples of {LANE}, "
            f"sw <= 65536 and win <= sw; got block={block} sub={sub} "
            f"win={win} sw={sw}"
        )
    if (block // sub) % 2:
        raise ValueError(
            f"block must hold an even number of sub-chunks, got "
            f"block={block} sub={sub}"
        )
    # Groups are int32, so a wider plane or a negative split means nothing.
    if not (0 <= plane_size < 2**31 and pile_width >= 0):
        raise ValueError(f"need 0 <= plane_size < 2^31 and pile_width >= 0, "
                         f"got plane_size={plane_size} pile_width={pile_width}")


def _range_size(lo, hi):
    return (hi - lo + 1).clamp(min=0)


def minwin_block_chunks(group: torch.Tensor, *, num_groups: int, block: int,
                        sw: int, plane_size: int = 0,
                        pile_width: int = 0) -> torch.Tensor:
    """Per block of the TPU kernel's padded stream, its chunk count:
    (nblocks,) int64, what ``csrc/minwin.cu`` adds up block by block.

    The stream is padded with ``_BIG`` to whole blocks plus one sentinel
    block (JAX minwin.py:229-237). Per block, three intervals of groups
    (interior, top pile, bottom pile; entries ``< num_groups`` count as
    valid, negative ones included, as in JAX) each cover a range of
    supertiles of ``sw`` groups; the count is the number of supertiles
    covered by at least one interval. Computed in int64, by
    inclusion-exclusion over the three supertile ranges.
    """
    n = group.numel()
    pad = (-n) % block + block
    g = torch.cat([group.to(torch.int64),
                   torch.full((pad,), _BIG, dtype=torch.int64,
                              device=group.device)])
    g = g.view(-1, block)
    n_super = (num_groups + (-num_groups) % sw) // sw

    valid = g < num_groups
    if plane_size and pile_width:
        local = g.remainder(plane_size)  # floor mod, as jnp's %
        top = valid & (local < pile_width)
        bot = valid & (local >= plane_size - pile_width)
        interior = valid & ~top & ~bot
    else:
        top = bot = torch.zeros_like(valid)
        interior = valid

    def supertiles(mask):
        """Per block, the supertiles [lo, hi] its masked interval meets."""
        mn = torch.where(mask, g, _BIG).amin(1)
        mx = torch.where(mask, g, -1).amax(1)
        lo = torch.div(mn, sw, rounding_mode="floor").clamp(min=0)
        hi = torch.div(mx, sw, rounding_mode="floor").clamp(max=n_super - 1)
        return lo, hi

    (a0, a1), (b0, b1), (c0, c1) = (supertiles(m) for m in (interior, top, bot))
    mx, mn = torch.maximum, torch.minimum
    return (
        _range_size(a0, a1) + _range_size(b0, b1) + _range_size(c0, c1)
        - _range_size(mx(a0, b0), mn(a1, b1))
        - _range_size(mx(a0, c0), mn(a1, c1))
        - _range_size(mx(b0, c0), mn(b1, c1))
        + _range_size(mx(mx(a0, b0), c0), mn(mn(a1, b1), c1))
    )


def minwin_overflow(group: torch.Tensor, *, num_groups: int, block: int,
                    sw: int, plane_size: int = 0,
                    pile_width: int = 0) -> torch.Tensor:
    """The TPU kernel's ``overflow`` (JAX minwin.py:229-282), int32 scalar:
    the chunks of ``minwin_block_chunks`` beyond the static capacity
    ``5·nblocks + 2·n_super``, clamped at 0."""
    chunks = minwin_block_chunks(group, num_groups=num_groups, block=block,
                                 sw=sw, plane_size=plane_size,
                                 pile_width=pile_width)
    n_super = (num_groups + (-num_groups) % sw) // sw
    maxchunks = 5 * chunks.numel() + 2 * n_super
    return (chunks.sum() - maxchunks).clamp(min=0).to(torch.int32)


def place_minwin_plain(group: torch.Tensor, key: torch.Tensor, *,
                       num_groups: int, block: int = 4096, sw: int = 65536,
                       win: int = WIN, sub: int = SUB, plane_size: int = 0,
                       pile_width: int = 0, debug_mode: str = ""):
    """Plain PyTorch version of K3: ``scatter_reduce_`` amin + overflow."""
    _check(group, key, num_groups, block, sw, win, sub, plane_size,
           pile_width, debug_mode)
    return (place_min_plain(group, key, num_groups),
            minwin_overflow(group, num_groups=num_groups, block=block, sw=sw,
                            plane_size=plane_size, pile_width=pile_width))


def place_minwin(group: torch.Tensor, key: torch.Tensor, *, num_groups: int,
                 block: int = 4096, sw: int = 65536, win: int = WIN,
                 sub: int = SUB, plane_size: int = 0, pile_width: int = 0,
                 debug_mode: str = ""):
    """(canvas (num_groups,) int32, overflow () int32) from an unsorted
    (group, key) stream; see the module docstring.

    ``group``/``key``: (N,) int32 in any order, keys in [0, 2^31 - 2];
    groups outside [0, num_groups) are ignored by the canvas.
    ``plane_size``/``pile_width``: the pile split of the overflow count.
    CUDA tensors launch ``csrc/minwin.cu`` once for both outputs (and
    count a launch); CPU tensors run ``place_minwin_plain``.
    """
    _check(group, key, num_groups, block, sw, win, sub, plane_size,
           pile_width, debug_mode)
    if group.device.type == "cpu":
        return place_minwin_plain(group, key, num_groups=num_groups,
                                  block=block, sw=sw, win=win, sub=sub,
                                  plane_size=plane_size,
                                  pile_width=pile_width)
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    group = group.contiguous()
    key = key.contiguous()
    dev = group.device
    canvas = torch.empty((num_groups,), dtype=torch.int32, device=dev)
    # [0:2] the kernel's two uint64 counters, [4] (as int32) the overflow
    scratch = torch.empty((3,), dtype=torch.int64, device=dev)
    overflow = scratch.view(torch.int32)[4]
    build.launch(build.load("minwin", _SIGNATURES).place_minwin, dev,
                 group.data_ptr(), key.data_ptr(), group.numel(),
                 canvas.data_ptr(), num_groups, block, sw, plane_size,
                 pile_width, overflow.data_ptr(), scratch.data_ptr())
    place_minwin.launches += 1
    return canvas, overflow


place_minwin.launches = 0


__all__ = ["EMPTY", "LANE", "SUB", "WIN", "minwin_block_chunks",
           "minwin_overflow", "place_minwin", "place_minwin_plain"]
