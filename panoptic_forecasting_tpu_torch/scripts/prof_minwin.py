"""K3 ``place_minwin`` against the generic placement (K1 ``place_min``)
on the raster-coherent 6.3 M-entry stream of the JAX package's
``scripts/experimental_prof_minwin.py``.

    python -m panoptic_forecasting_tpu_torch.scripts.prof_minwin [--device cpu]

Prints ``overflow:`` (what the TPU kernel's static capacity would report
on this stream) and the canvas mismatches against K1, CUDA-event times
of ``minwin_unsorted``, ``minwin_on_sorted`` and ``place_min`` (on the
GPU only: a CPU run prints none), then the overflow for each (block, win)
of the JAX script's sweep, each from one launch of the CUDA kernel on the
GPU. ``win`` shapes only the TPU kernel's windows (the CUDA kernel's
window follows ``block``), so the sweep has no times. Exits 1 when the
canvases differ.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.experimental.minwin import place_minwin
from ..kernels.placement import place_min
from ._timing import K, time_ms

FRAMES = 3


def make_stream(height: int = 1024, width: int = 2048, seed: int = 0):
    """(group, key) int32 numpy streams of the JAX script (:21-38): one
    canvas plane of P = H·W groups per frame; per frame P entries whose
    groups drift linearly over the plane with ±300 jitter, 1.5 % of them
    border-pile jumps into the plane's first row; keys in [0, 2^30)."""
    rng = np.random.RandomState(seed)
    plane = height * width
    parts = []
    for f in range(FRAMES):
        base = np.linspace(0, plane - 400, plane).astype(np.int64)
        g = np.clip(base + rng.randint(-300, 300, plane), 0, plane - 1)
        pile = rng.rand(plane) < 0.015
        g = np.where(pile, rng.randint(0, width, plane), g)
        parts.append(g + f * plane)
    group = np.concatenate(parts).astype(np.int32)
    key = rng.randint(0, 2**30, FRAMES * plane).astype(np.int32)
    return group, key


def pile_kwargs(height: int, width: int):
    """The script's pile split: one plane per frame, piles 2 rows wide."""
    return dict(plane_size=height * width, pile_width=2 * width)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    num_groups = FRAMES * h * w
    pk = pile_kwargs(h, w)

    group_np, key_np = make_stream(h, w)
    group = torch.from_numpy(group_np).to(dev)
    key = torch.from_numpy(key_np).to(dev)
    canvas_mw, ov = place_minwin(group, key, num_groups=num_groups, **pk)
    canvas_pm = place_min(group, key, num_groups)
    mismatches = int((canvas_mw != canvas_pm).sum())
    print("overflow:", int(ov), "mismatches:", mismatches, flush=True)

    order = np.lexsort((key_np, group_np))
    gs = torch.from_numpy(group_np[order]).to(dev)
    ks = torch.from_numpy(key_np[order]).to(dev)
    runs = (
        ("minwin_unsorted",
         lambda: place_minwin(group, key, num_groups=num_groups, **pk)),
        ("minwin_on_sorted",
         lambda: place_minwin(gs, ks, num_groups=num_groups, **pk)),
        ("place_min", lambda: place_min(group, key, num_groups)),
    )
    for label, fn in runs:
        if dev.type == "cuda":
            print(label, round(time_ms(fn, K), 4), "ms", flush=True)
        else:
            fn()
            print(label, "not measured (cpu)", flush=True)

    for blk in (2048, 4096, 8192):
        for win in (256, 384, 512):
            _, ov_bw = place_minwin(group, key, num_groups=num_groups,
                                    block=blk, win=win, **pk)
            print(f"minwin_blk{blk}_win{win} overflow: {int(ov_bw)}",
                  flush=True)
    print("DONE", flush=True)
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
