"""Both packages' staged chain against their own fused CLI, at any size.

Builds the fixture of ``test_torch_port_staged.py`` (the JAX package's
``data/synthetic.py``, 3 Cityscapes snippets, 2 fg scenes, JAX-seeded
weights carried over to the port) at ``--height`` x ``--width`` and runs
every staged CLI and the fused CLI of both packages on the CPU. Prints,
per forecast frame and package, the share of pixels where the staged
panoptic map differs from the fused one and the segment ids found in
one map only, then the share of pixels where the two packages' mismatch
masks disagree.

Usage (on the CPU; 256x512 takes about 2 minutes and under 3 GiB):
    JAX_PLATFORMS=cpu python tests/staged_vs_fused_witness.py --height 256 --width 512
"""

import argparse
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]
import test_torch_port_staged as staged  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=staged.H)
    ap.add_argument("--width", type=int, default=staged.W)
    args = ap.parse_args(argv)
    staged.H, staged.W = args.height, args.width
    with tempfile.TemporaryDirectory() as root, pytest.MonkeyPatch.context() as mp:
        staged.jit_jax_models(mp)
        world = staged._world(root)
        masks = {}
        for side, name in (("jax", staged.PANOPTIC), ("port", "staged_val")):
            run = staged._side(world, side, "fg_run")
            maps, _ = staged._panoptic(run, name)
            fused, _ = staged._panoptic(run, "fused_panoptics_val")
            masks[side] = {}
            for frame, f in fused.items():
                masks[side][frame] = maps[frame] != f
                one_map = sorted(int(k) for k in set(np.unique(maps[frame]))
                                 ^ set(np.unique(f)))
                print(f"{side} {frame} {args.height}x{args.width}: staged against "
                      f"fused {masks[side][frame].mean():.6f} of pixels, ids in one "
                      f"map only {one_map}")
        for frame, m in masks["jax"].items():
            print(f"{frame}: the packages' mismatch masks disagree on "
                  f"{(m != masks['port'][frame]).mean():.6f} of pixels")


if __name__ == "__main__":
    main()
