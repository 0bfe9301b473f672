"""Where K2's time goes: the stem kernel beside copies with one part cut.

    python -m panoptic_forecasting_tpu_torch.scripts.prof_stem [--height 1024 --width 2048]

Builds ``csrc/stem.cu`` as it is and in ablated copies, each with one part
of the kernel cut by a textual edit: no arithmetic (``no_compute``: stage
the windows, store the bias), the input windows staged for a CTA's first
tile only (``no_stage``), no output stores (``no_store``), no depth FMAs
(``no_depth``), one weight of each gathered class row instead of 16
(``no_class``). Times each at the forecast's stem shape (3 frames of seg
ids drawn uniformly from 0..10 and normalised depth, 11 classes) by CUDA
events and by profiler device time, in two passes over the variants, and
prints the kernel's max abs difference from the plain version. Only the
unablated kernel computes the function; the others time a part. GPU only.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import build
from ..kernels.stem import _SIGNATURES, onehot_stem_conv_plain
from ._timing import device_ms, time_ms

# {anchor in csrc/stem.cu: replacement} per ablation
ABLATIONS = {
    "no_compute": {"    for (int t = 0; t < T; ++t) {":
                   "    for (int t = 0; t < 0; ++t) {"},
    "no_stage": {"i0 < n_chunks; i0 += kStage * kThreads) {":
                 "i0 < (tile == (int)blockIdx.x ? n_chunks : 0);"
                 " i0 += kStage * kThreads) {"},
    "no_store": {"      if (y >= H2) break;":
                 "      if (y >= H2 || acc[p][0] != 12345.f) break;"},
    "no_depth": {"          if (use_depth) {": "          if (use_depth == 7) {"},
    "no_class": {"for (int o = 0; o < kCout; ++o) acc[p][o] += wrow[o];":
                 "acc[p][0] += wrow[0];"},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("prof_stem times the CUDA kernel; CUDA is not available")
    # The plain version's F.conv2d must compute in full f32, as the
    # reference does; cuDNN would default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    frames, classes = 3, 11
    shape = (1, frames, args.height, args.width)
    g = torch.Generator().manual_seed(args.seed)
    seg = torch.randint(0, classes, shape, generator=g, dtype=torch.int32).to(dev)
    depth = torch.randn(shape, generator=g).to(dev)
    kern = (torch.randn(3, 3, frames * (classes + 1), 16, generator=g) * 0.2).to(dev)
    bias = torch.randn(16, generator=g).to(dev)
    out = torch.empty((1, args.height // 2, args.width // 2, 16), device=dev)
    fns = {name: lib.onehot_stem_conv for name, lib in build.load_edited(
        "stem", {"kernel": {}, **ABLATIONS}, _SIGNATURES).items()}

    def run(fn):
        build.launch(fn, dev, seg.data_ptr(), depth.data_ptr(), kern.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), *shape,
                     classes, 16, 1)
        return out

    run(fns["kernel"])
    want = onehot_stem_conv_plain(seg, depth, kern, bias, num_classes=classes)
    print(f"kernel max abs diff from the plain version "
          f"{float((out - want).abs().max()):.3e}", flush=True)
    for rep in range(2):
        for name, fn in fns.items():
            print(f"pass {rep} {name:10s} ms {time_ms(lambda: run(fn), 50, 5):.4f} "
                  f"device_ms {device_ms(lambda: run(fn)):.4f}", flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
