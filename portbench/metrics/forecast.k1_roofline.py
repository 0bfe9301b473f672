"""forecast.k1_roofline: K1 (kernels/placement.py::place_min_fold, the
packed z-buffer's placement and corner fold) against its bound, in %.
Bytes from the problem's shapes: the (group, key) int32 stream of every
point of every past frame read once, one int32 canvas a frame written
once; the time is that of K1's kernels in the trace."""

from portbench.harness.flops import k1_bytes
from portbench.harness.peaks import bound_s

KERNELS = ("fold_place", "fill_empty4")


def read(trace, counts, spec):
    cfg = spec["config"]
    us = sum(o.end - o.start for o in trace.full.in_window()
             if o.cat == "kernel" and any(k in o.name for k in KERNELS))
    if us <= 0:
        return None
    frames = cfg["num_inputs"] * counts["frames"]
    return 100.0 * bound_s(k1_bytes(frames, cfg["height"], cfg["width"])) / (us / 1e6)
