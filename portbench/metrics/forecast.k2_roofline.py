"""forecast.k2_roofline: K2 (kernels/stem.py::onehot_stem_conv, the
one-hot assembly and first convolution in one kernel) against its bound,
in %. Bytes from the problem's shapes: each frame's int32 ids and f32
depth read once, the 16-channel f32 stem output written once; operations
as the ids need them (all ids in range); the time is that of K2's
kernels in the trace."""

from portbench.harness.flops import k2_bytes, k2_flops
from portbench.harness.peaks import bound_s

KERNELS = ("stem_kernel",)
STEM_CH = 16


def read(trace, counts, spec):
    cfg = spec["config"]
    us = sum(o.end - o.start for o in trace.full.in_window()
             if o.cat == "kernel" and any(k in o.name for k in KERNELS))
    if us <= 0:
        return None
    t, h, w, n = cfg["num_inputs"], cfg["height"], cfg["width"], counts["frames"]
    need = bound_s(k2_bytes(t, h, w, STEM_CH), k2_flops(t, h, w, STEM_CH)) * n
    return 100.0 * need / (us / 1e6)
