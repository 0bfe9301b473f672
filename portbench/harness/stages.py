"""The forecast step's device time by stage, from the ``pb.*`` ranges the
harness opened: ``pb.step`` around each step call, ``pb.bg_model`` and
``pb.fg_model`` around the two models' forwards (module hooks). A device
operation belongs to the stage in which it was launched: the
reprojection before the bg model's range opens, the background inside
it, the foreground inside the fg model's, and the fusion after the bg
model's range closes, outside the fg model's. Host-to-device copies are
left out of every stage."""

from __future__ import annotations

import bisect
from typing import Dict


def split_us(trace) -> Dict[str, float]:
    """Summed device µs of each stage over the traced steps."""
    steps = trace.ranges.get("pb.step", [])
    bg = trace.ranges.get("pb.bg_model", [])
    fg = trace.ranges.get("pb.fg_model", [])
    out = {"pc": 0.0, "bg": 0.0, "fg": 0.0, "fusion": 0.0}

    def inside(spans, t):
        i = bisect.bisect_right([s for s, _ in spans], t) - 1
        return i >= 0 and t <= spans[i][1], i

    for o in trace.in_window():
        if o.cat == "gpu_memcpy":
            continue
        in_step, k = inside(steps, o.launch)
        if not in_step:
            continue
        s0, s1 = steps[k]
        b = [r for r in bg if s0 <= r[0] <= s1]
        dur = o.end - o.start
        if inside(fg, o.launch)[0]:
            out["fg"] += dur
        elif not b or o.launch < b[0][0]:
            out["pc"] += dur
        elif o.launch <= b[0][1]:
            out["bg"] += dur
        else:
            out["fusion"] += dur
    return out
