"""Cells at a size the CPU holds, for the harness's tests: the same files
as the real cells, the sizes cut (1024x2048 to 64x128, the fg ROI
features 256x14x14 to 32x7x7, crops 800 to 128 at batch 2, the file
tree to 12 frames of 64x128)."""

from __future__ import annotations

import copy

from portbench.harness import cell


# A cell whose harness, traffic and limits are in place but which
# BENCHMARK.json does not hold yet (PERF.md §7): its runs at the 0.25
# bound's cap spread too far. The tests resolve it from these names.
PENDING = {"bg_train.loader8": {"config": "bg_train", "traffic": "files48", "chips": 1,
                                "moves": "train_step_ms"}}


def manifest() -> dict:
    """``BENCHMARK.json`` with the pending cells added."""
    man = cell.manifest()
    held = {w["name"] for w in man["workloads"]}
    for name, p in PENDING.items():
        if name not in held:
            man["workloads"].append({"name": name, "config": p["config"],
                                     "traffic": p["traffic"], "chips": p["chips"]})
            for m in man["end_to_end"]:
                if m["name"] == p["moves"]:
                    m["workloads"].append(name)
    return man


def spec(name: str, **limits) -> dict:
    s = copy.deepcopy(cell.resolve(name, manifest()))
    c, t = s["config"], s["traffic"]
    if c["kind"] == "forecast":
        c.update(height=64, width=128)
        c["bg"]["model"].update(final_h=64, final_w=128)
        c["fg"]["model"].update(mask_feat_channels=32, mask_feat_hw=7,
                                mask_head={"conv_dim": 32})
        c["fg_stats"]["traj"] = [[x / 16 for x in v] for v in c["fg_stats"]["traj"]]
        t["pool"] = 3
    else:
        c["data"]["crop_size"] = 128
        c["training"]["batch_size"] = 2
        if t["kind"] == "files":
            t.update(samples=12, size=[64, 128])
        else:
            t.update(pool=4, batch=2)
    s["limits"].update(limits)
    return s
