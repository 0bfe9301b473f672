"""Cells at a size the CPU holds, for the harness's tests: the same files
as the real cells, the sizes cut by each runner's ``tiny`` (forecast:
1024x2048 to 64x128, the fg ROI features 256x14x14 to 32x7x7; bg
training: crops 800 to 128 at batch 2, the file tree to 12 frames of
64x128)."""

from __future__ import annotations

import copy

from portbench.harness import cell


# A cell whose harness, traffic and limits are in place but which
# BENCHMARK.json does not hold yet (PERF.md §7): its runs at the 0.25
# bound's cap spread too far. The tests resolve it from these names: its
# entry, and its name added to the metrics it would report.
PENDING = {"bg_train.loader8": {
    "config": "bg_train", "traffic": "files48", "chips": 1,
    "metrics": ["train_step_ms", "train.mfu", "train.idle_share", "train.launches_per_step",
                "train.loader_wait_ms"]}}


def manifest() -> dict:
    """``BENCHMARK.json`` with the pending cells added."""
    man = cell.manifest()
    held = {w["name"] for w in man["workloads"]}
    for name, p in PENDING.items():
        if name not in held:
            man["workloads"].append({"name": name, "config": p["config"],
                                     "traffic": p["traffic"], "chips": p["chips"]})
            for m in man["end_to_end"] + man["per_layer"]:
                if m["name"] in p["metrics"]:
                    m["workloads"].append(name)
    return man


def spec(name: str, **limits) -> dict:
    s = copy.deepcopy(cell.resolve(name, manifest()))
    cell.runner(s["config"]["kind"]).tiny(s)
    s["limits"].update(limits)
    return s
