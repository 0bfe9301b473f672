"""The traffic generator: the same seed gives the same pool, another
seed another pool of the same sizes, with the stated shapes."""

import types

import numpy as np
import pytest
import torch

from portbench.harness import traffic
from portbench.tests import tiny

SEED = 2**31 + 17


def pools(name, seed):
    s = tiny.spec(name)
    return traffic.make(s["traffic"], s["config"], seed, torch.device("cpu")), s


def flat(pool):
    out = []
    for item in pool:
        parts = item if isinstance(item, tuple) else (item["inputs"], item["labels"])
        for d in parts:
            out += [d[k] for k in sorted(d)]
    return out


@pytest.mark.parametrize("name", ["forecast_short.scene8", "forecast_short.crowd32",
                                  "bg_train.pool8", "bg_train.loader8"])
def test_deterministic_per_seed(name):
    a, _ = pools(name, SEED)
    b, _ = pools(name, SEED)
    c, _ = pools(name, SEED + 1)
    if isinstance(a, types.GeneratorType):  # files: one frame at a time
        a, b, c = ([v for x in p for v in (x["segs"], x["depth"], x["gt"])] for p in (a, b, c))
    else:
        a, b, c = flat(a), flat(b), flat(c)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["forecast_short.scene8", "forecast_short.crowd32"])
def test_scene_shapes(name):
    pool, s = pools(name, SEED)
    c, t = s["config"], s["traffic"]
    assert len(pool) == t["pool"]
    counts = []
    for pc_in, fg_in in pool:
        assert pc_in["seg"].shape == (1, c["num_inputs"], c["height"], c["width"])
        assert pc_in["seg"].dtype == np.int32 and pc_in["seg"].min() >= 0
        assert pc_in["seg"].max() <= 10
        assert (pc_in["depth"][~pc_in["depth_mask"]] == 0).all()
        assert pc_in["depth"].max() <= c["max_depth"] * 1.01
        assert pc_in["target_T"].shape == (1, c["num_inputs"], 4, 4)
        assert fg_in["trajectories"].shape == (1, t["slots"], c["num_inputs"], 8)
        assert fg_in["feats"].shape[:3] == (1, t["slots"], c["num_inputs"])
        counts.append(int(fg_in["valid"].sum()))
    lo, hi = t["valid_slots"]
    assert sorted(counts) == sorted(np.linspace(lo, hi, t["pool"]).round().astype(int))


def test_crop_batches():
    pool, s = pools("bg_train.pool8", SEED)
    size, b = s["config"]["data"]["crop_size"], s["traffic"]["batch"]
    for batch in pool:
        seg, dep = batch["inputs"]["seg"], batch["inputs"]["depth"]
        gt = batch["labels"]["seg"]
        assert seg.shape == (b, 3, size, size) and seg.dtype == np.uint8
        assert dep.shape == seg.shape and dep.dtype == np.uint16
        assert gt.shape == (b, size, size) and set(np.unique(gt)) <= set(range(11)) | {255}
    rows = [x for batch in pool for x in batch["inputs"]["seg"]]
    assert len({r.tobytes() for r in rows}) == len(rows)  # every row differs


def test_file_tree_reads_back(tmp_path):
    """The written tree: the reference's PNG reader and the flat depth
    file give back the frames, and the port's own readers agree."""
    from panoptic_forecasting_tpu_torch.data import io as pio

    from portbench.harness import fixture
    from portbench.reference import bg_data

    s = tiny.spec("bg_train.loader8")
    frames = list(traffic.make(s["traffic"], s["config"], SEED, torch.device("cpu")))
    tree = fixture.write(iter(frames), str(tmp_path), 3)
    blocks = fixture.Blocks(tree["data"]["depth_h5_path"] % "train", tree["index"], tree["shape"])
    entries = bg_data.listing(str(tmp_path / "gt" / "train"))
    assert len(entries) == len(frames) == s["traffic"]["samples"]
    by_stem = {fixture.stem(f["name"]): f for f in frames}
    for entry in entries:
        f = by_stem[entry[2]]
        row = bg_data.read_sample(tree["data"], "train", entry, blocks.mmap_dataset)
        assert np.array_equal(row["segs"], f["segs"]) and np.array_equal(row["gt"], f["gt"])
        assert np.array_equal(row["depth"], f["depth"])
        assert np.array_equal(pio.load_png(entry[0]), f["gt"])
