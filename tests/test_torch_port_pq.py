"""Port parity of PQ scoring: ``eval/pq.py``, the GT side of
``eval/panoptic_protocol.py`` and the GT tree the port's fixture writes.

The port's scorer runs the JAX package's host numpy in the same order,
so on the same maps its counts must be equal and its IoU sums equal to
1e-12 (in practice bit-equal). The literal oracle constants of
tests/test_eval_oracle_fixtures.py (hand-derived from the panopticapi
definitions) hold the port as they hold JAX.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from panoptic_forecasting_tpu.data.synthetic import (
    write_cityscapes_fixture as jax_write_cityscapes_fixture,
)
from panoptic_forecasting_tpu.eval import panoptic_protocol as jax_protocol
from panoptic_forecasting_tpu.eval import pq as jax_pq
from panoptic_forecasting_tpu_torch.data import synthetic
from panoptic_forecasting_tpu_torch.data.io import load_png, save_png
from panoptic_forecasting_tpu_torch.eval import panoptic_protocol, pq

CAR, ROAD, SIDEWALK, PERSON = 26, 7, 8, 24
STUFF = (7, 8, 11, 21, 23)
THINGS = (24, 26, 27)
NOT_EVAL = (4, 9)  # static (void category), parking (ignored in eval)


def _category(sid):
    return sid // 1000 if sid >= 1000 else sid


def _random_maps(seed):
    """(gt, gt_segments, pred, pred_segments): blocky maps of stuff,
    thing instances, crowd regions (a thing labelId below 1000), void 0
    and classes outside the eval set; the prediction is the gt with
    blocks relabelled, instances merged and pixels flipped."""
    rng = np.random.RandomState(seed)
    pool = (list(STUFF) + [t * 1000 + k for t in THINGS for k in range(3)]
            + list(THINGS[:2]) + list(NOT_EVAL) + [0])
    gt = np.repeat(np.repeat(rng.choice(pool, (6, 10)), 8, 0), 8, 1)
    pred = gt.copy()
    for _ in range(12):  # relabel whole blocks, with offsets
        y, x = rng.randint(0, 40), rng.randint(0, 72)
        pred[y:y + rng.randint(4, 12), x:x + rng.randint(4, 12)] = rng.choice(pool)
    pred[gt == THINGS[1] * 1000 + 1] = THINGS[1] * 1000  # merge two instances
    flip = rng.rand(*gt.shape) < 0.05
    pred[flip] = rng.choice(pool, int(flip.sum()))
    pred[pred == THINGS[0]] = 0  # no crowd in predictions

    def segments(seg, crowd):
        return [{"id": int(s), "category_id": _category(int(s)),
                 "iscrowd": int(crowd and s < 1000 and s in THINGS)}
                for s in np.unique(seg) if s != 0]

    return gt, segments(gt, True), pred, segments(pred, False)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pq_single_image_matches_jax(seed):
    gt, gs, pred, ps = _random_maps(seed)
    assert any(s["iscrowd"] for s in gs) and (gt == 0).any()
    want = jax_pq.pq_compute_single_image(gt, gs, pred, ps)
    got = pq.pq_compute_single_image(gt, gs, pred, ps)
    assert sorted(got.per_cat) == sorted(want.per_cat)
    for c, w in want.per_cat.items():
        g = got.per_cat[c]
        assert (g.tp, g.fp, g.fn) == (w.tp, w.fp, w.fn), c
        assert abs(g.iou - w.iou) <= 1e-12, c
    assert sum(s.tp for s in got.per_cat.values()) > 0
    assert sum(s.fp + s.fn for s in got.per_cat.values()) > 0
    assert pq.summarize(got) == jax_pq.summarize(want)
    assert pq.format_results(pq.summarize(got)) == jax_pq.format_results(
        jax_pq.summarize(want))


def test_pq_rejects_what_jax_rejects():
    gt, gs, pred, ps = _random_maps(0)
    with pytest.raises(ValueError, match="shape mismatch"):
        pq.pq_compute_single_image(gt, gs, pred[:-1], ps)
    with pytest.raises(ValueError, match="no segments_info entry"):
        pq.pq_compute_single_image(gt, gs, pred, ps[1:])


# ---- the literal oracle constants of tests/test_eval_oracle_fixtures.py -------


def _strip(spans, fill=0, n=100):
    a = np.full((1, n), fill, np.int64)
    for s, e, v in spans:
        a[0, s : e + 1] = v
    return a


def test_pq_oracle_void_union():
    # union = 60 + 80 - 60 - 20 (pred ∩ VOID) = 60 -> IoU 1.0, not 0.75
    res = pq.summarize(pq.pq_compute_single_image(
        _strip([(0, 59, 1)]), [{"id": 1, "category_id": CAR}],
        _strip([(0, 79, 2)]), [{"id": 2, "category_id": CAR}],
    ))
    assert res["All"]["n"] == 1
    assert res["All"]["pq"] == pytest.approx(1.0)
    car = res["per_class"]["car"]
    assert (car["pq"], car["sq"], car["rq"]) == pytest.approx((1.0, 1.0, 1.0))


def test_pq_oracle_exact_half_iou_no_match():
    # road IoU 20/40 = 0.5 exactly: no match; sidewalk IoU 6/7
    res = pq.summarize(pq.pq_compute_single_image(
        _strip([(0, 29, 1), (30, 99, 2)]),
        [{"id": 1, "category_id": ROAD}, {"id": 2, "category_id": SIDEWALK}],
        _strip([(10, 39, 3), (40, 99, 4)]),
        [{"id": 3, "category_id": ROAD}, {"id": 4, "category_id": SIDEWALK}],
    ))
    assert res["All"]["n"] == 2
    assert res["per_class"]["road"]["pq"] == pytest.approx(0.0)
    assert res["per_class"]["road"]["valid"] is True
    assert res["per_class"]["sidewalk"]["pq"] == pytest.approx(6 / 7)
    assert res["per_class"]["sidewalk"]["rq"] == pytest.approx(1.0)
    assert res["All"]["pq"] == pytest.approx(3 / 7)
    assert res["All"]["rq"] == pytest.approx(0.5)


def test_pq_oracle_crowd_void_fp_discard():
    # pred 11 discarded (50/50 over void + crowd), pred 14 FP (8/16 = 0.5)
    res = pq.summarize(pq.pq_compute_single_image(
        _strip([(0, 39, 1), (60, 99, 2)]),
        [{"id": 1, "category_id": CAR, "iscrowd": 1},
         {"id": 2, "category_id": ROAD}],
        _strip([(0, 49, 11), (52, 67, 14), (68, 99, 13)]),
        [{"id": 11, "category_id": CAR}, {"id": 14, "category_id": CAR},
         {"id": 13, "category_id": ROAD}],
    ))
    assert res["All"]["n"] == 2
    assert res["per_class"]["car"]["pq"] == pytest.approx(0.0)
    assert res["per_class"]["car"]["valid"] is True
    road = res["per_class"]["road"]
    assert (road["pq"], road["sq"], road["rq"]) == pytest.approx((0.8, 0.8, 1.0))
    assert res["All"]["pq"] == pytest.approx(0.4)
    assert res["All"]["rq"] == pytest.approx(0.5)
    assert res["Things"]["pq"] == pytest.approx(0.0)
    assert res["Stuff"]["pq"] == pytest.approx(0.8)


# ---- GT conversion ----------------------------------------------------------------


def _instance_ids(seed, h=40, w=72):
    """A gtFine instanceIds map: stuff labelIds, thing instances
    (labelId*1000+k), crowd thing regions, ignored and void labels."""
    rng = np.random.RandomState(seed)
    pool = (list(STUFF) + [t * 1000 + k for t in THINGS for k in range(4)]
            + list(THINGS) + list(NOT_EVAL) + [0, 1, 3])
    return np.repeat(np.repeat(rng.choice(pool, (h // 8, w // 8)), 8, 0), 8, 1
                     ).astype(np.uint16)


@pytest.mark.parametrize("seed", [0, 5])
def test_gt_panoptic_from_instance_ids_matches_jax(seed):
    ids = _instance_ids(seed)
    got, segs = panoptic_protocol.gt_panoptic_from_instance_ids(ids)
    want, want_segs = jax_protocol.gt_panoptic_from_instance_ids(ids)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert segs == want_segs
    assert any(s["iscrowd"] for s in segs)


def _gt_tree(root, package):
    """Each package's fixture tree (2 snippets, stuff-only instanceIds),
    plus a snippet with instances, crowd and ignored labels written to
    both."""
    if package == "jax":
        jax_write_cityscapes_fixture(root, "val", n_snippets=2, height=40, width=72)
    else:
        synthetic.write_cityscapes_fixture(root, "val", n_snippets=2, height=40,
                                           width=72)
    path = os.path.join(root, "gtFine", "val", "othercity",
                        "othercity_000000_000019_gtFine_instanceIds.png")
    save_png(path, _instance_ids(7))


def _converted(json_path):
    with open(json_path) as f:
        anns = json.load(f)["annotations"]
    png_dir = os.path.join(os.path.dirname(json_path),
                           os.path.basename(json_path)[:-len(".json")])
    return anns, {a["file_name"]: np.array(Image.open(os.path.join(png_dir, a["file_name"])))
                  for a in anns}


def test_convert_gt_split_matches_jax(tmp_path, monkeypatch):
    """The port's fixture GT converted by the port equals the JAX
    fixture's converted by JAX (json and PNGs); a complete earlier
    conversion is reused, a partial one redone."""
    out = {}
    for package, convert in (("jax", jax_protocol.convert_gt_split),
                             ("port", panoptic_protocol.convert_gt_split)):
        root = str(tmp_path / package)
        _gt_tree(root, package)
        out[package] = _converted(convert(root, "val", root + "/gt"))
    anns, pngs = out["port"]
    want_anns, want_pngs = out["jax"]
    assert anns == want_anns
    assert pngs.keys() == want_pngs.keys()
    for name, arr in pngs.items():
        np.testing.assert_array_equal(arr, want_pngs[name])
    assert any(s["id"] >= 1000 for a in out["port"][0] for s in a["segments_info"])

    root = str(tmp_path / "port")
    monkeypatch.setattr(panoptic_protocol, "write_panoptic_png",
                        lambda *a: pytest.fail("a complete conversion was redone"))
    panoptic_protocol.convert_gt_split(root, "val", root + "/gt")
    monkeypatch.undo()
    os.remove(os.path.join(root, "gt", "cityscapes_panoptic_val",
                           "othercity_000000_000019_gtFine_panoptic.png"))
    panoptic_protocol.convert_gt_split(root, "val", root + "/gt")
    assert _converted(os.path.join(root, "gt", "cityscapes_panoptic_val.json"))[0] \
        == out["jax"][0]


def test_pq_folders_self_score(tmp_path):
    """The port's fixture GT scored against itself: PQ 1 on every class
    present, with PNGs read by the port's codec."""
    root = str(tmp_path)
    synthetic.write_cityscapes_fixture(root, "val", n_snippets=2, height=40, width=72)
    gt_json = panoptic_protocol.convert_gt_split(root, "val", root + "/gt")
    gt_dir = root + "/gt/cityscapes_panoptic_val"
    res = pq.pq_compute_folders(gt_json, gt_dir, gt_json, gt_dir)
    valid = {k: v for k, v in res["per_class"].items() if v["valid"]}
    assert set(valid) == {"road", "building", "sky"}
    assert all(v["pq"] == 1.0 for v in valid.values())
    assert res["Stuff"]["pq"] == 1.0 and res["Things"]["n"] == 1
    ids = load_png(os.path.join(gt_dir, "synthcity_000000_000019_gtFine_panoptic.png"))
    assert ids.shape == (40, 72, 3)
