"""Port parity of the instance-AP scorer (``eval/instance_ap.py``).

The hand-computed cases of tests/test_instance_ap.py, each a case of one
parametrised test run through the port and through the JAX package (the
summaries must be equal, NaN where JAX has NaN, and give the case's
value); the file protocol of ``ap_compute_folders`` (a self-scored
export gives AP 1, a missing manifest raises); and a randomized
cross-check of both packages' ``ap_compute_folders`` on random exports.
"""

import math

import numpy as np
import pytest

from panoptic_forecasting_tpu.eval import instance_ap as jax_ap
from panoptic_forecasting_tpu_torch.data.io import load_png, save_png
from panoptic_forecasting_tpu_torch.eval import instance_ap

CAR, PERSON, ROAD = 26, 24, 7


def box_mask(h, w, r0, r1, c0, c1):
    m = np.zeros((h, w), bool)
    m[r0:r1, c0:c1] = True
    return m


def gt_map(h, w, *instances):
    """instances = (labelId, k, r0, r1, c0, c1); background ROAD."""
    g = np.full((h, w), ROAD, np.int64)
    for lid, k, r0, r1, c0, c1 in instances:
        g[r0:r1, c0:c1] = lid * 1000 + k
    return g


def _cases():
    """name -> ([(gt map, [(mask, labelId, score)])], {"class.key": value})."""
    g = gt_map(40, 40, (CAR, 0, 0, 20, 0, 20))
    car = g == CAR * 1000
    c = {}
    c["perfect"] = ([(g, [(car, CAR, 0.9)])],
                    {"allAp": 1.0, "allAp50": 1.0, "car.ap": 1.0, "person.ap": math.nan})
    g1 = gt_map(40, 40, (CAR, 0, 0, 20, 10, 30))
    c["partial_overlap"] = ([(g1, [(box_mask(40, 40, 0, 30, 10, 30), CAR, 0.9)])],
                            {"car.ap": 0.4, "car.ap50": 1.0})
    g2 = gt_map(40, 40, (CAR, 0, 0, 10, 0, 10))
    c["strictly_greater"] = ([(g2, [(box_mask(40, 40, 0, 20, 0, 10), CAR, 0.9)])],
                             {"car.ap50": 0.0})
    c["duplicate_low_second"] = ([(g, [(car, CAR, 0.9), (car, CAR, 0.4)])],
                                 {"car.ap50": 1.0})
    c["duplicate_low_first"] = ([(g, [(car, CAR, 0.4), (car, CAR, 0.9)])],
                                {"car.ap50": 1.0})
    c["fp_above_tp"] = ([(g, [(car, CAR, 0.5),
                              (box_mask(40, 40, 25, 39, 25, 39), CAR, 0.9)])],
                        {"car.ap50": 0.25})
    g3 = gt_map(40, 40, (CAR, 0, 0, 15, 0, 15), (CAR, 1, 20, 35, 20, 35))
    c["missed_gt"] = ([(g3, [(g3 == CAR * 1000, CAR, 0.9)])], {"car.ap50": 0.5})
    g4 = g.copy()
    g4[25:, :] = 4  # static: ignore_in_eval
    c["void_overlap"] = ([(g4, [(g4 == CAR * 1000, CAR, 0.9),
                                (box_mask(40, 40, 25, 39, 0, 39), CAR, 0.95)])],
                         {"car.ap": 1.0})
    c["stuff_not_void"] = ([(g, [(car, CAR, 0.5),
                                 (box_mask(40, 40, 25, 39, 0, 39), CAR, 0.9)])],
                           {"car.ap50": 0.25})
    g5 = gt_map(40, 40)
    g5[0:20, 0:20] = CAR  # group region
    c["group_only"] = ([(g5, [(box_mask(40, 40, 0, 20, 0, 20), CAR, 0.9)])],
                       {"car.ap": math.nan})
    g6 = g.copy()
    g6[25:, :] = CAR
    c["group_beside_instance"] = ([(g6, [(g6 == CAR * 1000, CAR, 0.9),
                                         (box_mask(40, 40, 25, 39, 0, 20), CAR, 0.95)])],
                                  {"car.ap50": 1.0})
    g7 = gt_map(40, 40, (CAR, 0, 0, 5, 0, 5))
    c["small_gt"] = ([(g7, [(g7 == CAR * 1000, CAR, 0.9)])],
                     {"car.ap": math.nan, "allAp": 0.0})
    c["wrong_class"] = ([(g, [(car, PERSON, 0.9)])],
                        {"car.ap": 0.0, "person.ap": math.nan})
    g8 = gt_map(40, 40, (CAR, 0, 10, 30, 10, 30))
    c["multi_image"] = ([(g, [(car, CAR, 0.9)]), (g8, [(g8 == CAR * 1000, CAR, 0.8)])],
                        {"car.ap": 1.0})
    return c


CASES = _cases()


def _summary(ap, images):
    stat = ap.APStat()
    for g, preds in images:
        stat += ap.match_single_image(g, preds)
    return ap.summarize(stat)


def _same(got, want):
    """Equal, NaN where the other is NaN."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_same(got[k], want[k]) for k in want)
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_summary_matches_jax(case):
    images, expect = CASES[case]
    got, want = _summary(instance_ap, images), _summary(jax_ap, images)
    assert _same(got, want)
    for key, value in expect.items():
        if "." in key:
            name, field = key.split(".")
            v = got["per_class"][name][field]
        else:
            v = got[key]
        assert (math.isnan(v) if math.isnan(value) else v == pytest.approx(value)), key


def test_eval_and_void_label_ids_match_jax():
    assert instance_ap.eval_label_ids() == jax_ap.eval_label_ids() == \
        [24, 25, 26, 27, 28, 31, 32, 33]
    assert instance_ap.void_label_ids() == jax_ap.void_label_ids()
    assert instance_ap.OVERLAPS == jax_ap.OVERLAPS


def _write_export(root, frames):
    """gt instanceIds maps under root/gt/city and the export layout of
    cli/export_instances.py under root/pred: frames = {name: (gt map,
    [(mask, labelId, score)])}."""
    gt_dir, pred_dir = root / "gt" / "city", root / "pred"
    gt_dir.mkdir(parents=True)
    pred_dir.mkdir()
    for name, (g, preds) in frames.items():
        save_png(str(gt_dir / f"{name}_gtFine_instanceIds.png"), g.astype(np.uint16))
        counts = {}
        with open(pred_dir / f"{name}.txt", "w") as f:
            for mask, lid, score in preds:
                k = counts[lid] = counts.get(lid, -1) + 1
                save_png(str(pred_dir / f"{name}_{lid}_{k}.png"),
                         mask.astype(np.uint8) * 255)
                f.write(f"{name}_{lid}_{k}.png {lid} {score:f}\n")
    return str(pred_dir), str(root / "gt")


def test_folder_protocol_self_scored_is_one(tmp_path):
    """An export of a gt map's own two thing instances scores AP 1, in
    both packages, and formats its table."""
    g = gt_map(48, 64, (CAR, 0, 0, 24, 0, 24), (PERSON, 3, 30, 44, 30, 44))
    pred_dir, gt_dir = _write_export(tmp_path, {"city_000000_000019": (g, [
        (g == CAR * 1000, CAR, 0.9), (g == PERSON * 1000 + 3, PERSON, 0.8)])})
    got = instance_ap.ap_compute_folders(pred_dir, gt_dir)
    assert _same(got, jax_ap.ap_compute_folders(pred_dir, gt_dir))
    assert got["allAp"] == got["allAp50"] == 1.0
    assert got["per_class"]["car"]["ap"] == got["per_class"]["person"]["ap"] == 1.0
    table = instance_ap.format_results(got)
    assert table == jax_ap.format_results(got) and "car" in table


def test_folder_protocol_missing_manifest_raises(tmp_path):
    g = gt_map(48, 64, (CAR, 0, 0, 24, 0, 24))
    pred_dir, gt_dir = _write_export(tmp_path, {"city_000000_000019": (g, [
        (g == CAR * 1000, CAR, 0.9)])})
    save_png(str(tmp_path / "gt" / "city" / "city_000000_000049_gtFine_instanceIds.png"),
             g.astype(np.uint16))
    for ap in (instance_ap, jax_ap):
        with pytest.raises(ValueError, match="no prediction manifest"):
            ap.ap_compute_folders(pred_dir, gt_dir)


def test_instance_ids_png_16bit_roundtrip(tmp_path):
    g = np.full((8, 8), CAR * 1000 + 7, np.uint16)
    save_png(str(tmp_path / "ids.png"), g)
    back = load_png(str(tmp_path / "ids.png"))
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, g)


@pytest.mark.parametrize("seed", range(3))
def test_randomized_folders_match_jax(tmp_path, seed):
    """Random exports (instances, small and group regions, void bands,
    several classes) scored by both packages' ``ap_compute_folders``."""
    rng = np.random.RandomState(seed)
    frames = {}
    for i in range(rng.randint(2, 5)):
        g = np.full((48, 64), ROAD, np.int64)
        if rng.rand() < 0.5:
            g[: rng.randint(4, 16)] = 4
        for k in range(rng.randint(0, 5)):
            r0, c0 = rng.randint(0, 40, 2)
            h, w = rng.randint(2, 24, 2)
            g[r0 : r0 + h, c0 : c0 + w] = rng.choice([CAR, PERSON]) * 1000 + k
        if rng.rand() < 0.4:
            r0, c0 = rng.randint(0, 40, 2)
            g[r0 : r0 + 8, c0 : c0 + 8] = CAR
        preds = []
        for _ in range(rng.randint(0, 6)):
            r0, c0 = rng.randint(0, 40, 2)
            h, w = rng.randint(2, 24, 2)
            preds.append((box_mask(48, 64, r0, r0 + h, c0, c0 + w),
                          int(rng.choice([CAR, PERSON])), float(rng.rand())))
        frames[f"city_{i:06d}_000019"] = (g, preds)
    pred_dir, gt_dir = _write_export(tmp_path, frames)
    got = instance_ap.ap_compute_folders(pred_dir, gt_dir)
    assert _same(got, jax_ap.ap_compute_folders(pred_dir, gt_dir))
