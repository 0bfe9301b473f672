"""Port parity of the fusion of fg forecasts over bg canvases
(``eval/fusion.py``): ``predict_panoptic``, ``predict_semantics`` and
``predict_instances`` of both packages on one fg-scene batch (2 scenes
of the JAX package's fixture, 64x128 canvases) with the JAX weights
carried over by ``models/convert.py::fg_state_dict_from_jax`` and box
statistics of a 128-wide frame, so the instances land on the canvas.

Variants: a random canvas (things become void before the panoptic
composite); with a background depth map (the strict-``<`` z-buffer,
unknown depth 1e9); with its ``background_depth_mask``; and with
``use_depth_sorting`` false (slot order, no z-buffer). Ids and
per-instance orders, classes and scores must be equal; maps may differ
on < 1e-3 of pixels (threshold-boundary flips: the sigmoid and the paste
in another order), each instance mask too.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.eval import fusion as jax_fusion
from panoptic_forecasting_tpu.eval.forecast import _instance_ids as jax_instance_ids
from panoptic_forecasting_tpu_torch.eval import fusion
from test_torch_port_common import CANVAS_STATS, fg_fixture, jit_jax_models, port_fg

torch.set_num_threads(2)

H, W = 64, 128
VARIANTS = ("canvas", "bg_depth", "bg_depth_mask", "no_depth_sorting")
FUNCS = ("predict_panoptic", "predict_semantics", "predict_instances")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg, jax_model, variables, batch = fg_fixture(str(tmp_path_factory.mktemp("fusion")))
    for name, (mean, std) in CANVAS_STATS.items():
        setattr(jax_model, f"{name}_mean", np.asarray(mean, np.float32))
        setattr(jax_model, f"{name}_std", np.asarray(std, np.float32))
    model = port_fg(cfg, jax_model, variables)
    s = np.asarray(batch["inputs"]["valid"]).shape[0]
    rng = np.random.RandomState(0)
    bg_depth = (rng.rand(s, H, W) * 30 + 1).astype(np.float32)
    bg_depth[rng.rand(s, H, W) < 0.2] = 0.0  # unknown
    extra = {
        "canvas": {},
        "bg_depth": {"background_depth": bg_depth},
        "bg_depth_mask": {"background_depth": bg_depth,
                          "background_depth_mask": rng.rand(s, H, W) > 0.3},
        "no_depth_sorting": {"background_depth": bg_depth},
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jit_jax_models(mp)
        for variant in VARIANTS:
            sort = variant != "no_depth_sorting"
            jax_model.use_depth_sorting = model.use_depth_sorting = sort
            inputs = dict(batch["inputs"], background=rng.randint(0, 19, (s, H, W)),
                          **extra[variant])
            b = dict(batch, inputs=inputs)
            for fn in FUNCS:
                out[variant, fn] = (getattr(jax_fusion, fn)(jax_model, variables, b),
                                    getattr(fusion, fn)(model, b))
    return out


def _maps_match(got, want):
    assert got.shape == want.shape == (len(got), H, W)
    for g, w in zip(got, want):
        assert set(np.unique(g)) == set(np.unique(w))
        assert (g != w).mean() < 1e-3


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_panoptic_matches_jax(results, variant):
    want, got = results[variant, "predict_panoptic"]
    assert [list(i) for i in got["ids"]] == [list(i) for i in want["ids"]]
    _maps_match(got["seg"], np.asarray(want["seg"]))
    np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["depths"], want["depths"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)
    things = sum(int((m >= 11000).sum()) for m in got["seg"])
    assert things > 0  # instances were painted
    assert not ((got["seg"] >= 11) & (got["seg"] < 255)).any()  # canvas things void


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_semantics_matches_jax(results, variant):
    want, got = results[variant, "predict_semantics"]
    _maps_match(got["seg"], np.asarray(want["seg"]))
    np.testing.assert_allclose(got["depths"], want["depths"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_instances_matches_jax(results, variant):
    want, got = results[variant, "predict_instances"]
    assert [len(x) for x in got["instances"]] == [len(x) for x in want["instances"]]
    n = 0
    for g_insts, w_insts in zip(got["instances"], want["instances"]):
        for g, w in zip(g_insts, w_insts):
            assert (g["class_train_id"], g["score"]) == (w["class_train_id"], w["score"])
            assert g["mask"].shape == (H, W)
            assert (g["mask"] != w["mask"]).mean() < 1e-3
            np.testing.assert_allclose(g["bbox_ulbr"], w["bbox_ulbr"], rtol=1e-5, atol=1e-4)
            assert g["depth"] == pytest.approx(w["depth"], rel=1e-5, abs=1e-5)
            n += 1
    assert n > 0


def order_scenes():
    """(depths, classes, valid) of 4 scenes of 8 slots: depth ties and
    repeated classes, an all-invalid scene, a NaN depth (valid and
    padded)."""
    rng = np.random.RandomState(3)
    depths = rng.choice([4.0, 9.5, 9.5, 30.0], (4, 8)).astype(np.float32)
    classes = rng.randint(0, 3, (4, 8))
    valid = rng.rand(4, 8) > 0.3
    valid[1] = False
    valid[3] = True
    depths[2, [2, 5]] = np.nan
    valid[2, 2], valid[2, 5] = True, False
    return depths, classes, valid


@pytest.mark.parametrize("panoptic", [True, False], ids=["panoptic", "semantic"])
@pytest.mark.parametrize("sort", [True, False], ids=["depth_sorted", "slot_order"])
def test_visit_order_matches_jax(sort, panoptic):
    """The one visit order and id function against JAX's host loop
    (``eval/fusion.py::_order_and_ids``, ids by slot) and, in panoptic
    mode, its forecast step's (``eval/forecast.py::_instance_ids``, ids in
    visit order)."""
    depths, classes, valid = order_scenes()
    order, ids = fusion.visit_order(torch.from_numpy(depths), torch.from_numpy(classes),
                                    torch.from_numpy(valid), use_depth_sorting=sort,
                                    panoptic=panoptic)
    assert ids.dtype == torch.int32
    slot_ids = torch.zeros_like(ids).scatter_(1, order, ids).numpy()
    model = types.SimpleNamespace(use_depth_sorting=sort)
    for b in range(len(depths)):
        want_order, want_ids = jax_fusion._order_and_ids(model, depths[b], classes[b],
                                                         valid[b], panoptic)
        np.testing.assert_array_equal(order[b].numpy(), want_order)
        np.testing.assert_array_equal(slot_ids[b], want_ids)
        if panoptic:
            j_order, j_ids = jax_instance_ids(jnp.asarray(classes[b]), jnp.asarray(depths[b]),
                                              jnp.asarray(valid[b]), sort)
            np.testing.assert_array_equal(order[b].numpy(), np.asarray(j_order))
            np.testing.assert_array_equal(ids[b].numpy(), np.asarray(j_ids))
    assert (slot_ids[1] == 0).all() and (slot_ids[3] > 0).all()
