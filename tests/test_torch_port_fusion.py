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

import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.eval import fusion as jax_fusion
from panoptic_forecasting_tpu_torch.eval import fusion
from test_torch_port_common import fg_fixture, jit_jax_models, port_fg

torch.set_num_threads(2)

H, W = 64, 128
STATS = {  # (mean, std) of boxes/velocities in a 128-wide frame
    "traj": ([64, 32, 16, 16, 0, 0, 0, 0], [30, 12, 6, 6, 2, 1, 1, 1]),
    "depth": ([20.0, 0.0], [10.0, 1.0]),
    "odom": ([8.2, 0.0, 0.5, 0.0, 0.0], [0.3, 0.01, 0.02, 1.0, 1.0]),
}
VARIANTS = ("canvas", "bg_depth", "bg_depth_mask", "no_depth_sorting")
FUNCS = ("predict_panoptic", "predict_semantics", "predict_instances")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg, jax_model, variables, batch = fg_fixture(str(tmp_path_factory.mktemp("fusion")))
    for name, (mean, std) in STATS.items():
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
