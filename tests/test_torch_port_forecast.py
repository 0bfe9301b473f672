"""Port parity of the whole slice: the port's forecast step against JAX
``build_forecast_step`` on the fixture of tests/test_forecast_fused.py.

Ids must match exactly; panoptic maps may differ on < 1e-3 of pixels
(threshold-boundary flips, the budget of test_forecast_fused.py); boxes
within 1e-4 plus 1e-6 relative (they are ~1000 px, where an f32 ulp is
6e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.eval.forecast import build_forecast_step as jax_step
from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu_torch.eval.forecast import build_forecast_step
from panoptic_forecasting_tpu_torch.geometry import rdf_T_flu, unicycle_now_T_prev
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import bg_state_dict_from_jax
from test_torch_port_common import CANVAS_STATS, fg_fixture, port_fg

torch.set_num_threads(2)

H, W, T = 64, 128, 3
BG_CFG = {
    "model": {"num_inputs": T, "convert2onehot": True, "use_depth_inps": True},
    "data": {"num_classes": 11},
}


def slice_inputs(scene_batch):
    """-> (pc_in, fg_in, out_t, (H, W)): a seeded reprojection scene with
    the fixture camera and motion for each scene of ``scene_batch``."""
    rng = np.random.RandomState(0)
    s = np.asarray(scene_batch["inputs"]["trajectories"]).shape[0]
    seg = rng.randint(0, 11, size=(s, T, H, W)).astype(np.int32)
    depth = (rng.rand(s, T, H, W) * 40 + 2).astype(np.float32)
    depth_mask = rng.rand(s, T, H, W) > 0.1
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    E = (np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.0], [0, 0, 1, 1.1],
                   [0, 0, 0, 1]], np.float32) @ rdf_T_flu()).astype(np.float32)
    Ts = unicycle_now_T_prev(
        np.array([3.0, 2.0, 1.0], np.float32),
        np.array([0.02, 0.0, -0.01], np.float32), 0.35,
    ).numpy()
    pc_in = {
        "seg": seg, "depth": depth, "depth_mask": depth_mask,
        "intrinsics": np.tile(K[None], (s, 1, 1)),
        "extrinsics": np.tile(E[None], (s, 1, 1)),
        "target_T": np.tile(Ts[None], (s, 1, 1, 1)),
    }
    out_t = int(np.asarray(scene_batch["labels"]["trajectories"]).shape[2])
    fg_in = {k: np.asarray(v) for k, v in scene_batch["inputs"].items()
             if k != "background"}
    fg_in["output_inds"] = np.asarray(scene_batch["labels"]["output_inds"])
    return pc_in, fg_in, out_t, (H, W)


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    cfg, fg_model, fg_vars, scene_batch = fg_fixture(
        str(tmp_path_factory.mktemp("fgslice"))
    )
    pc_in, fg_in, out_t, _ = slice_inputs(scene_batch)
    bg_model = JaxBGModel(BG_CFG)
    init = {"inputs": {k: jnp.asarray(pc_in[k][:1]) for k in ("seg", "depth", "depth_mask")}}
    bg_vars = jax.jit(lambda r: bg_model.init(r, init))(jax.random.PRNGKey(1))
    bg_vars = jax.tree_util.tree_map(np.asarray, bg_vars)
    return cfg, fg_model, fg_vars, bg_model, bg_vars, pc_in, fg_in, out_t


@pytest.mark.parametrize("folded", [False, True], ids=["bn", "folded"])
def test_forecast_step_matches_jax(slice_case, folded):
    cfg, fg_model, fg_vars, bg_model, bg_vars, pc_in, fg_in, out_t = slice_case
    if folded:  # the serving route: folded BN, fused one-hot stem
        bg_vars = jax.tree_util.tree_map(
            np.asarray, jax.jit(bg_model.maybe_fold)(bg_vars))
    ref = jax_step(bg_model, fg_model, height=H, width=W, out_t=out_t)(
        bg_vars, fg_vars, pc_in, fg_in)

    port_bg = BGModel(BG_CFG, device="cpu")
    if folded:
        port_bg = port_bg.maybe_fold()
    port_bg.load_state_dict(bg_state_dict_from_jax(bg_vars))
    assert port_bg.folded == folded
    step = build_forecast_step(port_bg, port_fg(cfg, fg_model, fg_vars),
                               height=H, width=W, out_t=out_t, device="cpu")
    assert_step_matches(step(pc_in, fg_in), ref, pc_in["seg"].shape[0])


@pytest.mark.parametrize("option", ["use_bg_depth", "no_depth_sorting"])
def test_forecast_step_fusion_options_match_jax(slice_case, option, monkeypatch):
    """The folded step with the fusion's options: instances z-buffered
    against the reprojected depth, or painted in slot order. Box
    statistics of a 128-wide frame land the instances on the canvas, and
    each option changes the map."""
    cfg, fg_model, fg_vars, bg_model, bg_vars, pc_in, fg_in, out_t = slice_case
    for name, (mean, std) in CANVAS_STATS.items():
        monkeypatch.setattr(fg_model, f"{name}_mean", np.asarray(mean, np.float32))
        monkeypatch.setattr(fg_model, f"{name}_std", np.asarray(std, np.float32))
    bg_vars = jax.tree_util.tree_map(np.asarray, jax.jit(bg_model.maybe_fold)(bg_vars))
    port_bg = BGModel(BG_CFG, device="cpu").maybe_fold()
    port_bg.load_state_dict(bg_state_dict_from_jax(bg_vars))
    port = port_fg(cfg, fg_model, fg_vars)
    kw = {"height": H, "width": W, "out_t": out_t, "device": "cpu"}
    plain = build_forecast_step(port_bg, port_fg(cfg, fg_model, fg_vars), **kw)(pc_in, fg_in)
    if option == "no_depth_sorting":
        monkeypatch.setattr(fg_model, "use_depth_sorting", False)
        port.use_depth_sorting = False
    kw["use_bg_depth"] = option == "use_bg_depth"
    out = build_forecast_step(port_bg, port, **kw)(pc_in, fg_in)
    del kw["device"]
    ref = jax_step(bg_model, fg_model, **kw)(bg_vars, fg_vars, pc_in, fg_in)
    assert_step_matches(out, ref, pc_in["seg"].shape[0])
    assert (out["panoptic"] >= 11000).any()
    assert not torch.equal(out["panoptic"], plain["panoptic"])


def assert_step_matches(out, ref, n_scenes):
    pan, pan_ref = out["panoptic"].numpy(), np.asarray(ref["panoptic"])
    assert pan.shape == pan_ref.shape == (n_scenes, H, W)
    assert pan.dtype == np.int32
    mismatch = float((pan != pan_ref).mean())
    assert mismatch < 1e-3, f"{mismatch:.2%} pixels differ"
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    assert (out["ids"].numpy() > 0).any()
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(ref["bbox"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(out["depths"].numpy(), np.asarray(ref["depths"]),
                               rtol=1e-5, atol=1e-5)
    assert float((out["bg_seg"].numpy() != np.asarray(ref["bg_seg"])).mean()) < 1e-3
    np.testing.assert_array_equal(out["bg_depth"].numpy(), np.asarray(ref["bg_depth"]))


def test_entry_points_refuse_missing_cuda(slice_case, monkeypatch):
    """The device rule: with no CUDA and no device="cpu", the entry point
    and the models raise instead of quietly running on the CPU."""
    cfg, fg_model, fg_vars, *_ , out_t = slice_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bg = BGModel(BG_CFG, device="cpu")
    fg = port_fg(cfg, fg_model, fg_vars)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_forecast_step(bg, fg, height=H, width=W, out_t=out_t)
    with pytest.raises(RuntimeError, match="CUDA"):
        BGModel(BG_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fg(cfg, fg_model, fg_vars, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_forecast_step(bg, fg, height=H, width=W, out_t=out_t, device="cuda")
