"""Shared set-up of the port parity tests (tests/test_torch_port_*.py);
it holds no tests. The synthetic fg scene fixture of
tests/test_forecast_fused.py, a JAX FGModel initialised on it, and the
same weights in the port's FGModel; the reprojection scene of the
point-cloud tests."""

import jax
import numpy as np

from panoptic_forecasting_tpu.core import build_dataset, build_model
from panoptic_forecasting_tpu.data.synthetic import write_fg_fixture
from panoptic_forecasting_tpu_torch.models.convert import fg_state_dict_from_jax
from panoptic_forecasting_tpu_torch.geometry import rdf_T_flu, unicycle_now_T_prev
from panoptic_forecasting_tpu_torch.models.fg import FGModel

# The narrow fg widths of tests/test_forecast_fused.py.
FG_MODEL = {
    "mask_feat_channels": 32,
    "mask_feat_hw": 7,
    "mask_head": {"conv_dim": 32},
    "instance_feat_channels": 8,
    "instance_feat_hidden": 32,
    "loss_type": "smoothl1",
    "num_convlstm_layers": 1,
    "num_traj_out_layers": 1,
    "rnn_hidden": 32,
    "rnn_type": "gru",
    "traj_feat_channels": 16,
    "use_depth_inp": True,
    "use_odometry": True,
    "use_depth_sorting": True,
}


CANVAS_STATS = {  # (mean, std) of boxes/velocities in a 128-wide frame
    "traj": ([64, 32, 16, 16, 0, 0, 0, 0], [30, 12, 6, 6, 2, 1, 1, 1]),
    "depth": ([20.0, 0.0], [10.0, 1.0]),
    "odom": ([8.2, 0.0, 0.5, 0.0, 0.0], [0.3, 0.01, 0.02, 1.0, 1.0]),
}


def fg_fixture(root, model_overrides=None, cfg_overrides=None):
    """-> (cfg, jax FGModel, its variables, one scene batch (S, N, ...));
    ``cfg_overrides`` sets top-level keys (``use_bbox_ulbr``)."""
    write_fg_fixture(root, n_scenes=3, max_instances=3, feat_channels=32,
                     feat_hw=7)
    cfg = {
        "task": "fg",
        "seed": 0,
        "working_dir": root + "/run",
        "data": {
            "dataset_type": "fg_scene",
            "data_splits": ["val"],
            "data_dir": root,
            "depth_dir": root,
            "feats_dir": root,
            "info_3d_dir": root,
            "use_3d_info": True,
            "max_depth": 200,
            "require_most_recent": True,
            "instance_pad_multiple": 4,
        },
        "model": dict(FG_MODEL, **(model_overrides or {})),
        "training": {"batch_size": 2},
        **(cfg_overrides or {}),
    }
    inst_cfg = dict(cfg, data=dict(cfg["data"], dataset_type="fg_instance",
                                   data_splits=["train", "val"]))
    inst_data = build_dataset(inst_cfg)
    data = build_dataset(cfg, test=True)
    model = build_model(cfg, inst_data.card)
    batch = next(iter(data.loader("val", cfg, test=True)))

    def f(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[2:])

    init_batch = {
        "inputs": {k: f(v) for k, v in batch["inputs"].items()
                   if k not in ("background", "valid")},
        "labels": {
            "trajectories": f(batch["labels"]["trajectories"]),
            "output_inds": np.asarray(batch["labels"]["output_inds"]).reshape(-1),
        },
    }
    variables = jax.jit(lambda r: model.init(r, init_batch))(jax.random.PRNGKey(0))
    return cfg, model, jax.tree_util.tree_map(np.asarray, variables), batch


def fg_stats(jax_model):
    """The JAX FGModel's normalisation statistics, as the port takes them
    (a model without depth or odometry inputs has none of theirs)."""
    return {
        name: (np.asarray(getattr(jax_model, f"{name}_mean")),
               np.asarray(getattr(jax_model, f"{name}_std")))
        for name in ("traj", "depth", "odom") if hasattr(jax_model, f"{name}_mean")
    }


def port_fg(cfg, jax_model, variables, device="cpu"):
    stats = fg_stats(jax_model)
    model = FGModel(cfg, stats=stats, device=device)
    model.load_state_dict(fg_state_dict_from_jax(variables["params"], stats))
    return model


def pc_scene(rng, b, t, h, w, rotated=False):
    """(seg, depth, depth_mask, K, E, target_T) numpy inputs of the
    point-cloud transform, with the tests/test_forecast_fused.py camera
    and motion (one frame is a pure translation, which puts many points
    exactly on integer pixels); ``rotated`` tilts the camera and jitters
    the motion as well."""
    seg = rng.randint(0, 11, size=(b, t, h, w)).astype(np.int32)
    depth = (rng.rand(b, t, h, w) * 40 + 2).astype(np.float32)
    depth[:, :, :4] = 0.05  # near points: some land behind the moved camera
    depth_mask = rng.rand(b, t, h, w) > 0.1
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    E = (np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.0], [0, 0, 1, 1.1],
                   [0, 0, 0, 1]], np.float32) @ rdf_T_flu()).astype(np.float32)
    Ts = unicycle_now_T_prev(
        np.array([3.0, 2.0, 1.0], np.float32),
        np.array([0.02, 0.0, -0.01], np.float32), 0.35,
    ).numpy()
    E = np.tile(E[None], (b, 1, 1))
    Ts = np.tile(Ts[None], (b, 1, 1, 1))
    if rotated:
        a, c = 0.07, np.cos(0.07)
        tilt = np.array([[1, 0, 0], [0, c, -np.sin(a)], [0, np.sin(a), c]])
        E[:, :3, :3] = (E[:, :3, :3].astype(np.float64) @ tilt).astype(np.float32)
        Ts[..., :3, 3] += (rng.randn(b, t, 3) * 0.3).astype(np.float32)
    return seg, depth, depth_mask, np.tile(K[None], (b, 1, 1)), E, Ts


def jit_jax_models(mp):
    """Patch (on the MonkeyPatch ``mp``) the JAX bg and fg models so their
    CLIs run jitted on the CPU: ``init`` of both (the CLIs initialise
    eagerly, op by op, before restoring a checkpoint), the bg ``predict``
    and the fg ``forward`` (eager in the JAX export CLIs; minutes for
    HarDNet on the CPU). Jitted, the structure and values are the same."""
    from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
    from panoptic_forecasting_tpu.models.fg import FGModel as JaxFGModel

    def bg_init(self, rng, batch, _orig=JaxBGModel.init):
        return jax.jit(lambda r, x: _orig(self, r, {"inputs": x}))(rng, batch["inputs"])

    def fg_init(self, rng, batch, _orig=JaxFGModel.init):
        return jax.jit(lambda r: _orig(self, r, batch))(rng)

    def bg_predict(self, variables, batch, _orig=JaxBGModel.predict):
        if "_jit_predict" not in self.__dict__:
            self._jit_predict = jax.jit(lambda v, x: _orig(self, v, {"inputs": x}))
        return self._jit_predict(variables, batch["inputs"])

    def fg_forward(self, variables, inputs, out_t, _orig=JaxFGModel.forward):
        cache = self.__dict__.setdefault("_jit_forward", {})
        if out_t not in cache:
            cache[out_t] = jax.jit(lambda v, x: _orig(self, v, x, out_t))
        return cache[out_t](variables, inputs)

    mp.setattr(JaxBGModel, "init", bg_init)
    mp.setattr(JaxFGModel, "init", fg_init)
    mp.setattr(JaxBGModel, "predict", bg_predict)
    mp.setattr(JaxFGModel, "forward", fg_forward)
