"""Port parity: the foreground forecaster and the fg weight bridge.

Same fixture batch and weights through JAX ``FGModel.forward`` and the
port's ``FGModel``: trajectories within 1e-5, mask logits within 1e-4
(f32 GRU/ConvLSTM rollouts summed in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.models.reference_import import fg_from_reference
from panoptic_forecasting_tpu_torch.models.fg import expand_traj_mask
from test_torch_port_common import fg_fixture, fg_stats, port_fg

torch.set_num_threads(2)

# The narrow widths of tests/test_forecast_fused.py, and the same with the
# depth of configs/fg/fg_val_short.yaml (2 ConvLSTM layers, 2-layer heads).
VARIANTS = {
    "narrow": {},
    "deep": {"num_convlstm_layers": 2, "num_traj_out_layers": 2},
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def fg_case(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fgport"))
    return fg_fixture(root, VARIANTS[request.param])


def _flat_inputs(batch):
    def f(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[2:])

    inputs = {k: f(v) for k, v in batch["inputs"].items()
              if k not in ("background", "valid")}
    inputs["output_inds"] = f(batch["labels"]["output_inds"])
    out_t = int(np.asarray(batch["labels"]["trajectories"]).shape[2])
    return inputs, out_t


def test_fg_forward_matches_jax(fg_case):
    cfg, jax_model, variables, batch = fg_case
    inputs, out_t = _flat_inputs(batch)
    fwd = jax.jit(lambda v, i: jax_model.forward(v, i, out_t))
    ref = fwd(variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    out = port_fg(cfg, jax_model, variables)(inputs, out_t)
    np.testing.assert_allclose(
        out["unnormalized_trajectory"].numpy(),
        np.asarray(ref["unnormalized_trajectory"]), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        out["normalized_trajectory"].numpy(),
        np.asarray(ref["normalized_trajectory"]), rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(out["masks"].numpy(), np.asarray(ref["masks"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["mask_feats"].numpy(),
                               np.asarray(ref["mask_feats"]), rtol=0, atol=1e-4)


def test_fg_bridge_round_trips_through_reference_importer(fg_case):
    cfg, jax_model, variables, _ = fg_case
    model = port_fg(cfg, jax_model, variables)
    back, stats = fg_from_reference(model.state_dict(), instance_feat_channels=8,
                                    feat_hw=7)
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))
    for name, (mean, std) in fg_stats(jax_model).items():
        np.testing.assert_array_equal(stats[name][0], mean)
        np.testing.assert_array_equal(stats[name][1], std)


def test_expand_traj_mask_matches_jax():
    from panoptic_forecasting_tpu.models.fg import expand_traj_mask as jax_expand

    m = np.random.RandomState(0).rand(4, 6) > 0.4
    for kw in ({}, {"result_size": 1}, {"vel_mask": m[:, ::-1].copy()}):
        tkw = {k: torch.from_numpy(v) if k == "vel_mask" else v for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if k == "vel_mask" else v for k, v in kw.items()}
        np.testing.assert_array_equal(
            expand_traj_mask(torch.from_numpy(m), **tkw).numpy(),
            np.asarray(jax_expand(jnp.asarray(m), **jkw)),
        )


@pytest.mark.parametrize("opt", [{"rnn_type": "rnn"}, {"rnn_type": "LSTM"},
                                 {"loss_type": "l1"}])
def test_fg_rejects_unported_options(opt):
    """Every model option of the JAX model is ported
    (tests/test_torch_port_fg_options.py); what the port still refuses
    is what JAX refuses, with JAX's ValueError."""
    from panoptic_forecasting_tpu_torch.models.fg import FGModel

    with pytest.raises(ValueError, match="not recognized"):
        FGModel({"model": opt}, device="cpu")
