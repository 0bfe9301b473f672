"""Port parity: FCHarDNet-70 background model and the bg weight bridge.

The JAX BGModel is initialised from a seed, its BN statistics are made
non-trivial with numpy, and the same variables go to the port through
``models/convert.py``. Logits must agree to 1e-4 (f32 convolutions summed
in another order, 70 layers deep); the argmax must agree wherever the
top-2 logit gap exceeds 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu.models.reference_import import bg_from_reference
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import bg_state_dict_from_jax
from panoptic_forecasting_tpu_torch.models.hardnet import (
    _interp_matrix,
    resize_bilinear_hw,
)

torch.set_num_threads(2)

H, W, T, C = 64, 128, 3, 11
CFG = {
    "model": {"num_inputs": T, "convert2onehot": True, "use_depth_inps": True},
    "data": {"num_classes": C},
}
DEPTH_STATS = (20.0, 12.0)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_stats(variables, rng):
    """Non-trivial BN running statistics, so folding is exercised."""
    def f(x):
        x = np.asarray(x)
        return x + rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)

    stats = jax.tree_util.tree_map(f, variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: np.abs(x) + 0.5 if p[-1].key == "var" else x, stats
    )
    return {"params": _to_numpy(variables["params"]), "batch_stats": stats}


@pytest.fixture(scope="module")
def bg_case():
    rng = np.random.RandomState(0)
    seg = rng.randint(0, C + 2, size=(2, T, H, W)).astype(np.int32)
    depth = (rng.rand(2, T, H, W) * 40).astype(np.float32)
    depth_mask = rng.rand(2, T, H, W) > 0.2
    inputs = {"seg": seg, "depth": depth, "depth_mask": depth_mask}
    jax_model = JaxBGModel(CFG)
    jax_model.depth_mean, jax_model.depth_std = DEPTH_STATS
    init_batch = {"inputs": {k: jnp.asarray(v[:1]) for k, v in inputs.items()}}
    variables = jax.jit(lambda r: jax_model.init(r, init_batch))(
        jax.random.PRNGKey(1)
    )
    variables = _perturb_stats(variables, rng)
    return jax_model, variables, inputs


def _jax_logits(jax_model, variables, inputs):
    fwd = jax.jit(lambda v, i: jax_model.forward(v, {"inputs": i}))
    out = fwd(variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    return np.asarray(out).transpose(0, 3, 1, 2)  # NHWC -> NCHW


def _check_logits(port_logits, ref):
    assert port_logits.shape == ref.shape
    np.testing.assert_allclose(port_logits, ref, rtol=0, atol=1e-4)
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(
        port_logits.argmax(1)[clear], ref.argmax(1)[clear]
    )


def test_bg_unfolded_matches_jax(bg_case):
    jax_model, variables, inputs = bg_case
    model = BGModel(CFG, depth_stats=DEPTH_STATS, device="cpu")
    model.load_state_dict(bg_state_dict_from_jax(variables, DEPTH_STATS))
    assert not model.folded
    _check_logits(model(inputs).numpy(), _jax_logits(jax_model, variables, inputs))


def test_bg_folded_matches_jax(bg_case):
    """Folded serving graph: the stem runs through onehot_stem_conv (its
    plain version on the CPU). The port's own fold gives the JAX fold's
    weights to f32 rounding (XLA rewrites γ/√(var+ε) with rsqrt)."""
    jax_model, variables, inputs = bg_case
    folded_vars = _to_numpy(jax.jit(jax_model.maybe_fold)(variables))
    model = BGModel(CFG, depth_stats=DEPTH_STATS, device="cpu")
    model.load_state_dict(bg_state_dict_from_jax(variables, DEPTH_STATS))
    folded = model.maybe_fold()
    assert folded.folded and not model.folded
    want = bg_state_dict_from_jax(folded_vars, DEPTH_STATS)
    got = folded.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)
    ref = _jax_logits(jax_model, folded_vars, inputs)
    _check_logits(folded(inputs).numpy(), ref)
    argmax = folded(inputs, return_argmax=True)
    assert argmax.dtype == torch.int32 and argmax.shape == (2, H, W)
    np.testing.assert_array_equal(argmax.numpy(), folded(inputs).argmax(1).numpy())


def test_bg_bridge_round_trips_through_reference_importer(bg_case):
    _, variables, _ = bg_case
    model = BGModel(CFG, depth_stats=DEPTH_STATS, device="cpu")
    model.load_state_dict(bg_state_dict_from_jax(variables, DEPTH_STATS))
    back, stats = bg_from_reference(
        {f"{k}": v for k, v in model.state_dict().items()}
    )
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
    np.testing.assert_array_equal(stats["depth"][0], [DEPTH_STATS[0]])


@pytest.mark.parametrize("size_in,size_out", [((4, 8), (64, 128)), ((16, 32), (17, 9)), ((1, 5), (3, 5))])
def test_resize_matches_interpolate_align_corners(size_in, size_out):
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, *size_in).astype(np.float32))
    ref = F.interpolate(x, size=size_out, mode="bilinear", align_corners=True)
    # the two compute the lerp weights with different f32 roundings:
    # agreement to ~1e-6 of the data's scale
    scale = float(ref.abs().max())
    np.testing.assert_allclose(resize_bilinear_hw(x, size_out).numpy(), ref.numpy(),
                               rtol=0, atol=1e-6 * scale)


def test_interp_matrix_bit_equal_to_jax():
    from panoptic_forecasting_tpu.models.hardnet import _interp_matrix as jax_interp

    for n_in, n_out in ((4, 64), (32, 128), (7, 7), (1, 4)):
        np.testing.assert_array_equal(
            _interp_matrix(n_in, n_out).numpy(),
            np.asarray(jax_interp(n_in, n_out, jnp.float32)),
        )


def test_seeded_init_is_deterministic_and_folds_real_statistics():
    """chip_smoke.py builds its full-width models from a seed: the same
    seed gives the same weights, and the BN statistics are non-trivial so
    the fold changes the convs."""
    from panoptic_forecasting_tpu_torch.models import seeded_init_

    a = seeded_init_(BGModel(CFG, device="cpu"), 3)
    b = seeded_init_(BGModel(CFG, device="cpu"), 3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka
    var = a.model.base[0].norm.running_var
    assert not torch.allclose(var, torch.ones_like(var))
    folded = a.maybe_fold()
    assert not torch.equal(folded.model.base[0].conv.weight,
                           a.model.base[0].conv.weight)


def test_bg_rejects_unported_options():
    """``convert2onehot`` unset, once refused, is ported: the raw ids enter
    as one channel per frame (JAX models/bg.py:136-147), so the stem
    conv takes T channels, and nothing in the bg model layer raises."""
    model = BGModel({"model": {"num_inputs": T}, "data": {"num_classes": C}},
                    device="cpu")
    assert model.model.base[0].conv.in_channels == T
    assert not model.convert2onehot
