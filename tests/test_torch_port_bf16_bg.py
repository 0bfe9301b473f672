"""Port parity: the bg model with ``model.compute_dtype: bfloat16``.

JAX builds HarDNet with ``dtype=jnp.bfloat16`` (f32 parameters, bf16
activations); the port's ``HarDNet(dtype=torch.bfloat16)`` casts at the
same points. Two bf16 implementations cannot agree to f32 precision, so
the yardstick is JAX's own bf16 error: the relative L2 distance of the
port's bf16 result from JAX's bf16 result must not pass that of JAX's
bf16 result from JAX's f32 one (each test states both numbers in its
assertion message). Class maps must be equal off the pixels where JAX's
bf16 top-2 logit gap is below ``MARGIN``.

The JAX side sets ``packed_stem: false`` (the port does not port the TPU
layouts, and in bf16 their summation order differs from the plain
graph's; ``packed_train`` is off by default). Its bf16 folded route
takes the stem kernel with ``stem_kernel: "interpret"``, as JAX's TPU
serving does (on the CPU ``auto`` would run ``base_0`` in bf16 instead):
K2 computes the stem in f32 and the network casts it to bf16. Inputs
are 64x128, batch 2, made from a numpy seed; the folded test takes the
first sample alone, since the interpreted Pallas stem costs ~17 s there
and ~50 s for the batch of 2 on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import bg_state_dict_from_jax
from panoptic_forecasting_tpu_torch.models.hardnet import ConvLayer
from test_torch_port_bg import _perturb_stats

torch.set_num_threads(2)

H, W, T, C = 64, 128, 3, 11
MODEL = {"num_inputs": T, "convert2onehot": True, "use_depth_inps": True,
         "packed_stem": False, "stem_kernel": "interpret"}
CFG32 = {"model": dict(MODEL, stem_kernel=False), "data": {"num_classes": C}}
CFG16 = {"model": dict(MODEL, compute_dtype="bfloat16"), "data": {"num_classes": C}}
DEPTH_STATS = (20.0, 12.0)
# Class maps may differ where JAX's bf16 top-2 logit gap is below this:
# a few bf16 steps (2^-7 relative) of logits whose magnitude is ~1-4.
MARGIN = 0.05
LR = 0.01


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


def _jax(cfg):
    model = JaxBGModel(cfg)
    model.depth_mean, model.depth_std = DEPTH_STATS
    return model


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    seg = rng.randint(0, C + 2, size=(2, T, H, W)).astype(np.int32)
    depth = (rng.rand(2, T, H, W) * 40).astype(np.float32)
    depth_mask = rng.rand(2, T, H, W) > 0.2
    inputs = {"seg": seg, "depth": depth, "depth_mask": depth_mask}
    j32 = _jax(CFG32)
    init = {"inputs": {k: jnp.asarray(v[:1]) for k, v in inputs.items()}}
    variables = jax.jit(lambda r: j32.init(r, init))(jax.random.PRNGKey(1))
    return {"inputs": inputs, "variables": _perturb_stats(variables, rng),
            "j32": j32, "j16": _jax(CFG16)}


def _port(cfg, variables):
    model = BGModel(cfg, depth_stats=DEPTH_STATS, device="cpu")
    model.load_state_dict(bg_state_dict_from_jax(variables, DEPTH_STATS))
    return model


def _jax_logits(model, variables, inputs):
    fwd = jax.jit(lambda v, i: model.forward(v, {"inputs": i}))
    out = fwd(variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    return np.asarray(out).transpose(0, 3, 1, 2)


def _check(port, j16, j32):
    """The yardstick on logits, then the class maps off near-ties."""
    assert port.dtype == np.float32 and port.shape == j16.shape
    d_port, d_jax = _rel(port, j16), _rel(j16, j32)
    assert d_port <= d_jax, f"port-jax bf16 {d_port} > jax bf16-f32 {d_jax}"
    top2 = np.sort(j16, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(port.argmax(1)[clear], j16.argmax(1)[clear])
    return d_port, d_jax


def test_bf16_runs_bf16_activations_over_f32_parameters(case):
    """The fault's regression guard: ``compute_dtype: bfloat16`` was read
    as a layout key and the model ran in f32."""
    model = _port(CFG16, case["variables"])
    seen = []
    for m in model.modules():
        if isinstance(m, ConvLayer):
            m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    out = model(case["inputs"])
    assert seen and set(seen) == {torch.bfloat16}
    assert out.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for n, b in model.named_buffers()
            if "num_batches" not in n} == {torch.float32}
    f32 = _port(CFG32, case["variables"])(case["inputs"])
    assert (out - f32).abs().max() > 1e-3


def test_bf16_unfolded_matches_jax(case):
    v, inputs = case["variables"], case["inputs"]
    _check(_port(CFG16, v)(inputs).numpy(), _jax_logits(case["j16"], v, inputs),
           _jax_logits(case["j32"], v, inputs))


def test_bf16_folded_matches_jax_with_the_stem_kernel(case):
    """The folded serving route: the port's K2 (plain on the CPU) writes
    bf16; JAX's interpret-mode kernel writes f32 and HarDNet casts it."""
    v = case["variables"]
    inputs = {k: x[:1] for k, x in case["inputs"].items()}
    fv = jax.tree_util.tree_map(np.asarray, jax.jit(case["j32"].maybe_fold)(v))
    folded = _port(CFG16, v).maybe_fold()
    assert folded.folded and folded.model.dtype == torch.bfloat16
    assert {p.dtype for p in folded.parameters()} == {torch.float32}
    port = folded(inputs).numpy()
    _check(port, _jax_logits(case["j16"], fv, inputs),
           _jax_logits(case["j32"], fv, inputs))
    argmax = folded(inputs, return_argmax=True)
    np.testing.assert_array_equal(argmax.numpy(), port.argmax(1))


def test_bf16_train_step_matches_jax(case):
    """Train mode (batch statistics): the loss, one SGD step's parameters
    and the moved BN statistics against JAX's bf16 and f32 steps. The
    loss is computed on f32 logits in both packages."""
    v, inputs = case["variables"], case["inputs"]
    rng = np.random.RandomState(3)
    labels = rng.randint(0, C, (2, H, W)).astype(np.int32)
    labels[:, :5] = 255
    batch = {"inputs": inputs, "labels": {"seg": labels}}
    jb = {k: jnp.asarray(x) if not isinstance(x, dict) else
          {kk: jnp.asarray(xx) for kk, xx in x.items()} for k, x in batch.items()}

    def jax_step(model):
        def loss_fn(p, s):
            loss, _, new_s = model.loss(p, s, jb, train=True)
            return loss, new_s

        (loss, new_s), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v["params"], {"batch_stats": v["batch_stats"]})
        params = jax.tree_util.tree_map(lambda p, d: p - LR * d, v["params"], g)
        after = {"params": params, "batch_stats": new_s["batch_stats"]}
        sd = bg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, after),
                                    DEPTH_STATS)
        return float(loss), sd

    l16, s16 = jax_step(case["j16"])
    l32, s32 = jax_step(case["j32"])

    model = _port(CFG16, v).train()
    loss, _ = model.loss(batch)
    loss.backward()
    assert loss.dtype == torch.float32
    with torch.no_grad():
        for p in model.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
            p -= LR * p.grad
    got = model.state_dict()

    d_port, d_jax = abs(float(loss.detach()) - l16), abs(l16 - l32)
    assert d_port <= d_jax, f"loss: port-jax bf16 {d_port} > jax bf16-f32 {d_jax}"

    def stacked(sd, keys):
        return np.concatenate([sd[k].numpy().ravel() for k in keys])

    params = [n for n, _ in model.named_parameters()]
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    for what, keys in (("parameters", params), ("BN statistics", stats)):
        before = stacked(_port(CFG32, v).state_dict(), keys)
        a, b, c = (stacked(sd, keys) - before for sd in (got, s16, s32))
        d_port, d_jax = _rel(a, b), _rel(b, c)
        assert d_port <= d_jax, f"{what}: port-jax bf16 {d_port} > jax {d_jax}"
