"""Port parity: K2, the fused one-hot stem conv, against the JAX package.

The JAX side runs its plain reference (``stem_reference``) and the Pallas
kernel in interpret mode; the port runs its plain version, which is what
``onehot_stem_conv`` takes for CPU tensors. Tolerance 1e-5 max abs: both
sum the same f32 terms in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoptic_forecasting_tpu.kernels.stem import (
    onehot_stem_conv as jax_stem,
    stem_reference,
)
from panoptic_forecasting_tpu_torch.kernels.stem import (
    onehot_stem_conv,
    onehot_stem_conv_plain,
)

torch.set_num_threads(2)


def _case(rng, b, t, h, w, c, c_out, with_depth=True):
    # ids >= C and < 0 one-hot to all-zero rows
    seg = rng.randint(-2, c + 3, (b, t, h, w)).astype(np.int32)
    depth = rng.randn(b, t, h, w).astype(np.float32) if with_depth else None
    c_in = t * c + (t if with_depth else 0)
    kern = rng.randn(3, 3, c_in, c_out).astype(np.float32) * 0.2
    bias = rng.randn(c_out).astype(np.float32)
    return seg, depth, kern, bias


def _torch(*xs):
    return [torch.from_numpy(x) if x is not None else None for x in xs]


@pytest.mark.parametrize(
    "b,t,h,w,c,c_out,with_depth",
    [
        (1, 3, 32, 64, 11, 16, True),  # the serving shape family
        (2, 3, 16, 32, 11, 16, True),  # batched
        (1, 2, 16, 48, 5, 8, True),    # other class/frame/channel counts
        (1, 3, 16, 32, 11, 16, False),  # no depth inputs
    ],
)
def test_stem_plain_matches_jax_reference(b, t, h, w, c, c_out, with_depth):
    rng = np.random.RandomState(b * 100 + h + c)
    seg, depth, kern, bias = _case(rng, b, t, h, w, c, c_out, with_depth)
    ref = np.asarray(stem_reference(
        jnp.asarray(seg), None if depth is None else jnp.asarray(depth),
        jnp.asarray(kern), jnp.asarray(bias), num_classes=c,
    ))
    out = onehot_stem_conv(*_torch(seg, depth, kern, bias), num_classes=c)
    assert out.shape == (b, h // 2, w // 2, c_out)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_stem_plain_matches_pallas_interpret():
    rng = np.random.RandomState(5)
    seg, depth, kern, bias = _case(rng, 1, 3, 16, 32, 11, 16)
    pallas = np.asarray(jax_stem(
        jnp.asarray(seg), jnp.asarray(depth), jnp.asarray(kern),
        jnp.asarray(bias), num_classes=11, interpret=True,
    ))
    out = onehot_stem_conv_plain(*_torch(seg, depth, kern, bias), num_classes=11)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=0, atol=1e-5)


def test_stem_rejects_bad_shapes():
    rng = np.random.RandomState(0)
    seg, depth, kern, bias = _torch(*_case(rng, 1, 3, 16, 32, 11, 16))
    with pytest.raises(ValueError, match="even"):
        onehot_stem_conv(seg[..., :15, :], depth[..., :15, :], kern, bias,
                         num_classes=11)
    with pytest.raises(ValueError, match="kernel"):
        onehot_stem_conv(seg, depth, kern, bias, num_classes=10)


@pytest.mark.parametrize("t,c_max", [(1, 362), (2, 173), (3, 110)])
def test_stem_shared_memory_limit(t, c_max):
    """The CUDA wrapper's class-count limit: the largest C whose shared
    memory fits 227 KB, and 50.3 kB at the serving T = 3, C = 11."""
    from panoptic_forecasting_tpu_torch.kernels.stem import _SMEM_LIMIT, smem_bytes

    assert smem_bytes(3, 11) == 50288
    assert smem_bytes(t, c_max) <= _SMEM_LIMIT < smem_bytes(t, c_max + 1)


def test_prof_stem_ablations_find_their_anchors():
    """scripts/prof_stem.py cuts parts of csrc/stem.cu by textual edits;
    each anchor must stay in the source exactly once."""
    from panoptic_forecasting_tpu_torch.kernels import build
    from panoptic_forecasting_tpu_torch.scripts.prof_stem import ABLATIONS

    src = (build.CSRC / "stem.cu").read_text()
    for name, edits in ABLATIONS.items():
        for anchor, repl in edits.items():
            assert src.count(anchor) == 1, name
            assert anchor != repl
