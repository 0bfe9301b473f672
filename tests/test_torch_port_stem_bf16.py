"""K2's bf16 output route (``onehot_stem_conv(..., out_dtype=bf16)``),
taken when HarDNet runs in bf16.

On the CPU the wrapper's bf16 route is ``onehot_stem_conv_plain(...)``
rounded to bf16, bit for bit, and within one bf16 step (beyond the f32
stems' 1e-5) of JAX's f32 stem cast to bf16 (the cast JAX's network makes of its kernel's f32
output); any other output dtype raises. The CUDA kernel cannot run here:
its C entry points are checked as text against the ctypes signatures the
wrapper binds (``chip_smoke.py`` holds the bf16 kernel on the card to the
f32 kernel's output cast to bf16, bit for bit).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.kernels.stem import stem_reference
from panoptic_forecasting_tpu_torch.kernels import build, stem
from panoptic_forecasting_tpu_torch.kernels.stem import (
    onehot_stem_conv,
    onehot_stem_conv_plain,
)
from test_torch_port_stem import _case, _torch

torch.set_num_threads(2)


@pytest.mark.parametrize("b,t,h,w,c,c_out,with_depth", [
    (1, 3, 32, 64, 11, 16, True),
    (2, 3, 16, 32, 11, 16, True),
    (1, 3, 16, 32, 11, 16, False),
])
def test_stem_bf16_route_is_the_plain_stem_rounded(b, t, h, w, c, c_out, with_depth):
    rng = np.random.RandomState(b * 10 + h + int(with_depth))
    case = _case(rng, b, t, h, w, c, c_out, with_depth)
    args = _torch(*case)
    out = onehot_stem_conv(*args, num_classes=c, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h // 2, w // 2, c_out)
    want = onehot_stem_conv_plain(*args, num_classes=c).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    seg, depth, kern, bias = case
    ref = np.asarray(stem_reference(
        jnp.asarray(seg), None if depth is None else jnp.asarray(depth),
        jnp.asarray(kern), jnp.asarray(bias), num_classes=c,
    ).astype(jnp.bfloat16).astype(jnp.float32))
    got = out.to(torch.float32).numpy()
    # one bf16 step, beyond the f32 stems' own 1e-5 (tests/test_torch_port_stem.py)
    step = np.maximum(np.abs(ref), np.abs(got)) * 2.0 ** -7 + 1e-5
    assert np.all(np.abs(got - ref) <= step)
    assert (got == ref).mean() > 0.99


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_stem_refuses_other_output_dtypes(dtype):
    args = _torch(*_case(np.random.RandomState(0), 1, 3, 16, 32, 11, 16))
    with pytest.raises(TypeError, match="out_dtype"):
        onehot_stem_conv(*args, num_classes=11, out_dtype=dtype)


def test_stem_c_entry_points_match_signatures():
    """Each output dtype's entry is an extern "C" function of
    ``csrc/stem.cu`` with the parameters the wrapper passes (the stream
    last), and the bf16 one writes ``__nv_bfloat16``."""
    src = (build.CSRC / "stem.cu").read_text()
    assert set(stem._ENTRIES) == {torch.float32, torch.bfloat16}
    for name in stem._ENTRIES.values():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(stem._SIGNATURES[name]), name
        assert params[-1] == "void* stream", name
    body = src[src.index('extern "C" int onehot_stem_conv_bf16'):]
    assert "launch_stem<__nv_bfloat16>" in body
