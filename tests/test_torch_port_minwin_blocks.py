"""Port parity: the per-block chunk count that K3's CUDA kernel
(panoptic_forecasting_tpu_torch/csrc/minwin.cu) adds up for ``overflow``.

``minwin_block_chunks`` is the kernel's count block by block, in plain
PyTorch. Its clamped sum is held to the JAX package's ``place_minwin``
overflow (run as its own tests run it on the CPU, ``interpret=True``,
sw=1024) on the eight streams of tests/test_torch_port_minwin.py at
three block sizes and on an empty stream, and each block's count to the
(supertile, block) overlap matrix the JAX code builds (minwin.py:266-282).
Tolerance: exact. The C entry points are checked against the sources as
text, so that a renamed entry fails here and not on the GPU.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.kernels.experimental.minwin import (
    place_minwin as jax_place_minwin,
)
from panoptic_forecasting_tpu_torch.kernels import build, placement, strided_load
from panoptic_forecasting_tpu_torch.kernels.experimental import minwin
from panoptic_forecasting_tpu_torch.kernels.experimental.minwin import (
    minwin_block_chunks,
    minwin_overflow,
    place_minwin,
)
from test_torch_port_minwin import CASES, _case

torch.set_num_threads(2)

SW = 1024
BIG = 0x7FFFFFFF


def _overlap_per_block(group, num_groups, block, sw, plane_size, pile_width):
    """Per block, the supertiles its three intervals overlap, counted on
    the dense (supertile, block) matrix as the JAX code builds it."""
    n = group.size
    gp = np.concatenate([group.astype(np.int64),
                         np.full((-n) % block + block, BIG, np.int64)])
    g2 = gp.reshape(-1, block)
    valid = g2 < num_groups
    if plane_size and pile_width:
        local = g2 % plane_size
        top = valid & (local < pile_width)
        bot = valid & (local >= plane_size - pile_width)
    else:
        top = bot = np.zeros_like(valid)
    n_super = -(-num_groups // sw)
    s_lo = np.arange(n_super)[:, None] * sw
    overlap = np.zeros((n_super, g2.shape[0]), bool)
    for m in (valid & ~top & ~bot, top, bot):
        mn = np.where(m, g2, BIG).min(1)
        mx = np.where(m, g2, -1).max(1)
        overlap |= (mn[None] <= s_lo + sw - 1) & (mx[None] >= s_lo)
    return overlap.sum(0)


@pytest.mark.parametrize("block", [512, 1024, 2048])
@pytest.mark.parametrize("name", CASES)
def test_block_chunks_match_jax_overflow(name, block):
    group, key, g, kw = _case(name)
    _, jov = jax_place_minwin(jnp.asarray(group), jnp.asarray(key),
                              num_groups=g, block=block, sw=SW,
                              interpret=True, **kw)
    chunks = minwin_block_chunks(torch.from_numpy(group), num_groups=g,
                                 block=block, sw=SW, **kw)
    nblocks = -(-group.size // block) + 1
    assert chunks.dtype == torch.int64 and chunks.shape == (nblocks,)
    np.testing.assert_array_equal(
        chunks.numpy(), _overlap_per_block(group, g, block, SW,
                                           kw.get("plane_size", 0),
                                           kw.get("pile_width", 0)))
    n_super = -(-g // SW)
    want = max(int(chunks.sum()) - (5 * nblocks + 2 * n_super), 0)
    assert want == int(jov)
    assert int(minwin_overflow(torch.from_numpy(group), num_groups=g,
                               block=block, sw=SW, **kw)) == want


@pytest.mark.parametrize("block", [512, 4096])
def test_block_chunks_empty_stream(block):
    empty = np.zeros(0, np.int32)
    _, jov = jax_place_minwin(jnp.asarray(empty), jnp.asarray(empty),
                              num_groups=300, block=block, sw=SW,
                              interpret=True)
    chunks = minwin_block_chunks(torch.from_numpy(empty), num_groups=300,
                                 block=block, sw=SW)
    assert chunks.tolist() == [0]  # the sentinel block alone, all _BIG
    assert int(jov) == 0
    assert int(minwin_overflow(torch.from_numpy(empty), num_groups=300,
                               block=block, sw=SW)) == 0


def test_cpu_place_minwin_counts_with_the_plain_version(monkeypatch):
    """A CPU tensor takes the plain overflow count and launches nothing."""
    group, key, g, kw = _case("pile_plus_interior")
    calls = []
    plain = minwin.minwin_overflow

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(minwin, "minwin_overflow", counted)
    before = place_minwin.launches
    place_minwin(torch.from_numpy(group), torch.from_numpy(key),
                 num_groups=g, block=512, sw=SW, **kw)
    assert calls == [1] and place_minwin.launches == before


@pytest.mark.parametrize("bad", [dict(plane_size=-4096, pile_width=64),
                                 dict(plane_size=2**31, pile_width=64),
                                 dict(plane_size=4096, pile_width=-1)])
def test_place_minwin_rejects_pile_splits_the_kernel_cannot_hold(bad):
    g = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        place_minwin(g, g, num_groups=8, **bad)


def _c_params(src: str, name: str):
    """The parameter list of ``extern "C" int name(...)`` in ``src``."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"no extern \"C\" int {name}(...)"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,signatures", [
    ("minwin", minwin._SIGNATURES), ("strided_load", strided_load._SIGNATURES),
    ("placement", placement._SIGNATURES),
], ids=["minwin", "strided_load", "placement"])
def test_c_entry_points_match_signatures(source, signatures):
    """Every function the wrapper binds is an extern "C" entry of its
    source, with as many parameters as ctypes passes (the stream last)."""
    src = (build.CSRC / f"{source}.cu").read_text()
    for name, argtypes in signatures.items():
        params = _c_params(src, name)
        assert len(params) == len(argtypes), name
        assert params[-1] == "void* stream", name

