"""Port parity: the K4 strided-load probes (panoptic_forecasting_tpu_torch.
kernels.strided_load) against the Pallas probe bodies of
scripts/prof_strided_load.py.

That script runs its probes when it is imported, so the three bodies are
copied here verbatim and run with ``interpret=True`` on the CPU. Each is
held bit for bit against the port's plain version, its CPU wrapper, and
the port's entry point.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from panoptic_forecasting_tpu_torch.kernels.strided_load import (
    PROBES,
    dyn_row_strided,
    strided_plain,
    strided_ref,
    strided_val,
)
from panoptic_forecasting_tpu_torch.scripts import prof_strided_load


# ---- scripts/prof_strided_load.py:19-37 ------------------------------------
def k_strided_ref(x_ref, o_ref):
    # even lanes of each row, read straight from the ref
    o_ref[...] = x_ref[:, 0 : 2048 : 2]


def k_strided_val(x_ref, o_ref):
    v = x_ref[...]
    o_ref[...] = v[:, 0 : 2048 : 2]


def k_dyn_row_strided(x_ref, o_ref):
    # strided load combined with a dynamic sublane index (the stem
    # kernel's access pattern)
    def body(i, c):
        row = x_ref[pl.ds(i, 1), 1 : 2048 : 2]
        o_ref[pl.ds(i, 1), :] = row
        return c

    jax.lax.fori_loop(0, 8, body, 0)
# -----------------------------------------------------------------------------


JAX_PROBES = {"strided_ref": (k_strided_ref, 0, strided_ref),
              "strided_val": (k_strided_val, 0, strided_val),
              "dyn_row_strided": (k_dyn_row_strided, 1, dyn_row_strided)}


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_pallas_interpret(name):
    body, start, port = JAX_PROBES[name]
    x = np.arange(8 * 2048, dtype=np.float32).reshape(8, 2048)
    x[3] = np.random.RandomState(0).randn(2048)  # not only integers
    want = np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((8, 1024), jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    for out in (strided_plain(xt, start), port(xt, start)):
        assert out.shape == (8, 1024) and out.dtype == torch.float32
        assert out.is_contiguous()
        np.testing.assert_array_equal(out.numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("name", PROBES)
@pytest.mark.parametrize("start", [0, 1])
def test_probe_plain_on_other_shapes(name, start):
    """The port's probes take any (R, C) with C even and either lane
    offset; CPU tensors, non-contiguous views included, give numpy's
    slice."""
    port = JAX_PROBES[name][2]
    x = np.random.RandomState(1).randn(64, 4096).astype(np.float32)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).t().contiguous().t()):
        np.testing.assert_array_equal(port(xt, start).numpy(), x[:, start::2])
    assert port.launches == 0  # CPU tensors never launch the kernel


def test_probes_reject_bad_inputs():
    for port in (strided_ref, strided_val, dyn_row_strided):
        with pytest.raises(TypeError):
            port(torch.zeros(2, 4, dtype=torch.float64), 0)
        with pytest.raises(ValueError):
            port(torch.zeros(2, 5), 0)
        with pytest.raises(ValueError):
            port(torch.zeros(2, 4), 2)


def test_entry_point_cpu(capsys):
    assert prof_strided_load.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{name} OK" for name in PROBES] + ["DONE"]


def test_entry_point_cpu_at_other_shapes(capsys):
    """--rows/--cols: the probes at C % 8 == 4 (strided_ref's scalar path
    on the card); the byte bound of the (8192, 8192) probe, 402.7 MB at
    3.35 TB/s."""
    assert prof_strided_load.main(["--device", "cpu", "--rows", "6",
                                   "--cols", "1020"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{name} OK" for name in PROBES] + ["DONE"]
    assert prof_strided_load.bound_ms(*prof_strided_load.LARGE) == pytest.approx(
        8192 * 8192 * 6 / 3.35e12 * 1e3)
    assert round(prof_strided_load.bound_ms(*prof_strided_load.LARGE), 4) == 0.1202
