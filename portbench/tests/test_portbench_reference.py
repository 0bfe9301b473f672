"""The plain reference against the port's CPU path at a tiny size: the
same state dict layout, and the same forecast and training steps."""

import time

import torch

from portbench.harness import cell
from portbench.reference import fg as ref_fg
from portbench.reference import hardnet as ref_hardnet
from portbench.tests import tiny

CPU = torch.device("cpu")


def test_state_layouts_match_the_port():
    from panoptic_forecasting_tpu_torch.models.bg import BGModel
    from panoptic_forecasting_tpu_torch.models.fg import FGModel

    spec = cell.resolve("forecast_short.scene8")["config"]
    bg = BGModel(spec["bg"], device="cpu").model.state_dict()
    assert {k: tuple(v.shape) for k, v in bg.items()} == ref_hardnet.state_shapes(36, 11)
    fg = FGModel(spec["fg"], device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in fg.items()} == ref_fg.state_shapes(spec["fg"]["model"])


def test_forecast_agrees_on_the_cpu():
    s = tiny.spec("forecast_short.scene8")
    line = cell.execute("forecast_short.scene8", 5, 0.5, False, CPU, time.perf_counter(), spec=s)
    numbers = {r["name"]: r["value"] for r in line["checks"]}
    assert numbers["ids_off"] == 0 and numbers["pan_px"] < 1e-3 and numbers["bg_px"] < 1e-3
    assert numbers["box_px"] < 1e-3 and numbers["depth_rel"] < 1e-5


def test_training_agrees_on_the_cpu():
    """At 128x128, batch 2, HarDNet's deepest BatchNorms see 8 values a
    channel and the later steps' rounding grows; the first step's loss
    and gradient agree to rounding."""
    s = tiny.spec("bg_train.pool8")
    line = cell.execute("bg_train.pool8", 5, 0.5, False, CPU, time.perf_counter(), spec=s)
    numbers = {r["name"]: r["value"] for r in line["checks"]}
    assert numbers["grad_rel"] < 1e-4 and numbers["loss1_rel"] < 1e-5
    assert numbers["change_rel"] < 0.2
