"""The harness's tests run on the CPU at the sizes of ``tiny.py``. A test
that needs the card is marked ``card`` and skips, in a fixture, where
there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from panoptic_forecasting_tpu_torch.cli.common import config_device
    return config_device({})
