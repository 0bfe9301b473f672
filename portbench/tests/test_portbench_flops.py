"""The operation and byte counts against hand counts."""

import json
import os

import torch

from portbench.harness import cell, flops
from portbench.reference.hardnet import block_spec


def test_counter_small_net():
    c = flops.Counter()
    meta = torch.device("meta")
    x = c.conv(torch.empty((2, 3, 8, 8), device=meta), torch.empty((4, 3, 3, 3), device=meta),
               None, 2, 1)
    assert c.flops == 2 * (2 * 4 * 4 * 4) * 3 * 9 and c.first_conv == c.flops
    c.linear(torch.empty((5, 7), device=meta), torch.empty((6, 7), device=meta))
    c.deconv(x, torch.empty((4, 2, 2, 2), device=meta), None, 2)
    assert c.flops == 2 * 128 * 27 + 2 * 5 * 6 * 7 + 2 * (2 * 4 * 4 * 4) * 2 * 4


def test_fchardnet70_forward_matches_published():
    """FC-HarDNet-70 on an RGB 1024x2048 image: 35.4 GMACs published (Chao
    et al. 2019, Table 6); the count leaves out the bilinear resizes."""
    gmac = flops.hardnet_forward(1, 3, 19, 1024, 2048).flops / 2e9
    assert abs(gmac - 35.4) / 35.4 < 0.01


def test_hardnet_by_hand():
    """The stem's first conv and a HarDBlock's links by hand."""
    c = flops.hardnet_forward(1, 36, 11, 64, 128)
    assert c.first_conv == 2 * (16 * 32 * 64) * 36 * 9
    layers, out = block_spec(4, 48, 10)
    assert [(oc, ic) for oc, ic, _ in layers] == [(10, 48), (18, 58), (10, 18), (28, 76)]
    assert out == 10 + 10 + 28


def test_train_step_counts_backward_twice():
    cfg = json.load(open(os.path.join(cell.ROOT, "portbench/configs/bg_train.json")))
    cfg["data"]["crop_size"] = 64
    c = flops.hardnet_forward(2, 36, 11, 64, 64, train=True)
    assert flops.train_step(cfg, 2) == 3 * c.flops - c.first_conv


def test_kernel_bytes():
    assert flops.k1_bytes(3, 1024, 2048) == 3 * 1024 * 2048 * 12
    assert flops.k2_bytes(3, 1024, 2048, 16) == 3 * 2 ** 21 * 8 + 512 * 1024 * 64
    taps = 3 * (3 * 512 - 1) * (3 * 1024 - 1)
    assert flops.k2_flops(3, 1024, 2048, 16) == 48 * taps + 32 * 512 * 1024
