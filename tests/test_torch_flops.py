"""etmppo_tpu_torch's FLOP accounting against the JAX package's: the same
analytic window-attention count and MFU formula (exact), the counter's FLOPs
of a Linear and a Conv2d (exact: 2 FLOPs per multiply-add, the bias not
counted, as XLA counts a dot), and the peak of the H100 the port runs on.
"""
import math

import pytest
import torch

from etmppo_tpu.utils import flops as jax_flops
from etmppo_tpu_torch.utils import flops


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B, L, D", [(1024, 64, 384), (2048, 118, 384),
                                     (3, 5, 7)])
def test_window_attention_flops_match_jax(B, L, D, backward):
    got = flops.window_attention_flops(B, L, D, backward=backward)
    assert got == jax_flops.window_attention_flops(B, L, D, backward=backward)
    assert got == (8 if backward else 4) * B * L * D


@pytest.mark.parametrize("f, s, peak", [(1e12, 1.0, 2e12), (0.0, 1.0, 1e12),
                                        (3.5e9, 0.0, 1e11)])
def test_mfu_matches_jax(f, s, peak):
    assert flops.mfu(f, s, peak) == jax_flops.mfu(f, s, peak)


def test_counted_flops_of_a_linear():
    layer = torch.nn.Linear(256, 64)
    x = torch.zeros(128, 256)
    assert flops.counted_flops(layer, x) == 2 * 128 * 256 * 64


def test_counted_flops_of_a_conv2d():
    """The flagship's first convolution: 32 filters of 8x8x3, stride 4, on
    a batch of two 84x84 images (20x20 outputs)."""
    conv = torch.nn.Conv2d(3, 32, 8, stride=4)
    x = torch.zeros(2, 3, 84, 84)
    assert flops.counted_flops(conv, x) == 2 * (2 * 20 * 20 * 32) * (3 * 8 * 8)


def test_counted_flops_include_a_backward():
    layer = torch.nn.Linear(16, 8)
    x = torch.zeros(4, 16, requires_grad=True)
    # forward 2*4*16*8; backward: the input's and the weight's gradients
    assert flops.counted_flops(lambda: layer(x).sum().backward()) == \
        3 * 2 * 4 * 16 * 8


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA A100-SXM4-80GB", 989.4e12)])
def test_peak_of_the_card(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    assert flops.device_peak_flops() == peak
    assert math.isclose(flops.mfu(peak / 2, 1.0), 0.5)


def test_peak_of_the_cpu_and_no_gpu(monkeypatch):
    assert flops.device_peak_flops("cpu") == jax_flops.PEAK_FLOPS["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flops.device_peak_flops()
