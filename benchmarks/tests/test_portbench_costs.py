"""costs.py: the U-Net's operations and bytes from its shapes."""

import pytest

from benchmarks import costs
from benchmarks.reference.unet import layer_shapes, widths

PAPER = {"in_channels": 1, "num_classes": 2, "base_width": 64, "width_mult": 1, "depth": 4}


def test_forward_is_300_86_gflop_per_572_tile():
    f = costs.forward_flops(widths(PAPER), 572)
    assert f == 300_856_848_896
    convs, ups, out = costs.unet_shapes(widths(PAPER), 572)
    assert out == 388 and len(ups) == 4
    assert sum(2 * 9 * ci * co * (s - 2) ** 2 for s, ci, co in convs) == pytest.approx(289.56e9, rel=1e-4)


def test_the_18_conv_shapes_and_the_14_int8_ones():
    convs, _, _ = costs.unet_shapes(widths(PAPER), 572)
    assert len(convs) == 18
    assert convs[0] == (572, 1, 64) and convs[-1] == (390, 64, 64)
    assert convs[8] == (32, 512, 1024) and convs[10] == (56, 1024, 512)
    shapes = layer_shapes(PAPER)
    names = [n for n in shapes if n[:2] in ("en", "bo", "de")]
    assert [shapes[n][0][1] for n in names] == [ci for _, ci, _ in convs]
    assert sum(ci >= 128 for _, ci, _ in convs) == 14


def test_bound_and_conv_cost():
    nbytes, ops = costs.conv_cost(16, 572, 572, 1, 64, 2, 2, 2)
    assert ops == 2 * 16 * 570 * 570 * 9 * 64
    assert nbytes == 16 * 572 * 572 * 2 + 9 * 64 * 2 + 64 * 2 + 16 * 570 * 570 * 64 * 2
    assert costs.bound_s(nbytes, ops, "bf16") == pytest.approx(nbytes / 3.35e12)
    assert costs.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)
