"""The operation and byte counts against hand counts at small shapes."""
import numpy as np
import pytest

from benchmark import roofline as rl
from benchmark.reference import latent_xyzc as lx


def test_conv_counts():
    w = rl.Work()
    rl.conv_forward(w, [(2, 3, 4, 5, 10)])
    assert w.flops == 2 * 10 * 2 * 3
    assert w.bytes == 4 * (4 * 2 + 27 * 2 * 3 + 5 * 3)
    assert w.bound == pytest.approx(max(w.flops / 495e12, w.bytes / 3.35e12))


def test_linear_counts():
    w = rl.Work()
    rl.linear(w, 5, 3, 2)
    assert w.flops == 2 * 5 * 3 * 2
    assert w.bytes == 4 * (15 + 6 + 2 + 10)
    m = rl.Work()
    rl.mlp(m, [(3, 2), (2, 1)], 5, backward=True, first_dx=False)
    # forward 60 + 20, weight gradients 60 + 20, input gradient of layer 2
    assert m.flops == 60 + 20 + 60 + 20 + 20


def test_hat_counts():
    w = rl.Work()
    rl.hat_forward(w, 10, (1, 1, 1, 1))
    assert w.flops == 2 * 8 * 10 * sum(rl.SCALE_CHANNELS)


def test_active_pairs_by_hand():
    # two voxels side by side along w in an 8^3 grid
    coords = np.array([[3, 3, 3], [3, 3, 4]])
    pairs = lx.active_pairs(coords, (8, 8, 8))
    s_in, s_out, taps = pairs[0]
    # each sees itself and the other
    assert (s_in, s_out, taps) == (2, 2, 4)
    # the first strided layer: (3,3,3) and (3,3,4) feed outputs (1|2, 1|2, 1|2)
    # and (1|2, 1|2, 2); 8 outputs, (1,1,2)... hold both
    s_in, s_out, taps = pairs[2]
    assert s_in == 2 and s_out == 8 and taps == 12


def test_nerf_layers_widths():
    layers = rl.nerf_layers()
    assert len(layers) == 12 and layers[5] == (319, 256)
    assert sum(k * n for k, n in layers) == 593408
