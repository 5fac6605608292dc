"""The yardstick of the kernels and of the whole step: the card's peaks, and
the operations and bytes the inputs need.

Counts are of the work the inputs need, whatever implementation does it:
active voxels and their active neighbour taps (not a kernel's site
capacities or padding), the samples of real rays (not padded rays), each
input byte read once and each output byte written once. float32 work is
counted once, against the TF32 tensor-core peak: no f32-accurate route on
this card runs faster than that, so a share cannot pass 100%.
"""
from __future__ import annotations

# one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates at 700 W)
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# kernels of the program, matched by name in a device trace
KERNELS = {
    "conv": ("sparse_conv_mma_kernel",),
    "hat": ("hat_interp_kernel", "hat_interp_bwd_kernel",
            "hat_row_sum_kernel"),
    "dense": ("dense_mm_tf32_kernel", "dense_mm_kernel",
              "dense_narrow_rows_kernel", "dense_narrow_cols_kernel",
              "sum_splits_kernel"),
}


def bound_s(flops, nbytes, dtype="float32"):
    """The least time the work can take on the card."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


class Work:
    """A tally of (flops, bytes, least seconds) of one kind of work."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.bound = 0.0

    def add(self, flops, nbytes, times=1, dtype="float32"):
        self.flops += flops * times
        self.bytes += nbytes * times
        self.bound += bound_s(flops, nbytes, dtype) * times


# -- the SparseConvNet ----------

def conv_layers(arch, pairs):
    """(cin, cout, active inputs, active outputs, active pairs) of each
    convolution of the encoder, from the reference's ARCH and active_pairs
    (one frame)."""
    out, i = [], 0
    for _, _, n, cin, cout in arch:
        for _ in range(n):
            s_in, s_out, taps = pairs[i]
            out.append((cin, cout, s_in, s_out, taps))
            cin = cout
            i += 1
    return out


def conv_forward(work, layers, times=1):
    """The convolutions of one encode: 2 operations a multiply-add over
    every active (output, tap) pair; the input features, the weights and
    the output features, 4 bytes each."""
    for cin, cout, s_in, s_out, taps in layers:
        work.add(2.0 * taps * cin * cout,
                 4.0 * (s_in * cin + 27 * cin * cout + s_out * cout), times)


def conv_dx(work, layers, times=1):
    """The input gradients of one encode's convolutions: the same pairs,
    the output gradient and the weights in, the input gradient out."""
    for cin, cout, s_in, s_out, taps in layers:
        work.add(2.0 * taps * cin * cout,
                 4.0 * (s_out * cout + 27 * cin * cout + s_in * cin), times)


def conv_dw(work, layers, times=1):
    """The weight gradients of one encode's convolutions."""
    for cin, cout, s_in, s_out, taps in layers:
        work.add(2.0 * taps * cin * cout,
                 4.0 * (s_in * cin + s_out * cout + 27 * cin * cout), times)


# -- interpolation ----------

SCALE_CHANNELS = (32, 64, 128, 128)


def hat_forward(work, n_points, site_counts, times=1):
    """Trilinear interpolation of n_points points from each scale's active
    voxels: 8 corners x channels multiply-adds a point; the scale's
    features and the points' coordinates in, the interpolated features
    out."""
    for c, s in zip(SCALE_CHANNELS, site_counts):
        work.add(2.0 * 8 * n_points * c,
                 4.0 * (s * c + 3 * n_points + n_points * c), times)


def hat_backward(work, n_points, site_counts, times=1):
    """Its gradient: the points' feature gradients and coordinates in, the
    scales' feature gradients out."""
    for c, s in zip(SCALE_CHANNELS, site_counts):
        work.add(2.0 * 8 * n_points * c,
                 4.0 * (n_points * c + 3 * n_points + s * c), times)


# -- dense layers ----------

def linear(work, m, k, n, times=1):
    """One dense layer over m rows: [m, k] x [k, n] + bias."""
    work.add(2.0 * m * k * n, 4.0 * (m * k + k * n + n + m * n), times)


def linear_dx(work, m, k, n, times=1):
    work.add(2.0 * m * k * n, 4.0 * (m * n + k * n + m * k), times)


def linear_dw(work, m, k, n, times=1):
    work.add(2.0 * m * k * n, 4.0 * (m * k + m * n + k * n + n), times)


LATENT_DECODER = ((352, 256), (256, 256), (256, 256), (256, 1), (256, 256),
                  (384, 256), (346, 128), (128, 3))


def nerf_layers(width=256, cx=63, cv=27):
    return ([(cx, width)] + [(width, width)] * 4 + [(width + cx, width)]
            + [(width, width)] * 2
            + [(width, 1), (width, width), (width + cv, width // 2),
               (width // 2, 3)])


def mlp(work, layers, m, backward=False, first_dx=True):
    """Forward (and with backward, the input and weight gradients) of an
    MLP's layers over m rows; first_dx: whether the first layer's input
    needs its gradient."""
    for i, (k, n) in enumerate(layers):
        linear(work, m, k, n)
        if backward:
            linear_dw(work, m, k, n)
            if i or first_dx:
                linear_dx(work, m, k, n)


# a ray sample's share of the quadrature: the interval, the opacity, the
# transmittance and the weighted colour (forward)
COMPOSITE_FLOPS = 20.0
