"""Trilinear volume sampling (counterpart of
neuralbody_tpu/ops/grid_sample.py), written out as eight corner gathers.

The semantics are F.grid_sample(volume, grid, padding_mode='zeros',
align_corners=True): grid coordinate -1 maps to voxel 0 and +1 to voxel
(size-1); corners outside the volume contribute zero. Volumes are stored
channels-last [D, H, W, C], and coordinates are xyz in [-1, 1] with x
indexing W, y -> H, z -> D.

Differentiable by autograd: to the volume through the gathers and to the
coordinates through the trilinear weights.
"""
import torch


def _axis_corners(f, size):
    """The two cells around the continuous index f along one axis of `size`
    cells: [(index clipped into the axis, weight zeroed outside it)] for
    floor(f) and floor(f) + 1. The floor is clipped in float before the
    cast, to [-2, size], where both cells stay outside the axis: the cast
    of a far-off float is undefined."""
    f0 = torch.floor(f)
    t = f - f0
    i0 = f0.clamp(-2.0, float(size)).long()
    out = []
    for i, w in ((i0, 1.0 - t), (i0 + 1, t)):
        valid = (i >= 0) & (i < size)
        # clipped before any lookup: torch raises or faults on an
        # out-of-range index
        out.append((i.clamp(0, size - 1), w * valid))
    return out


def trilinear_corners(fz, fy, fx, sizes):
    """The eight corners of a zero-padded trilinear sample of a [D, H, W]
    grid at continuous indices (fz, fy, fx), each [N]: yields (linear cell
    index [N], always in range; weight [N], zero for a corner outside the
    grid)."""
    D, H, W = sizes
    zs, ys, xs = (_axis_corners(f, n) for f, n in ((fz, D), (fy, H), (fx, W)))
    for iz, wz in zs:
        for iy, wy in ys:
            row = (iz * H + iy) * W
            wzy = wz * wy
            for ix, wx in xs:
                yield row + ix, wzy * wx


def grid_sample_3d(volume, coords, padding_mode="zeros"):
    """Sample a volume at continuous normalized coordinates.

    Args:
      volume: [D, H, W, C] feature volume.
      coords: [N, 3] xyz coordinates in [-1, 1].
      padding_mode: 'zeros' (out-of-range corners contribute 0) or 'border'
        (coords clamped to the edge).

    Returns [N, C] trilinearly interpolated features.
    """
    D, H, W, C = volume.shape
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]

    # align_corners=True unnormalization
    fx = (x + 1.0) * 0.5 * (W - 1)
    fy = (y + 1.0) * 0.5 * (H - 1)
    fz = (z + 1.0) * 0.5 * (D - 1)

    if padding_mode == "border":
        fx = fx.clamp(0.0, W - 1)
        fy = fy.clamp(0.0, H - 1)
        fz = fz.clamp(0.0, D - 1)

    flat = volume.reshape(D * H * W, C)
    out = 0.0
    for lin, w in trilinear_corners(fz, fy, fx, (D, H, W)):
        out = out + flat[lin] * w[:, None]
    return out


def multiscale_grid_sample(volumes, coords):
    """Samples of several feature volumes at shared coords (normalized by
    the full-resolution grid), concatenated along the channels."""
    return torch.cat([grid_sample_3d(v, coords) for v in volumes], dim=-1)
