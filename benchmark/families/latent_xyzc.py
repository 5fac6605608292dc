"""Neural Body (latent_xyzc): the shared sequence alone, each frame's posed
geometry, and the work of the SparseConvNet over each frame's grid, the hat
interpolation and the decoder."""
from __future__ import annotations

import numpy as np

from .. import roofline as rl
from ..reference import latent_xyzc as lx
from ..reference.common import sequence_geometry


def write_extra(root, seed, n_frames, config, device):
    """Nothing: the dataset reads the shared sequence alone."""


def geometry(root, frames, config):
    return sequence_geometry(root, frames, config["voxel_size"])


def frame_layers(cell, frame):
    """(conv layers, active voxels of the four scales) of one frame."""
    cache = cell.__dict__.setdefault("_layers", {})
    if frame not in cache:
        geo = cell.geometry()[frame]
        pairs = lx.active_pairs(geo["coords"], geo["shape"])
        layers = rl.conv_layers(lx.ARCH, pairs)
        ends, i = [], 0
        for name, _, n, _, _ in lx.ARCH:
            i += n
            if name in lx.SCALES:
                ends.append(pairs[i - 1][1])
        cache[frame] = (layers, ends)
    return cache[frame]


def points_inside(cell, rec):
    """How many of a training batch's samples lie in the frame's grid (a
    trilinear corner inside)."""
    geo = cell.geometry()[rec["frame"]]
    near, far = rec["near"][0][:, None], rec["far"][0][:, None]
    if "z_frac" in rec:
        z = near + (far - near) * (rec["z_frac"][0].astype(np.float32)
                                   * np.float32(1.0 / 65535.0))
    else:
        z = rec["z_vals"][0]
    pts = (rec["ray_o"][0][:, None] + rec["ray_d"][0][:, None]
           * z[..., None]).reshape(-1, 3)
    dhw = (((pts - geo["Th"]) @ geo["R"])[:, ::-1] - geo["bounds"][0][::-1]
           ) / np.asarray(cell.run.config["voxel_size"])[::-1]
    inside = np.all((dhw > -1) & (dhw < np.asarray(geo["shape"])), axis=1)
    return int(inside.sum())


def decoder_flops(m, backward):
    w = rl.Work()
    rl.mlp(w, rl.LATENT_DECODER, m, backward=backward)
    return w.flops


def train_work(run):
    """Each traced step: one encode forward and backward over its frame's
    grid, the hat kernels over its samples in the grid, the decoder and
    compositing over all its samples."""
    cell = run.traced_info["cell"]
    conv, hat, model = rl.Work(), rl.Work(), rl.Work()
    for rec in run.traced_info["batches"]:
        layers, sites = frame_layers(cell, rec["frame"])
        n_in = points_inside(cell, rec)
        n_all = rec["z_frac" if "z_frac" in rec else "z_vals"][0].size
        rl.conv_forward(conv, layers)
        rl.conv_dx(conv, layers)
        rl.hat_forward(hat, n_in, sites)
        rl.hat_backward(hat, n_in, sites)
        rl.conv_forward(model, layers)
        rl.conv_dx(model, layers)
        rl.conv_dw(model, layers)
        rl.hat_forward(model, n_in, sites)
        rl.hat_backward(model, n_in, sites)
        model.flops += decoder_flops(n_all, True)
        model.flops += 3 * rl.COMPOSITE_FLOPS * n_all
    return {"conv": conv, "hat": hat, "dense": rl.Work(),
            "model_flops": model.flops}


def render_work(run):
    """Each traced image: one encode forward over its frame's grid, the
    interpolation, decoder and compositing over its rays' samples."""
    cell = run.traced_info["cell"]
    cfg = run.config
    conv, dense, model = rl.Work(), rl.Work(), rl.Work()
    for (frame, _), n_rays in run.traced_info["images"]:
        layers, sites = frame_layers(cell, frame)
        m = n_rays * int(cfg["N_samples"])
        rl.conv_forward(conv, layers)
        rl.conv_forward(model, layers)
        rl.hat_forward(model, m, sites)
        model.flops += decoder_flops(m, False)
        model.flops += rl.COMPOSITE_FLOPS * m
    return {"conv": conv, "dense": dense, "model_flops": model.flops}
