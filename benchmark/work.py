"""The work of a run's traced stretch, counted from the cell's inputs with
the yardstick in roofline.py: per kernel family the operations, bytes and
least time, and the model's operations (forward and backward where the
stretch trains; recomputation and padding left out)."""
from __future__ import annotations

import numpy as np

from . import roofline as rl
from .reference import latent_xyzc as lx


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


def train(run):
    """{"conv", "hat", "dense", "model_flops"} of the traced training
    steps."""
    if run.config["reference"] == "nerf":
        return train_nerf(run)
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


def train_nerf(run):
    """The NeRF baseline's steps: the coarse MLP over R x N_samples points
    and the fine one over R x (N_samples + N_importance), forward and
    backward (the first layer's input, the embedding, needs no
    gradient)."""
    cfg = run.config
    dense, model = rl.Work(), rl.Work()
    for rec in run.traced_info["batches"]:
        R = int(rec["ray_mask"].sum()) if "ray_mask" in rec else \
            rec["ray_o"][0].shape[0]
        for m in (R * int(cfg["N_samples"]),
                  R * (int(cfg["N_samples"]) + int(cfg["N_importance"]))):
            for w in (dense, model):
                rl.mlp(w, rl.nerf_layers(), m, backward=True,
                       first_dx=False)
            model.flops += 3 * rl.COMPOSITE_FLOPS * m
    return {"conv": rl.Work(), "hat": rl.Work(), "dense": dense,
            "model_flops": model.flops}


def render(run):
    """{"conv", "dense", "model_flops"} of the traced images."""
    cell = run.traced_info["cell"]
    cfg = run.config
    conv, dense, model = rl.Work(), rl.Work(), rl.Work()
    for (frame, _), n_rays in run.traced_info["images"]:
        if cfg["reference"] == "latent_xyzc":
            layers, sites = frame_layers(cell, frame)
            m = n_rays * int(cfg["N_samples"])
            rl.conv_forward(conv, layers)
            rl.conv_forward(model, layers)
            rl.hat_forward(model, m, sites)
            model.flops += decoder_flops(m, False)
            model.flops += rl.COMPOSITE_FLOPS * m
        else:
            for m in (n_rays * int(cfg["N_samples"]),
                      n_rays * (int(cfg["N_samples"])
                                + int(cfg["N_importance"]))):
                rl.mlp(dense, rl.nerf_layers(), m)
                rl.mlp(model, rl.nerf_layers(), m)
                model.flops += rl.COMPOSITE_FLOPS * m
    return {"conv": conv, "dense": dense, "model_flops": model.flops}


def share(run, work, family):
    """100 x the least time of a kernel family's work over its kernels'
    device time in the trace; None where none of them ran."""
    secs, n = run.traced.kernel_s(rl.KERNELS[family])
    if n == 0 or work.bound == 0:
        return None
    return 100.0 * work.bound / secs


def mfu(run, flops):
    """100 x the model's operations over the traced window at the peak;
    None where the window traced no step or image."""
    if flops <= 0 or run.traced.window_s <= 0:
        return None
    return 100.0 * flops / (run.traced.window_s * rl.PEAK_FLOPS["float32"])
