"""The NeRF baseline: the shared sequence alone, each frame's posed
geometry (the box its rays meet), and the work of the coarse and fine
MLPs."""
from __future__ import annotations

from .. import roofline as rl
from ..reference.common import sequence_geometry


def write_extra(root, seed, n_frames, config, device):
    """Nothing: the dataset reads the shared sequence alone."""


def geometry(root, frames, config):
    return sequence_geometry(root, frames, config["voxel_size"])


def train_work(run):
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


def render_work(run):
    """Each traced image: the coarse and fine MLPs and compositing over its
    real rays' samples."""
    cfg = run.config
    conv, dense, model = rl.Work(), rl.Work(), rl.Work()
    for _, n_rays in run.traced_info["images"]:
        for m in (n_rays * int(cfg["N_samples"]),
                  n_rays * (int(cfg["N_samples"])
                            + int(cfg["N_importance"]))):
            rl.mlp(dense, rl.nerf_layers(), m)
            rl.mlp(model, rl.nerf_layers(), m)
            model.flops += rl.COMPOSITE_FLOPS * m
    return {"conv": conv, "dense": dense, "model_flops": model.flops}
