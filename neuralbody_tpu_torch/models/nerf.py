"""Vanilla NeRF baseline, coarse + fine (counterpart of
neuralbody_tpu/models/nerf.py): D=8, W=256, skip at layer 4, viewdir head
W/2, separate coarse and fine MLPs. Points are dense rows [N, C]; the
renderer chunks rays.

Every dense layer is one ops/dense_kernel.linear: the hand-written product
with the bias and, in the trunk and the view branch, the ReLU in its
epilogue; its backward is the same kernel twice (dx, dW) after one
elementwise pass that masks the cotangent. The family computes in f32, as
the JAX package's does (on the card the product splits each f32 operand
into two TF32 parts for the tensor cores and sums in f32; the ops module's
note has the error).

The config-driven factories of the JAX file (`@register("network", "nerf")`
and its siblings) come with the port of the config system and the training
harness.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dense_kernel import linear
from ..ops.embedder import embed_dim, positional_encoding
from ..utils.platform import resolve_device, to_device
from .nn_utils import dense_init


class NerfStatic(NamedTuple):
    depth: int = 8
    width: int = 256
    skips: tuple = (4,)
    xyz_res: int = 10
    view_res: int = 4
    use_viewdirs: bool = True


def init_mlp(gen, st: NerfStatic):
    """One MLP's parameters, drawn on the CPU from the torch.Generator."""
    input_ch = embed_dim(st.xyz_res)
    input_ch_views = embed_dim(st.view_res)
    pts_linears = [dense_init(gen, input_ch, st.width)]
    for i in range(st.depth - 1):
        cin = st.width + input_ch if i in st.skips else st.width
        pts_linears.append(dense_init(gen, cin, st.width))
    return {
        "pts_linears": pts_linears,
        "views_linear": dense_init(gen, input_ch_views + st.width,
                                   st.width // 2),
        "feature_linear": dense_init(gen, st.width, st.width),
        "alpha_linear": dense_init(gen, st.width, 1),
        "rgb_linear": dense_init(gen, st.width // 2, 3),
    }


def init(gen, st_coarse: NerfStatic, st_fine: NerfStatic | None = None,
         device=None):
    """(params, {}): the coarse MLP and, with st_fine, the fine one, moved
    to `device` (default: the card; with none present that raises). The
    family has no BatchNorm: the stats dict is empty."""
    params = {"coarse": init_mlp(gen, st_coarse)}
    if st_fine is not None:
        params["fine"] = init_mlp(gen, st_fine)
    return to_device(params, resolve_device(device)), {}


def _dense(layer, x, relu=False):
    return linear(x, layer["w"], layer["b"], relu)


def _trunk(params, input_pts, st: NerfStatic):
    h = input_pts
    for i, layer in enumerate(params["pts_linears"]):
        h = _dense(layer, h, relu=True)
        if i in st.skips:
            h = torch.cat([input_pts, h], dim=-1)
    return h


def apply_density(params, pts, st: NerfStatic):
    """Density-only trunk eval: pts [N, 3] -> alpha [N] (the nerf_mesh
    baseline's forward: pts_linears + alpha head, no viewdir branch)."""
    h = _trunk(params, positional_encoding(pts, st.xyz_res), st)
    return _dense(params["alpha_linear"], h)[:, 0]


def apply_mlp(params, pts, viewdirs, st: NerfStatic):
    """pts [N, 3], viewdirs [N, 3] -> raw [N, 4] (rgb logits + sigma)."""
    input_views = positional_encoding(viewdirs, st.view_res)
    h = _trunk(params, positional_encoding(pts, st.xyz_res), st)
    alpha = _dense(params["alpha_linear"], h)
    feature = _dense(params["feature_linear"], h)
    h = torch.cat([feature, input_views], dim=-1)
    h = _dense(params["views_linear"], h, relu=True)
    rgb = _dense(params["rgb_linear"], h)
    return torch.cat([rgb, alpha], dim=-1)
