"""T-pose Neural Body variant, the TPAMI extension (counterpart of
neuralbody_tpu/models/tpose_xyzc.py).

Vertex codes are voxelized in T-POSE space and diffused there by the
SparseConvNet (the conv kernel, csrc/sparse_conv.cu, runs every conv);
features reach posed ray samples through a double grid sample: each T-pose
volume is first sampled at a dense posed grid's T-pose coordinates (a
warped feature volume in pose space), which is then sampled at the ray
points' posed coordinates. The encoder topology and the MLP heads are
latent_xyzc's. The family computes in f32 whatever cfg.tpu.compute_dtype
says, as the JAX package does: its encoder static takes no compute dtype
and its decode passes none to dense.

The config-driven factories are registered as "model_static" and
"network" under "tpose_xyzc".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import register
from ..ops.embedder import positional_encoding
from ..ops.grid_sample import grid_sample_3d
from ..ops.sparse_conv import scatter_vertex_codes
from ..utils.platform import resolve_device, to_device
from . import sparse_conv_net
from .latent_xyzc import FEATURE_DIM
from .nn_utils import dense, dense_init, embedding_init


class TposeStatic(NamedTuple):
    encoder: sparse_conv_net.EncoderStatic   # T-pose grid (xyz order)
    ptot_shape: tuple                        # warped posed grid (X, Y, Z)
    xyz_res: int = 10
    view_res: int = 4


def init(gen: torch.Generator, num_train_frame: int, nv: int = 6890,
         code_dim: int = 16, latent_dim: int = 128, xyz_res: int = 10,
         view_res: int = 4, device=None):
    """(params, bn_stats) with the JAX tree's leaves (names and shapes),
    drawn on the CPU from the torch.Generator `gen`, then moved to
    `device` (default: the card)."""
    xyz_dim = 3 * (1 + 2 * xyz_res)
    view_dim = 3 * (1 + 2 * view_res)
    enc_params, enc_stats = sparse_conv_net.init(gen)
    params = {
        "vertex_code": embedding_init(gen, nv, code_dim),
        "frame_latent": embedding_init(gen, num_train_frame, latent_dim),
        "xyzc_net": enc_params,
        "fc_0": dense_init(gen, FEATURE_DIM, 256),
        "fc_1": dense_init(gen, 256, 256),
        "fc_2": dense_init(gen, 256, 256),
        "alpha_fc": dense_init(gen, 256, 1),
        "feature_fc": dense_init(gen, 256, 256),
        "latent_fc": dense_init(gen, 256 + latent_dim, 256),
        "view_fc": dense_init(gen, 256 + view_dim + xyz_dim, 128),
        "rgb_fc": dense_init(gen, 128, 3),
    }
    device = resolve_device(device)
    return (to_device(params, device),
            to_device({"xyzc_net": enc_stats}, device))


def encode_tpose_voxels(params, geom, static: TposeStatic):
    """T-pose vertex codes -> the 4 multi-scale T-pose volumes
    [B, X_l, Y_l, Z_l, C_l] (xyz order) and the BN batch statistics."""
    cap0 = static.encoder.site_caps[0]
    codes = scatter_vertex_codes(params["vertex_code"], geom["vert_idx"],
                                 cap0)
    return sparse_conv_net.apply(params["xyzc_net"], codes, geom,
                                 static.encoder)


def warp_volumes(volumes, tgrid_coords, ptot_shape):
    """The warped (posed-space) volumes: each T-pose volume sampled at the
    posed grid's T-pose coordinates (the first grid sample, ref
    tpose_xyzc.py:91-98).

    volumes: list of [D, H, W, C] (one frame's T-pose volumes);
    tgrid_coords: [X*Y*Z, 3] zyx-order normalized coordinates. Returns a
    list of [X, Y, Z, C].
    """
    X, Y, Z = ptot_shape
    return [grid_sample_3d(v, tgrid_coords).reshape(X, Y, Z, v.shape[-1])
            for v in volumes]


def sample_warped(warped, pgrid_coords):
    """The second grid sample: the warped posed volumes at the ray samples'
    coordinates (ref tpose_xyzc.py:95-98). pgrid_coords [N, 3] zyx order
    -> [N, 352]."""
    return torch.cat([grid_sample_3d(w, pgrid_coords) for w in warped],
                     dim=-1)


def decode(params, feat, wpts, viewdir, latent_index, static: TposeStatic):
    """The shared MLP heads (ref tpose_xyzc.py:42-64), in f32: feat [N, 352]
    -> raw [N, 4] (rgb logits, sigma)."""
    net = torch.relu(dense(params["fc_0"], feat))
    net = torch.relu(dense(params["fc_1"], net))
    net = torch.relu(dense(params["fc_2"], net))
    alpha = dense(params["alpha_fc"], net)

    features = dense(params["feature_fc"], net)
    # index_select, not indexing: a 0-d index tensor would be read back
    latent = params["frame_latent"].index_select(
        0, latent_index.long().reshape(-1))
    latent = latent.expand(features.shape[0], latent.shape[-1])
    features = dense(params["latent_fc"], torch.cat([features, latent], -1))

    view_emb = positional_encoding(viewdir, static.view_res)
    xyz_emb = positional_encoding(wpts, static.xyz_res)
    features = torch.cat([features, view_emb, xyz_emb], dim=-1)
    net = torch.relu(dense(params["view_fc"], features))
    rgb = dense(params["rgb_fc"], net)
    return torch.cat([rgb, alpha], dim=-1)


@register("model_static", "tpose_xyzc")
def make_static(cfg, dataset):
    """T-pose statics: the encoder grid lives in T-pose space (the T-pose
    dataset's tgeo, not the posed frames' geo) and the warped posed grid's
    shape is the dataset's static ptot_shape. No compute dtype: the family
    runs in f32."""
    geo = getattr(dataset, "tgeo", dataset.geo)
    return TposeStatic(
        encoder=sparse_conv_net.EncoderStatic(
            out_sh=geo.out_sh, site_caps=geo.site_caps),
        ptot_shape=tuple(dataset.ptot_shape),
        xyz_res=cfg.xyz_res, view_res=cfg.view_res)


@register("network", "tpose_xyzc")
def make(cfg):
    """Factory: (init_fn, module); init_fn(gen, device=None) as init."""
    def init_fn(gen, device=None):
        return init(gen, num_train_frame=cfg.num_train_frame, nv=cfg.nv,
                    code_dim=cfg.code_dim, latent_dim=cfg.latent_dim,
                    xyz_res=cfg.xyz_res, view_res=cfg.view_res,
                    device=device)
    import sys
    return init_fn, sys.modules[__name__]
