"""Neural Body network: structured latent codes -> density + color field
(counterpart of neuralbody_tpu/models/latent_xyzc.py).

  * 6890x16 learned vertex codes, scattered into the posed voxel grid
  * SparseConvNet diffusion -> 4 multi-scale site feature tables
  * trilinear multi-scale feature interpolation at ray samples
  * density/color MLP with per-frame 128-d appearance codes

Parameters are a plain dict of tensors keyed like the JAX pytree; points
are rows [N, C]. The config-driven factories are registered as
"model_static" and "network" under "latent_xyzc".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import register
from ..ops.embedder import positional_encoding
from ..ops.grid_sample import multiscale_grid_sample
from ..ops.sparse_conv import scatter_vertex_codes, site_trilinear_sample
from ..utils.platform import constant, resolve_device, to_device
from . import sparse_conv_net
from .nn_utils import dense, dense_init, embedding_init, mxu_dtype

FEATURE_DIM = 352   # 32 + 64 + 128 + 128 concatenated scales


class ModelStatic(NamedTuple):
    """Static model spec."""
    encoder: sparse_conv_net.EncoderStatic
    xyz_res: int = 10
    view_res: int = 4

    @property
    def out_sh(self):
        return self.encoder.out_sh


def init(gen: torch.Generator, num_train_frame: int, nv: int = 6890,
         code_dim: int = 16, latent_dim: int = 128, xyz_res: int = 10,
         view_res: int = 4, device=None):
    """(params, bn_stats) drawn on the CPU from the torch.Generator `gen`
    (so a seed gives the same weights on every device), then moved to
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
    stats = {"xyzc_net": enc_stats}
    device = resolve_device(device)
    return to_device(params, device), to_device(stats, device)


def encode_sparse_voxels(params, geom, static: ModelStatic, densify=True):
    """Vertex codes -> the dense volumes [B, D_l, H_l, W_l, C_l], or with
    densify=False the per-level site features [B, S_l, C_l].

    geom: batched frame geometry (each leaf [B, ...]). Returns
    (site_feats | volumes, new_bn_stats).
    """
    cap0 = static.encoder.site_caps[0]
    codes = scatter_vertex_codes(params["vertex_code"], geom["vert_idx"],
                                 cap0)
    fn = sparse_conv_net.apply if densify else sparse_conv_net.apply_sites
    return fn(params["xyzc_net"], codes, geom, static.encoder)


def pts_to_can_pts(pts, R, Th):
    """World -> SMPL frame: (p - Th) @ R.  pts [..., 3], R [3, 3],
    Th [1, 3] or [3]."""
    return torch.matmul(pts - Th.reshape(1, 3), R)


def get_grid_coords(ppts, bounds, voxel_size, out_sh):
    """SMPL-frame points -> normalized grid coords (xyz order, [-1, 1]),
    with the reference's normalization: division by out_sh, not by
    out_sh - 1."""
    dhw = get_dhw_vox(ppts, bounds, voxel_size)
    dhw = dhw / constant(out_sh, dhw.dtype, dhw.device) * 2.0 - 1.0
    return dhw.flip(-1)   # xyz order; no index list to copy to the device


def interpolate_features(grid_coords, volumes):
    """Trilinear sample of each scale's dense volume at shared coords,
    concatenated -> [N, 352]."""
    return multiscale_grid_sample(volumes, grid_coords)


def interpolate_site_features(site_feats, index_vols, dhw_vox, static):
    """The same samples from the site features through per-level int32
    index volumes (one batch element): no dense float volume exists, and
    the backward scatters into [S_l, C] rows."""
    return torch.cat([
        site_trilinear_sample(feats, ivol, dhw_vox, static.out_sh,
                              static.encoder.site_caps[lvl])
        for lvl, (feats, ivol) in enumerate(zip(site_feats, index_vols), 1)],
        dim=-1)


def get_dhw_vox(ppts, bounds, voxel_size):
    """SMPL-frame points -> continuous full-res voxel coords (dhw order)."""
    vs = constant(voxel_size, ppts.dtype, ppts.device)
    return (ppts.flip(-1) - bounds[0].flip(-1)) / vs


def _density_trunk(params, feat, dt=None):
    net = torch.relu(dense(params["fc_0"], feat, dt))
    net = torch.relu(dense(params["fc_1"], net, dt))
    return torch.relu(dense(params["fc_2"], net, dt))


def calculate_density(params, wpts, volumes, frame, static: ModelStatic,
                      voxel_size):
    """wpts [N, 3] -> alpha [N, 1], from the dense volumes, in f32."""
    ppts = pts_to_can_pts(wpts, frame["R"], frame["Th"])
    gc = get_grid_coords(ppts, frame["bounds"], voxel_size, static.out_sh)
    net = _density_trunk(params, interpolate_features(gc, volumes))
    return dense(params["alpha_fc"], net)


def decode_raw(params, feat, wpts, viewdir, frame, static: ModelStatic):
    """Interpolated features [..., 352] -> raw [..., 4] (rgb logits, sigma).

    The MLP runs in the encoder's compute dtype as mxu_dtype resolves it
    for the features' device (bf16 operands, f32 accumulation on the card).
    """
    dt = mxu_dtype(static.encoder.compute_dtype, feat.device)
    dt = None if dt == torch.float32 else dt
    net = _density_trunk(params, feat, dt)
    alpha = dense(params["alpha_fc"], net, dt)

    features = dense(params["feature_fc"], net, dt)
    # index_select, not indexing: a 0-d index tensor would be read back to
    # the host (a device sync, which a CUDA graph cannot capture)
    latent = params["frame_latent"].index_select(
        0, frame["latent_index"].long().reshape(-1))
    latent = latent.expand(*features.shape[:-1], latent.shape[-1])
    features = dense(params["latent_fc"],
                     torch.cat([features, latent.to(features.dtype)], dim=-1),
                     dt)

    view_emb = positional_encoding(viewdir, static.view_res)
    xyz_emb = positional_encoding(wpts, static.xyz_res)
    features = torch.cat([features, view_emb.to(features.dtype),
                          xyz_emb.to(features.dtype)], dim=-1)

    net = torch.relu(dense(params["view_fc"], features, dt))
    rgb = dense(params["rgb_fc"], net, dt)
    return torch.cat([rgb, alpha], dim=-1)


def calculate_density_color(params, wpts, viewdir, volumes, frame,
                            static: ModelStatic, voxel_size, index_vols=None):
    """wpts/viewdir [N, 3] -> raw [N, 4] (rgb logits + sigma).

    volumes: one batch element's dense volumes (index_vols None) or its
    per-level site features (index_vols given: the site-interpolation
    path).
    """
    ppts = pts_to_can_pts(wpts, frame["R"], frame["Th"])
    if index_vols is not None:
        dhw = get_dhw_vox(ppts, frame["bounds"], voxel_size)
        feat = interpolate_site_features(volumes, index_vols, dhw, static)
    else:
        gc = get_grid_coords(ppts, frame["bounds"], voxel_size, static.out_sh)
        feat = interpolate_features(gc, volumes)
    return decode_raw(params, feat, wpts, viewdir, frame, static)


@register("model_static", "latent_xyzc")
def make_static(cfg, dataset):
    """Static model spec from the dataset's sequence geometry (static grid
    shape + per-level site capacities)."""
    geo = dataset.geo
    return ModelStatic(
        encoder=sparse_conv_net.EncoderStatic(
            out_sh=geo.out_sh, site_caps=geo.site_caps,
            compute_dtype=str(cfg.tpu.compute_dtype)),
        xyz_res=cfg.xyz_res, view_res=cfg.view_res)


@register("network", "latent_xyzc")
def make(cfg):
    """Factory: (init_fn, module). init_fn(gen, device=None) draws the
    weights from the torch.Generator `gen` (see init)."""
    def init_fn(gen, device=None):
        return init(
            gen,
            num_train_frame=cfg.num_train_frame,
            nv=cfg.nv,
            code_dim=cfg.code_dim,
            latent_dim=cfg.latent_dim,
            xyz_res=cfg.xyz_res,
            view_res=cfg.view_res,
            device=device,
        )
    import sys
    return init_fn, sys.modules[__name__]
