"""Renderer of the T-pose variant (counterpart of
neuralbody_tpu/renderer/tpose_renderer.py).

Sample the rays, move the samples into the posed SMPL frame, build the two
coordinate sets (the posed grid -> the T-pose volumes; the ray samples ->
the warped posed volumes), decode, composite. The warped posed volumes are
built once a frame (they depend on ptot_pts only), then every chunk of
rays samples them. Everything runs in f32 (models/tpose_xyzc.py).

The settings factory is registered as "renderer" under "tpose_renderer".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import register
from ..models import tpose_xyzc
from ..ops.compositing import raw2outputs
from ..ops.ray_ops import sample_along_rays
from ..utils.platform import constant


class TposeRenderSettings(NamedTuple):
    model: tpose_xyzc.TposeStatic
    voxel_size: tuple = (0.005, 0.005, 0.005)
    ptot_vsize: tuple = (0.02, 0.02, 0.02)
    n_samples: int = 64
    perturb: bool = True
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    chunk_rays: int = 2048


def tpose_grid_coords(pts_xyz, bounds, voxel_size, out_sh):
    """xyz points -> normalized coordinates into the T-pose volume (zyx
    order), divided by out_sh and not out_sh - 1, the reference's quirk
    (tpose_renderer.py:73-83)."""
    gc = (pts_xyz - bounds[0]) / constant(tuple(voxel_size), pts_xyz.dtype,
                                          pts_xyz.device)
    gc = gc / constant(tuple(out_sh), pts_xyz.dtype, pts_xyz.device) \
        * 2.0 - 1.0
    return gc.flip(-1)


def _render_chunk(params, batch, b, warped, s, rays, train, generator):
    """Sample, warp, decode and composite one chunk of rays of frame b."""
    ro, rd, near, far = rays
    pts, z_vals = sample_along_rays(ro, rd, near, far, s.n_samples,
                                    generator=generator,
                                    perturb=s.perturb and train)
    viewdir = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                               min=1e-8)
    n_ray = ro.shape[0]
    wpts = pts.reshape(n_ray * s.n_samples, 3)
    vdir = viewdir.repeat_interleave(s.n_samples, dim=0)

    # world -> posed SMPL frame
    ppts = torch.matmul(wpts - batch["Th"][b].reshape(1, 3), batch["R"][b])
    # posed coords -> warped-volume grid coords (zyx), normalized by the
    # padded static ptot_shape
    dev = ppts.device
    pgc = (ppts - batch["pbounds"][b][0]) / constant(
        tuple(s.ptot_vsize), ppts.dtype, dev)
    pgc = pgc / constant(tuple(s.model.ptot_shape), ppts.dtype, dev) \
        * 2.0 - 1.0
    pgc = pgc.flip(-1)

    feat = tpose_xyzc.sample_warped(warped, pgc)
    raw = tpose_xyzc.decode(params, feat, wpts, vdir,
                            batch["latent_index"][b], s.model)
    out = raw2outputs(raw.reshape(n_ray, s.n_samples, 4), z_vals, rd,
                      s.white_bkgd, s.raw_noise_std if train else 0.0,
                      generator)
    del out["weights"]
    return out


def render_tpose_rays(params, batch, settings: TposeRenderSettings,
                      train=False, generator=None):
    """Render a batch of the T-pose dataset.

    batch: geom (the T-pose tables, each leaf [B, ...]), ray_o/ray_d/near/
    far [B, R, .], R/Th, tbounds/pbounds [B, 2, 3], ptot_pts [B, X*Y*Z, 3]
    (the posed grid's T-pose coordinates), latent_index. The rays go in
    chunks of settings.chunk_rays, of which R must be a multiple.
    train=True turns on the stratified perturbation and the raw-noise term,
    drawn from `generator` (a torch.Generator on the batch's device).
    Returns (ret, new_bn_stats): rgb_map [B, R, 3], disp/acc/depth [B, R].
    """
    s = settings
    ray_o = batch["ray_o"]
    B, R = ray_o.shape[:2]
    chunk = min(s.chunk_rays, R)
    if R % chunk != 0:
        raise ValueError(f"ray count {R} not a multiple of {chunk}")

    volumes, new_stats = tpose_xyzc.encode_tpose_voxels(
        params, batch["geom"], s.model)

    outs = []
    for b in range(B):
        # the warped posed-space feature volumes, once a frame
        tgc = tpose_grid_coords(batch["ptot_pts"][b], batch["tbounds"][b],
                                s.voxel_size, s.model.encoder.out_sh)
        warped = tpose_xyzc.warp_volumes([v[b] for v in volumes], tgc,
                                         s.model.ptot_shape)
        chunks = [
            _render_chunk(params, batch, b, warped, s,
                          tuple(batch[k][b, c0:c0 + chunk]
                                for k in ("ray_o", "ray_d", "near", "far")),
                          train, generator)
            for c0 in range(0, R, chunk)]
        outs.append({k: torch.cat([c[k] for c in chunks])
                     for k in chunks[0]})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, \
        new_stats


@register("renderer", "tpose_renderer")
def make_tpose_renderer(cfg, model_static):
    return TposeRenderSettings(
        model=model_static,
        voxel_size=tuple(cfg.voxel_size),
        ptot_vsize=tuple(cfg.get("ptot_vsize", [0.02, 0.02, 0.02])),
        n_samples=cfg.N_samples,
        perturb=bool(cfg.perturb),
        white_bkgd=bool(cfg.white_bkgd),
        raw_noise_std=float(cfg.raw_noise_std),
        chunk_rays=int(cfg.tpu.chunk_rays))
