"""Volume renderer (counterpart of neuralbody_tpu/renderer/renderer.py).

The feature volume is encoded once per batch; every ray sample is
interpolated, decoded, culled against the visual hull and composited. Hull
culling zeroes the raw field outside the hull, which is what the reference
zero-fills. Two paths:

  * batches that carry the host planner's fields (hat_sort) go through the
    grouped hat contraction (ops/hat_interp.py): the training path;
  * a rays-only training batch under settings.hat_plan builds that plan on
    the device (ops/device_plan.py) and takes the same contraction;
  * rays-only batches (what the evaluators and visualizers send) sample
    their depths on the device and are rendered in chunks of chunk_rays
    rays, through the site features and int32 index volumes
    (site_interp=True) or through the densified volumes (the reference's
    grid_sample). render_density_grid, the mesh path, reads the densified
    volumes too.

The config-driven settings factories are registered as "renderer" under
"if_clight_renderer", "_mmsk", "_msk" and "if_mesh_renderer".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import register
from ..models import latent_xyzc as lx
from ..models import sparse_conv_net
from ..models.nn_utils import mxu_dtype
from ..ops.compositing import raw2outputs
from ..ops.hat_interp import (decode_z, expand_segments, hat_interpolate,
                              inverse_perm)
from ..ops.ray_ops import sample_along_rays, stratified_z_vals
from ..utils.profiling import span


class RenderSettings(NamedTuple):
    """Render-time static settings. n_samples, perturb, chunk_rays and
    site_interp are read for rays-only batches; on the hat path the sample
    count comes from the batch and the host planner samples the depths,
    perturbed or not."""
    model: lx.ModelStatic
    voxel_size: tuple = (0.005, 0.005, 0.005)
    n_samples: int = 64
    perturb: bool = True     # stratified perturbation in training renders
    white_bkgd: bool = False
    raw_noise_std: float = 0.0  # density noise in training renders
    chunk_rays: int = 2048   # rays decoded at once: bounds memory
    hull_views: int = 0      # >0: cull against this many source-view masks
    hull_mode: str = "multi"  # "multi" (mmsk) or "snapshot" (msk)
    img_hw: tuple = (512, 512)
    site_interp: bool = True  # site-feature interpolation (memory-light)
    # static per-level expansion widths of the hat path's compact row
    # segments (= the planner's rows_caps); consulted for segment batches
    hat_rows_caps: tuple = ()
    # ops/device_plan.DevicePlanSpec: a rays-only training batch builds its
    # hat plan on the device (render_rays_hat_device)
    hat_plan: tuple = None
    # None, or the sharded steps' group split (parallel/train.GroupShard):
    # the hat paths decode this rank's share(n_groups) of the groups and
    # gather(raw, first, total) every rank's raw field, so that every rank
    # composites all rays
    group_shard: object = None


_ELEM_KEYS = ("ray_o", "ray_d", "near", "far", "Th", "bounds",
              "latent_index", "z_vals", "z_frac", "hat_sort",
              "hat_seg_a1", "hat_seg_a2", "hat_seg_a3", "hat_seg_a4",
              "hat_seg_cum1", "hat_seg_cum2", "hat_seg_cum3", "hat_seg_cum4",
              "hat_rows1", "hat_rows2", "hat_rows3", "hat_rows4",
              "hat_wpts", "hat_vdir",
              "Ks", "RT", "msks", "R0_snap", "Th0_snap", "K")


def _pixel(uv, img_hw):
    """Nearest pixel of projected points, clipped into the image. Rounding
    is half-to-even as in JAX; the clip happens in float so a far-off point
    lands on the border as it does after JAX's saturating int cast, and a
    NaN (a point on the camera's plane: 0 / 0) goes to 0, as JAX casts it.
    A padded ray of the monocular demo projects there."""
    H, W = img_hw
    uv = torch.nan_to_num(torch.round(uv), nan=0.0)
    ui = torch.clamp(uv[:, 0], 0, W - 1).long()
    vi = torch.clamp(uv[:, 1], 0, H - 1).long()
    return ui, vi


def hull_inside_mask(wpts, Ks, RT, msks, img_hw):
    """Project points into source views; inside = in every mask.

    wpts [N, 3]; Ks [V, 3, 3]; RT [V, 4, 4]; msks [V, H, W].
    """
    inside = torch.ones(wpts.shape[0], dtype=torch.bool, device=wpts.device)
    for K, rt, msk in zip(Ks, RT, msks):
        cam = wpts @ rt[:3, :3].T + rt[:3, 3]
        uvw = cam @ K.T
        ui, vi = _pixel(uvw[:, :2] / uvw[:, 2:], img_hw)
        inside &= msk[vi, ui] > 0
    return inside


def snapshot_hull_mask(wpts, frame, R0, Th0, K, RT, msk, img_hw):
    """Monocular hull: world -> SMPL -> snapshot world -> mask lookup."""
    can_pts = torch.matmul(wpts - frame["Th"].reshape(1, 3), frame["R"])
    pts = can_pts @ R0.T + Th0
    cam = pts @ RT[:3, :3].T + RT[:3, 3]
    uvw = cam @ K.T
    ui, vi = _pixel(uvw[:, :2] / uvw[:, 2:], img_hw)
    return msk[vi, ui] > 0


def _sorted_pts_dirs(elem, z, srt, ngrp, n_samples):
    """Sorted group points [ngrp, P, 3] and unit view dirs from the plan."""
    P = srt.shape[0] // ngrp
    pts = elem["ray_o"][:, None, :] + elem["ray_d"][:, None, :] * z[..., None]
    wpts = pts.reshape(-1, 3)[srt].reshape(ngrp, P, 3)
    vd = elem["ray_d"]
    vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1, keepdim=True),
                          min=1e-8)
    return wpts, vd[srt // n_samples].reshape(ngrp, P, 3)


def _depths(elem):
    if "z_frac" in elem:
        return decode_z(elem["z_frac"], elem["near"], elem["far"])
    return elem["z_vals"]


def precompute_hat_device(batch, rows_caps, site_caps, n_samples):
    """Materialize the plan's device-reconstructed tensors once for a batch
    that is rendered repeatedly: expanded row lists (hat_rows{l}) and
    sorted group points/dirs (hat_wpts/hat_vdir). Returns a new batch dict
    (tensors on the batch's device)."""
    batch = dict(batch)
    B = batch["hat_sort"].shape[0]
    for li, l in enumerate((1, 2, 3, 4)):
        batch[f"hat_rows{l}"] = torch.stack([
            expand_segments(batch[f"hat_seg_a{l}"][b],
                            batch[f"hat_seg_cum{l}"][b],
                            rows_caps[li], site_caps[l]) for b in range(B)])
        del batch[f"hat_seg_a{l}"], batch[f"hat_seg_cum{l}"]
    wpts, vdir = [], []
    for b in range(B):
        elem = {k: batch[k][b] for k in
                ("near", "far", "z_frac", "z_vals", "ray_o", "ray_d",
                 "hat_sort") if k in batch}
        srt = elem["hat_sort"].long()
        w, v = _sorted_pts_dirs(elem, _depths(elem), srt,
                                batch["hat_rows1"].shape[1], n_samples)
        wpts.append(w)
        vdir.append(v)
    batch["hat_wpts"] = torch.stack(wpts)
    batch["hat_vdir"] = torch.stack(vdir)
    return batch


def _group_share(s, ngrp):
    """[g0, g1) of the groups this rank decodes: all of them unless
    settings.group_shard splits them over the ranks."""
    if s.group_shard is None:
        return 0, ngrp
    return s.group_shard.share(ngrp)


def _elem(batch, b):
    elem = {k: batch[k][b] for k in _ELEM_KEYS if k in batch}
    elem["R"] = batch["R"] if batch["R"].dim() == 2 else batch["R"][b]
    elem["geom"] = {k: v[b] for k, v in batch["geom"].items()}
    return elem


def _hat_site_feats(params, batch, s):
    site_feats, new_stats = lx.encode_sparse_voxels(
        params, batch["geom"], s.model, densify=False)
    if mxu_dtype(s.model.encoder.compute_dtype,
                 site_feats[0].device) == torch.bfloat16:
        # bf16 site features halve the gathered bytes and select the bf16
        # contraction of the hat kernel
        site_feats = [x.bfloat16() for x in site_feats]
    return site_feats, new_stats


def render_rays_hat(params, batch, settings: RenderSettings, train=False,
                    generator=None):
    """Render over the host-planned hat fields.

    The host planner samples the depths (prepare_hat_batch's rng: perturbed
    for training, midpoints otherwise), so `train` only switches on the
    raw-noise term, drawn from `generator`. Autograd records the render
    unless the caller disables it.

    Requires the planner's fields (ops/hat_interp.prepare_hat_batch: z_vals
    or z_frac, hat_sort, hat_seg_a{1..4}, hat_seg_cum{1..4}) plus
    settings.hat_rows_caps, or the pre-expanded hat_rows{l} (and optionally
    hat_wpts/hat_vdir) from precompute_hat_device. Under
    settings.group_shard this rank decodes its share of the groups only.

    Returns (ret, new_bn_stats); ret maps are [B, R, ...].
    """
    s = settings
    pre_expanded = "hat_rows1" in batch
    if not pre_expanded and len(s.hat_rows_caps) != 4:
        raise ValueError(
            "hat batch needs RenderSettings.hat_rows_caps (the planner's "
            "rows_caps, e.g. hat_static['rows_caps'])")

    site_feats, new_stats = _hat_site_feats(params, batch, s)
    B, R = batch["ray_o"].shape[:2]
    n_samples = (batch["z_frac"] if "z_frac" in batch
                 else batch["z_vals"]).shape[-1]

    outs = []
    for b in range(B):
        elem = _elem(batch, b)
        ngrp = elem["hat_rows1" if pre_expanded else "hat_seg_a1"].shape[0]
        g0, g1 = _group_share(s, ngrp)
        if pre_expanded:
            rows = {l: elem[f"hat_rows{l}"][g0:g1].to(torch.int32)
                    for l in (1, 2, 3, 4)}
        else:
            rows = {l: expand_segments(
                        elem[f"hat_seg_a{l}"][g0:g1],
                        elem[f"hat_seg_cum{l}"][g0:g1],
                        s.hat_rows_caps[l - 1], s.model.encoder.site_caps[l])
                    for l in (1, 2, 3, 4)}
        z = _depths(elem)
        srt = elem["hat_sort"].long()
        P = srt.shape[0] // ngrp
        if "hat_wpts" in elem:
            wpts, vdir = elem["hat_wpts"][g0:g1], elem["hat_vdir"][g0:g1]
        else:
            wpts, vdir = _sorted_pts_dirs(elem, z, srt[g0 * P:g1 * P],
                                          g1 - g0, n_samples)
        outs.append(_hat_finish(params, elem, [x[b] for x in site_feats], s,
                                rows, srt, z, wpts, vdir, R, n_samples,
                                s.raw_noise_std if train else 0.0,
                                generator, (g0 * P, ngrp * P)))
    ret = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return ret, new_stats


def render_rays_hat_device(params, batch, settings: RenderSettings,
                           train=False, generator=None):
    """The hat training render with the plan built on the device
    (ops/device_plan.py), for a rays-only batch (ray_o/ray_d/near/far,
    frame info, geom) under settings.hat_plan (a DevicePlanSpec).

    The depths are drawn here (ops/ray_ops.stratified_z_vals; perturbed
    from `generator` when train and settings.perturb), then grouped, and
    the render is render_rays_hat's. The JAX function folds its key per
    batch element; the port draws every element from one generator, so
    only perturb off is held bit for bit. Under settings.group_shard every
    rank builds the same whole plan (integer operations on the same
    inputs) and decodes its share of the groups.

    Returns (ret, new_bn_stats); ret adds plan_overflow [B] (1.0 where a
    plan needed more than the spec's static sizes).
    """
    from ..ops.device_plan import plan_hat_device
    s = settings
    spec = s.hat_plan
    site_feats, new_stats = _hat_site_feats(params, batch, s)
    B, R = batch["ray_o"].shape[:2]
    n_samples, P = s.n_samples, spec.group_size
    g0, g1 = _group_share(s, spec.n_groups)

    outs = []
    for b in range(B):
        elem = _elem(batch, b)
        z = stratified_z_vals(elem["near"], elem["far"], n_samples,
                              generator=generator,
                              perturb=train and s.perturb)        # [R, S]
        pts = (elem["ray_o"][:, None, :]
               + elem["ray_d"][:, None, :] * z[..., None]).reshape(-1, 3)
        dhw = lx.get_dhw_vox(lx.pts_to_can_pts(pts, elem["R"], elem["Th"]),
                             elem["bounds"], s.voxel_size)
        srt, rows, overflow = plan_hat_device(dhw.detach(), elem["geom"],
                                              spec)
        srt = srt.long()
        own = srt[g0 * P:g1 * P]
        vd = elem["ray_d"]
        vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1, keepdim=True),
                              min=1e-8)
        out = _hat_finish(params, elem, [x[b] for x in site_feats], s,
                          {l: r[g0:g1] for l, r in rows.items()}, srt, z,
                          pts[own].reshape(g1 - g0, P, 3),
                          vd[own // n_samples].reshape(g1 - g0, P, 3),
                          R, n_samples, s.raw_noise_std if train else 0.0,
                          generator, (g0 * P, spec.n_groups * P))
        out["plan_overflow"] = overflow
        outs.append(out)
    ret = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return ret, new_stats


def _hat_finish(params, elem, feats, s, rows, srt, z, wpts, vdir, R,
                n_samples, raw_noise_std=0.0, generator=None, slots=None):
    """Interpolate -> decode -> hull -> de-sort -> quadrature (one batch
    element; shared by the training and the eval render). rows, wpts and
    vdir are the groups this rank decodes; srt is the whole sort. Under
    settings.group_shard, slots = (this rank's first slot, all slots): the
    ranks' raw fields are gathered before the de-sort."""
    frame = {"R": elem["R"], "Th": elem["Th"], "bounds": elem["bounds"],
             "latent_index": elem["latent_index"]}
    ppts = lx.pts_to_can_pts(wpts, frame["R"], frame["Th"])
    dhw = lx.get_dhw_vox(ppts, frame["bounds"], s.voxel_size)
    feat = hat_interpolate(feats, elem["geom"], rows, dhw, s.model)
    raw = lx.decode_raw(params, feat, wpts, vdir, frame, s.model)
    raw = raw.reshape(-1, 4)

    if s.hull_views > 0:
        flat_pts = wpts.reshape(-1, 3)
        if s.hull_mode == "snapshot":
            inside = snapshot_hull_mask(
                flat_pts, frame, elem["R0_snap"], elem["Th0_snap"],
                elem["K"], elem["RT"][0], elem["msks"][0], s.img_hw)
        else:
            inside = hull_inside_mask(
                flat_pts, elem["Ks"], elem["RT"], elem["msks"], s.img_hw)
        raw = raw * inside[:, None]

    if s.group_shard is not None:
        raw = s.group_shard.gather(raw, *slots)
    # de-sort: ray-layout sample i reads its first sorted occurrence. A
    # device plan that overflowed its groups leaves samples out; they read
    # the last slot, as JAX's gather clamps (the step flags the plan)
    inv = torch.clamp(inverse_perm(srt, R * n_samples), max=raw.shape[0] - 1)
    raw = raw[inv].reshape(R, n_samples, 4)
    out = raw2outputs(raw, z, elem["ray_d"], s.white_bkgd, raw_noise_std,
                      generator)
    del out["weights"]
    return out


def _frame_info(batch, b):
    return {"R": batch["R"] if batch["R"].dim() == 2 else batch["R"][b],
            "Th": batch["Th"][b], "bounds": batch["bounds"][b],
            "latent_index": batch["latent_index"][b]}


def _render_chunk(params, elem, frame, vols, ivols, s, rays, train,
                  generator):
    """Sample, decode, hull-cull and composite one chunk of rays of one
    batch element. rays: (ray_o, ray_d, near, far) of the chunk."""
    ro, rd, near, far = rays
    pts, z_vals = sample_along_rays(ro, rd, near, far, s.n_samples,
                                    generator=generator,
                                    perturb=s.perturb and train)
    # padded rays have rd = 0: the clamp keeps NaN out
    viewdir = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                               min=1e-8)
    wpts = pts.reshape(-1, 3)
    vdir = viewdir.repeat_interleave(s.n_samples, dim=0)
    raw = lx.calculate_density_color(params, wpts, vdir, vols, frame,
                                     s.model, s.voxel_size, index_vols=ivols)
    if s.hull_views > 0:
        if s.hull_mode == "snapshot":
            inside = snapshot_hull_mask(
                wpts, frame, elem["R0_snap"], elem["Th0_snap"], elem["K"],
                elem["RT"][0], elem["msks"][0], s.img_hw)
        else:
            inside = hull_inside_mask(wpts, elem["Ks"], elem["RT"],
                                      elem["msks"], s.img_hw)
        raw = raw * inside[:, None]
    out = raw2outputs(raw.reshape(ro.shape[0], s.n_samples, 4), z_vals, rd,
                      s.white_bkgd, s.raw_noise_std if train else 0.0,
                      generator)
    del out["weights"]  # the [R, S] map is bulky
    return out


def render_rays(params, batch, settings: RenderSettings, train=False,
                generator=None):
    """Render all rays in a batch.

    Batches that carry the host-planned hat fields (hat_sort) take the hat
    path, and so does a rays-only training batch under settings.hat_plan
    (render_rays_hat_device). Other rays-only batches (geom,
    ray_o/ray_d/near/far [B, R, .], R/Th/bounds/latent_index, optional hull
    fields) sample settings.n_samples depths per ray on the device and
    render in chunks of settings.chunk_rays rays, of which R must be a
    multiple (pad with ray_mask = 0 rays).
    train=True turns on the stratified perturbation (settings.perturb) and
    the raw-noise term (settings.raw_noise_std), both drawn from `generator`,
    a torch.Generator on the batch's device. Returns (ret, new_bn_stats):
    ret has rgb_map [B,R,3] and disp/acc/depth [B,R].
    """
    s = settings
    if "hat_sort" in batch:
        return render_rays_hat(params, batch, settings, train=train,
                               generator=generator)
    if train and s.hat_plan is not None:
        return render_rays_hat_device(params, batch, settings, train=train,
                                      generator=generator)
    B, R = batch["ray_o"].shape[:2]
    chunk = min(s.chunk_rays, R)
    if R % chunk != 0:
        raise ValueError(
            f"ray count {R} must be a multiple of chunk_rays {chunk}")

    with span("render.encode"):
        volumes, new_stats = lx.encode_sparse_voxels(
            params, batch["geom"], s.model, densify=not s.site_interp)
        ivols = (sparse_conv_net.index_volumes(batch["geom"],
                                               s.model.encoder)
                 if s.site_interp else None)

    outs = []
    for b in range(B):
        elem = {k: batch[k][b] for k in _ELEM_KEYS if k in batch}
        frame = _frame_info(batch, b)
        vols = [v[b] for v in volumes]
        iv = [v[b] for v in ivols] if s.site_interp else None
        chunks = []
        for i, c0 in enumerate(range(0, R, chunk)):
            with span("render.chunk", chunk=i):
                chunks.append(_render_chunk(
                    params, elem, frame, vols, iv, s,
                    tuple(elem[k][c0:c0 + chunk]
                          for k in ("ray_o", "ray_d", "near", "far")),
                    train, generator))
        outs.append({k: torch.cat([c[k] for c in chunks])
                     for k in chunks[0]})
    ret = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return ret, new_stats


def render_density_grid(params, batch, settings: RenderSettings,
                        pt_chunk: int = 2048 * 64):
    """Density at a padded dense point grid (the mesh extraction path).

    batch["pts"] is [B, P, 3], P a multiple of pt_chunk (padded). Returns
    alpha [B, P], decoded in f32 from the densified volumes.
    """
    s = settings
    B, P = batch["pts"].shape[:2]
    if P == 0 or P % pt_chunk != 0:
        raise ValueError(
            f"point count {P} must be a multiple of pt_chunk {pt_chunk}")
    volumes, _ = lx.encode_sparse_voxels(params, batch["geom"], s.model)
    outs = []
    for b in range(B):
        vols = [v[b] for v in volumes]
        frame = _frame_info(batch, b)
        outs.append(torch.cat([
            lx.calculate_density(params, batch["pts"][b, p0:p0 + pt_chunk],
                                 vols, frame, s.model, s.voxel_size)[:, 0]
            for p0 in range(0, P, pt_chunk)]))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# registered renderer factories (config-driven harness entry points)
# ---------------------------------------------------------------------------

def _base_settings(cfg, model_static, **over):
    kw = dict(
        model=model_static,
        voxel_size=tuple(cfg.voxel_size),
        n_samples=cfg.N_samples,
        perturb=bool(cfg.perturb),
        white_bkgd=bool(cfg.white_bkgd),
        raw_noise_std=float(cfg.raw_noise_std),
        chunk_rays=int(cfg.tpu.chunk_rays),
        img_hw=(int(cfg.H * cfg.ratio), int(cfg.W * cfg.ratio)),
    )
    kw.update(over)
    return RenderSettings(**kw)


@register("renderer", "if_clight_renderer")
def make_clight(cfg, model_static):
    return _base_settings(cfg, model_static)


@register("renderer", "if_clight_renderer_mmsk")
def make_clight_mmsk(cfg, model_static):
    return _base_settings(cfg, model_static,
                          hull_views=len(cfg.training_view))


@register("renderer", "if_clight_renderer_msk")
def make_clight_msk(cfg, model_static):
    return _base_settings(cfg, model_static, hull_views=1,
                          hull_mode="snapshot")


@register("renderer", "if_mesh_renderer")
def make_mesh(cfg, model_static):
    return _base_settings(cfg, model_static)
