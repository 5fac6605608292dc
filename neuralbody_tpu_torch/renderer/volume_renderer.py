"""NeRF-baseline volume renderer with hierarchical importance sampling
(counterpart of neuralbody_tpu/renderer/volume_renderer.py): coarse
stratified pass, inverse-CDF importance resampling, fine pass, the coarse
outputs kept as rgb0/disp0/acc0 for the auxiliary loss.

The config-driven settings factories are registered as "renderer" under
"volume_renderer" and "volume_mesh_renderer".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import register
from ..models import nerf
from ..ops.compositing import raw2outputs
from ..ops.ray_ops import stratified_z_vals
from ..ops.sample_pdf import sample_pdf
from ..utils.profiling import span


class NerfRenderSettings(NamedTuple):
    model: nerf.NerfStatic
    model_fine: nerf.NerfStatic | None = None
    n_samples: int = 64
    n_importance: int = 128
    perturb: bool = True
    lindisp: bool = False
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    chunk_rays: int = 1024 * 32


def _render_chunk(params, s: NerfRenderSettings, ro, rd, near, far, train,
                  generator):
    """Coarse (and fine) pass of one chunk of rays of one batch element."""
    random = s.perturb and train and generator is not None
    # padded rays have rd = 0: the clamp keeps NaN out
    viewdirs = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True),
                                min=1e-8)
    n_ray = ro.shape[0]

    def decode(z_vals, model_params, model_static):
        S = z_vals.shape[1]
        pts = ro[:, None] + rd[:, None] * z_vals[..., None]
        raw = nerf.apply_mlp(
            model_params, pts.reshape(n_ray * S, 3),
            viewdirs.repeat_interleave(S, dim=0), model_static,
        ).reshape(n_ray, S, 4)
        return raw2outputs(
            raw, z_vals, rd, white_bkgd=s.white_bkgd,
            raw_noise_std=s.raw_noise_std if train else 0.0,
            generator=generator)

    z_vals = stratified_z_vals(near, far, s.n_samples, generator=generator,
                               perturb=random, lindisp=s.lindisp)
    out = decode(z_vals, params["coarse"], s.model)

    if s.n_importance > 0:
        coarse = {"rgb0": out["rgb_map"], "disp0": out["disp_map"],
                  "acc0": out["acc_map"]}
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mid, out["weights"][..., 1:-1],
                               s.n_importance, generator=generator,
                               det=not random).detach()
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                           dim=-1).values
        out = decode(z_all, params.get("fine", params["coarse"]),
                     s.model_fine or s.model)
        out.update(coarse)
        out["z_std"] = torch.std(z_samples, dim=-1, correction=0)

    del out["weights"]
    return out


def render_nerf_rays(params, batch, settings: NerfRenderSettings,
                     train=False, generator=None):
    """batch: ray_o/ray_d [B, R, 3], near/far [B, R]; returns (ret, {}):
    ret holds the fine maps rgb_map [B,R,3], disp/acc/depth [B,R] and, with
    n_importance > 0, the coarse rgb0/disp0/acc0 and z_std [B,R].

    The rays are rendered in chunks of settings.chunk_rays, of which R must
    be a multiple. train=True turns on the stratified perturbation and the
    random importance draw (settings.perturb) and the raw-noise term
    (settings.raw_noise_std). One `generator`, a torch.Generator on the
    batch's device, serves them in the order a chunk reaches them: the
    perturbation, the coarse pass's noise, the importance draw, the fine
    pass's noise; so a seeded render is reproducible. Without a generator
    the depths stay unperturbed and the importance samples deterministic.
    """
    s = settings
    B, R = batch["ray_o"].shape[:2]
    chunk = min(s.chunk_rays, R)
    if R % chunk != 0:
        raise ValueError(f"ray count {R} not a multiple of {chunk}")

    outs = []
    for b in range(B):
        chunks = []
        for i, c0 in enumerate(range(0, R, chunk)):
            with span("render.chunk", chunk=i):
                chunks.append(_render_chunk(
                    params, s, batch["ray_o"][b, c0:c0 + chunk],
                    batch["ray_d"][b, c0:c0 + chunk],
                    batch["near"][b, c0:c0 + chunk],
                    batch["far"][b, c0:c0 + chunk], train, generator))
        outs.append({k: torch.cat([c[k] for c in chunks])
                     for k in chunks[0]})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, {}


def render_nerf_density_grid(params, batch, settings: NerfRenderSettings,
                             pt_chunk: int = 2048 * 64):
    """NeRF density at a padded dense point grid (the nerf mesh path).
    batch["pts"] is [B, P, 3], P a multiple of min(pt_chunk, P); returns
    alpha [B, P] from the coarse trunk."""
    s = settings
    B, P = batch["pts"].shape[:2]
    chunk = min(pt_chunk, P)
    if P == 0 or P % chunk != 0:
        raise ValueError(f"point count {P} not a multiple of {chunk}")
    return torch.stack([
        torch.cat([nerf.apply_density(params["coarse"],
                                      batch["pts"][b, p0:p0 + chunk], s.model)
                   for p0 in range(0, P, chunk)])
        for b in range(B)])


@register("renderer", "volume_mesh_renderer")
def make_volume_mesh_renderer(cfg, model_static):
    st = nerf.NerfStatic(depth=cfg.netdepth, width=cfg.netwidth,
                         xyz_res=cfg.xyz_res, view_res=cfg.view_res)
    return NerfRenderSettings(
        model=st, n_samples=cfg.N_samples, n_importance=cfg.N_importance,
        perturb=False, white_bkgd=bool(cfg.white_bkgd),
        chunk_rays=int(cfg.tpu.chunk_rays))


@register("renderer", "volume_renderer")
def make_volume_renderer(cfg, model_static):
    st = nerf.NerfStatic(depth=cfg.netdepth, width=cfg.netwidth,
                         xyz_res=cfg.xyz_res, view_res=cfg.view_res)
    st_fine = nerf.NerfStatic(depth=cfg.netdepth_fine,
                              width=cfg.netwidth_fine,
                              xyz_res=cfg.xyz_res, view_res=cfg.view_res)
    return NerfRenderSettings(
        model=st, model_fine=st_fine,
        n_samples=cfg.N_samples, n_importance=cfg.N_importance,
        perturb=bool(cfg.perturb), lindisp=bool(cfg.lindisp),
        white_bkgd=bool(cfg.white_bkgd),
        raw_noise_std=float(cfg.raw_noise_std),
        chunk_rays=int(cfg.tpu.chunk_rays))
