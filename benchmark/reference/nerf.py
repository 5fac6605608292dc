"""Plain reference of the NeRF baseline of Neural Body's paper (Mildenhall
et al., ECCV 2020, as Neural Body configures it): an 8-layer, 256-wide MLP
with a skip at layer 4 and a 128-wide view branch, a coarse pass of evenly
spaced depths, deterministic importance samples from its weights, and a
fine MLP over both sets of depths. Float32. Nothing here imports the
program under test.
"""
from __future__ import annotations

import torch

from .common import (composite, dense_spec, importance_depths,
                     linspace_depths, positional_encoding)

SKIP = 4


def mlp_spec(depth=8, width=256, xyz_res=10, view_res=4):
    """One MLP's parameter tree (torch.nn.Linear's initialisation, the
    density's bias lifted by 1)."""
    cx, cv = 3 * (1 + 2 * xyz_res), 3 * (1 + 2 * view_res)
    layers = [dense_spec(cx, width)]
    for i in range(depth - 1):
        layers.append(dense_spec(width + cx if i == SKIP else width, width))
    return {"pts_linears": layers,
            "views_linear": dense_spec(cv + width, width // 2),
            "feature_linear": dense_spec(width, width),
            # the density's bias lifted by 1: with torch's initialisation
            # alone most samples have no density and the views are black
            "alpha_linear": {"w": dense_spec(width, 1)["w"],
                             "b": ("uniform", (1,), width ** -0.5, 1.0)},
            "rgb_linear": dense_spec(width // 2, 3)}


def weight_spec(depth=8, width=256, depth_fine=8, width_fine=256):
    return {"coarse": mlp_spec(depth, width), "fine": mlp_spec(depth_fine,
                                                               width_fine)}


def _dense(layer, x):
    return x @ layer["w"] + layer["b"]


def mlp(p, pts, viewdirs):
    """raw [N, 4] (rgb logits, density)."""
    x = positional_encoding(pts, 10)
    h = x
    for i, layer in enumerate(p["pts_linears"]):
        h = torch.relu(_dense(layer, h))
        if i == SKIP:
            h = torch.cat([x, h], dim=-1)
    alpha = _dense(p["alpha_linear"], h)
    h = torch.cat([_dense(p["feature_linear"], h),
                   positional_encoding(viewdirs, 4)], dim=-1)
    rgb = _dense(p["rgb_linear"], torch.relu(_dense(p["views_linear"], h)))
    return torch.cat([rgb, alpha], dim=-1)


def render(params, ray_o, ray_d, near, far, n_samples, n_importance,
           chunk=2048):
    """The fine pass's rgb [R, 3] of an evaluation render."""
    out = []
    with torch.no_grad():
        for r0 in range(0, ray_o.shape[0], chunk):
            ro, rd, n, f = (t[r0:r0 + chunk] for t in (ray_o, ray_d, near,
                                                       far))
            vd = rd / rd.norm(dim=-1, keepdim=True).clamp(min=1e-8)

            def run(p, z):
                S = z.shape[1]
                pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
                raw = mlp(p, pts, vd.repeat_interleave(S, 0))
                return composite(raw.reshape(-1, S, 4), z, rd)

            z = linspace_depths(n, f, n_samples)
            _, w = run(params["coarse"], z)
            zi = importance_depths(0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1],
                                   n_importance)
            z = torch.sort(torch.cat([z, zi], dim=-1), dim=-1).values
            out.append(run(params["fine"], z)[0])
    return torch.cat(out)


def render_image(params, geo, frame, ray_o, ray_d, near, far, config):
    """A held-out view's rgb as the evaluation renders it."""
    return render(params, ray_o, ray_d, near, far, int(config["N_samples"]),
                  int(config["N_importance"]))


def loss(params, steps, geos, config):
    """The training loss of one step (steps: batch elements with ray_o,
    ray_d, near, far, rgb, ray_mask and gen, the torch.Generator of the
    step's draws): stratified depths perturbed by U(0, 1) draws [R, S], the
    coarse pass, importance samples at U(0, 1) draws [R, N_importance], the
    fine pass; the mean squared error of both passes over the valid rays."""
    S, n_imp = int(config["N_samples"]), int(config["N_importance"])
    total = 0.0
    for el in steps:
        ro, rd, gen = el["ray_o"], el["ray_d"], el["gen"]
        vd = rd / rd.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        z = linspace_depths(el["near"], el["far"], S)
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        hi = torch.cat([mids, z[:, -1:]], -1)
        lo = torch.cat([z[:, :1], mids], -1)
        z = lo + (hi - lo) * torch.rand(z.shape, generator=gen,
                                        device=z.device)

        def run(p, zz):
            n = zz.shape[1]
            pts = (ro[:, None] + rd[:, None] * zz[..., None]).reshape(-1, 3)
            raw = mlp(p, pts, vd.repeat_interleave(n, 0))
            return composite(raw.reshape(-1, n, 4), zz, rd)

        rgb0, w = run(params["coarse"], z)
        u = torch.rand((z.shape[0], n_imp), generator=gen, device=z.device)
        zi = importance_depths(0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1],
                               n_imp, u).detach()
        rgb, _ = run(params["fine"], torch.sort(torch.cat([z, zi], -1),
                                                -1).values)
        m = el["ray_mask"][:, None]
        count = (m.sum() * 3).clamp(min=1.0)
        total = total + ((((rgb - el["rgb"]) ** 2) * m).sum()
                         + (((rgb0 - el["rgb"]) ** 2) * m).sum()) / count
    return total
