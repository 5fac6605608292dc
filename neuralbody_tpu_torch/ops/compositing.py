"""NeRF volume-rendering quadrature (counterpart of
neuralbody_tpu/ops/compositing.py): alpha = 1 - exp(-relu(sigma) * delta),
exclusive-cumprod transmittance, weighted sums for rgb/depth/disp/acc.
"""
import torch


def raw2outputs(raw, z_vals, rays_d, white_bkgd=False, raw_noise_std=0.0,
                generator=None):
    """Composite per-sample raw predictions into per-ray maps.

    Args:
      raw:    [R, S, 4] rgb logits + density.
      z_vals: [R, S] sample depths along each ray.
      rays_d: [R, 3] (unnormalized) ray directions.
      raw_noise_std: > 0 adds N(0, std^2) noise to the density (training
        only; every shipped config sets 0), drawn from `generator`, a
        torch.Generator on raw's device, which it then requires.

    Returns dict(rgb_map [R,3], disp_map [R], acc_map [R], weights [R,S],
    depth_map [R]).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if generator is None:
            raise ValueError("raw_noise_std > 0 needs a torch.Generator")
        sigma = sigma + torch.randn(sigma.shape, generator=generator,
                                    device=sigma.device) * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)

    # exclusive cumulative product of (1 - alpha) -> transmittance
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans

    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    acc_map = weights.sum(-1)
    # NaN-safe: 0/0 on empty rays
    disp_map = 1.0 / torch.maximum(
        torch.full_like(depth_map, 1e-10),
        depth_map / torch.clamp(acc_map, min=1e-10))

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "weights": weights, "depth_map": depth_map}
