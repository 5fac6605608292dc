"""Device-side ray sampling (counterpart of neuralbody_tpu/ops/ray_ops.py):
stratified depth sampling along rays, with an explicit torch.Generator in
place of the PRNG key.
"""
import torch


def stratified_z_vals(near, far, n_samples, generator=None, perturb=False,
                      lindisp=False):
    """near/far: [..., R] -> z_vals [..., R, S].

    perturb draws each depth uniformly inside its bin (the midpoints
    between neighbouring depths bound the bins) from `generator`, a
    torch.Generator on near's device; without one the depths stay
    unperturbed, as without a key in the JAX package.
    """
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                            device=near.device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near[..., None] * (1.0 - t_vals)
                        + 1.0 / far[..., None] * t_vals)
    else:
        z_vals = near[..., None] * (1.0 - t_vals) + far[..., None] * t_vals

    if perturb and generator is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = torch.rand(z_vals.shape, generator=generator,
                            dtype=z_vals.dtype, device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand

    return z_vals


def sample_along_rays(ray_o, ray_d, near, far, n_samples, generator=None,
                      perturb=False, lindisp=False):
    """World-space points [..., R, S, 3] and z_vals [..., R, S]."""
    z_vals = stratified_z_vals(near, far, n_samples, generator, perturb,
                               lindisp)
    pts = ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]
    return pts, z_vals
