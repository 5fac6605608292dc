"""Inverse-CDF hierarchical (importance) sampling (counterpart of
neuralbody_tpu/ops/sample_pdf.py), with an explicit torch.Generator in place
of the PRNG key.
"""
import torch


def sample_pdf_at(bins, weights, u):
    """The samples of the piecewise-constant PDF at the CDF values u.

    bins [R, B] bin edges, weights [R, B-1] unnormalized bin weights,
    u [R, n] in [0, 1] -> [R, n] sample positions.
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, B]

    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def sample_pdf(bins, weights, n_samples, generator=None, det=False):
    """Draw samples from the piecewise-constant PDF defined by weights.

    Args:
      bins:    [R, B] bin edges (z_vals midpoints).
      weights: [R, B-1] unnormalized bin weights.
      n_samples: number of importance samples per ray.
      generator: torch.Generator on bins' device (required when det=False).
      det: deterministic (linspace) samples instead of uniform random.

    Returns:
      [R, n_samples] sample positions.
    """
    shape = bins.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype,
                           device=bins.device).expand(shape)
    else:
        if generator is None:
            raise ValueError("det=False needs a torch.Generator")
        u = torch.rand(shape, generator=generator, dtype=bins.dtype,
                       device=bins.device)
    return sample_pdf_at(bins, weights, u)
