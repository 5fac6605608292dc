"""Image quality metrics: PSNR and SSIM (counterpart of
neuralbody_tpu/evaluators/metrics.py; numpy and scipy, host only).

SSIM reimplements skimage's structural_similarity with the exact defaults the
reference hits via `compare_ssim(img_pred, img_gt, multichannel=True)`
(ref: lib/evaluators/if_nerf.py:44): win_size=7 uniform filter, K1=0.01,
K2=0.03, sample covariance (N/(N-1)), and — importantly — data_range=2.0,
because skimage derives the range from the float dtype ((-1, 1)). The
published reference numbers (BASELINE.md) were produced with that implicit
data_range, so we default to it for comparability.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(img_pred, img_gt):
    """-10 log10(mse) (ref: lib/evaluators/if_nerf.py:15-18)."""
    mse = np.mean((img_pred - img_gt) ** 2)
    return -10.0 * np.log(mse) / np.log(10.0)


def ssim_single(x, y, data_range=2.0, win_size=7, K1=0.01, K2=0.03):
    """Single-channel SSIM, skimage-compatible (uniform window, sample cov)."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    ndim = x.ndim
    NP = win_size ** ndim
    cov_norm = NP / (NP - 1)

    filt = lambda a: uniform_filter(a, size=win_size)  # noqa: E731
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    sl = tuple(slice(pad, s - pad) for s in S.shape)
    return S[sl].mean()


def ssim(img_pred, img_gt, multichannel=True, data_range=2.0, win_size=7):
    if multichannel and img_pred.ndim == 3:
        return float(np.mean([
            ssim_single(img_pred[..., c], img_gt[..., c],
                        data_range=data_range, win_size=win_size)
            for c in range(img_pred.shape[-1])
        ]))
    return float(ssim_single(img_pred, img_gt, data_range=data_range,
                             win_size=win_size))
