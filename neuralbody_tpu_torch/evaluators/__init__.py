"""Evaluators (counterpart of neuralbody_tpu/evaluators/): PSNR and SSIM,
and the registered "if_nerf", "neural_volume" and "if_nerf_mesh"
evaluators."""
from . import if_nerf  # noqa: F401  (registers plugins)
from .metrics import psnr, ssim

__all__ = ["if_nerf", "psnr", "ssim"]
