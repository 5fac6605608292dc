"""Models: the SparseConvNet encoder, the latent_xyzc network, the NeRF
baseline, the T-pose variant and dense layer helpers."""
from . import latent_xyzc, nerf, tpose_xyzc  # noqa: F401  (registers plugins)
