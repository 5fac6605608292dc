"""Models: the SparseConvNet encoder, the latent_xyzc network, the NeRF
baseline and dense layer helpers."""
from . import latent_xyzc, nerf  # noqa: F401  (registers plugins)
