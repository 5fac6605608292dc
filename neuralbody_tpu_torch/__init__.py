"""neuralbody_tpu_torch: the PyTorch/CUDA port of neuralbody_tpu for an
NVIDIA H100.

It mirrors the JAX package's layout (ops/, models/, renderer/, train/,
utils/) and imports neither JAX nor the JAX package. It covers the
latent_xyzc model on the host-planned hat path: the forward render
(train/step.py:eval_step) and the training step (train/step.py:train_step,
with train/optimizer.py). The hat contraction and its backward run as
hand-written CUDA kernels (csrc/hat_interp.cu, ops/hat_kernel.py). Entry
points run on the card unless the caller passes device="cpu", where every
kernel's plain PyTorch version runs instead.
"""
