"""NeRF positional (frequency) encoding (counterpart of
neuralbody_tpu/ops/embedder.py).

Per input of width d the output is [x, sin(x*2^0), cos(x*2^0), ...,
sin(x*2^{L-1}), cos(x*2^{L-1})], each block of width d, concatenated on the
last axis (the reference embedder's interleaved layout).
"""
import torch


def embed_dim(num_freqs: int, input_dims: int = 3,
              include_input: bool = True) -> int:
    """Width of positional_encoding's output for an input of input_dims."""
    return input_dims * (include_input + 2 * num_freqs)


def positional_encoding(x, num_freqs: int, include_input: bool = True):
    """x: [..., d] -> [..., d*(include_input + 2*num_freqs)]."""
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                       # [..., L, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)    # [..., L, 2, d]
    enc = sc.reshape(*x.shape[:-1], num_freqs * 2 * d)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
