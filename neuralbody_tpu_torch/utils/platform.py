"""Device resolution and host -> device transfer.

Entry points run on the card unless the caller asks for the CPU: a missing
card is an error, never a silent fall back to the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """None -> the current card, as an indexed device ("cuda:0"), which is
    what a tensor on it reports. A CUDA device with no card present
    raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def constant(value, dtype, device) -> torch.Tensor:
    """torch.tensor(value, dtype=dtype, device=device) for a number or a
    tuple of numbers, built once per (value, dtype, device) and shared by
    every later caller. Device code that reads a Python constant on every
    call then makes no blocking host-to-device copy after the first one,
    which is also what lets a CUDA graph capture it. The tensor is shared:
    never modify it."""
    return _constant(value, dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _constant(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def _leaf(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)        # most torch ops lack torch.uint16
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_device(tree, device):
    """Numpy arrays / tensors in nested dicts, lists and tuples -> tensors on
    `device`. uint16 leaves (hat_sort, hat_seg_*, z_frac) become int32 on
    the host and float64 leaves float32; other leaves (ints, strings)
    pass through."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return _leaf(tree, device)
    return tree
