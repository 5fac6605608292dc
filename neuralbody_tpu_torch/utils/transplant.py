"""Weights of the JAX package -> the port's parameters.

The port keys its parameters like the JAX pytree and keeps its layouts
(dense w [in, out], conv w [27, in, out]), so the transplant is a leaf-wise
conversion. It takes numpy leaves (or anything np.asarray takes, e.g. the
arrays neuralbody_tpu.models.latent_xyzc.init returns), so this module
needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(params_np, stats_np, device="cpu"):
    """(params, bn_stats) pytrees of the JAX package -> the port's dicts of
    tensors on `device`. A gradient pytree has the params' structure and
    maps the same way."""
    return _tree(params_np, device), _tree(stats_np, device)


def opt_state_from_jax(opt_state, device="cpu"):
    """The Adam state of an optax chain (clip -> [decay ->] adam) -> the
    port's optimizer state {mu, nu, count} (train/optimizer.Adam
    .load_state_dict), so that a JAX run resumes in the port. The chain's
    Adam element is found, at any depth of the chain's nested tuples, by
    its mu/nu/count fields; the others hold no state."""
    def walk(s):
        if all(hasattr(s, k) for k in ("mu", "nu", "count")):
            return [s]
        if isinstance(s, (list, tuple)):
            return [a for x in s for a in walk(x)]
        return []

    found = walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state in the chain, found "
                         f"{len(found)}")
    adam = found[0]
    return {"mu": _tree(adam.mu, device), "nu": _tree(adam.nu, device),
            "count": int(np.asarray(adam.count))}
