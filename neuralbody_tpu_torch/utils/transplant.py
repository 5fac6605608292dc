"""Weights of the JAX package, and of the reference's PyTorch checkpoints,
-> the port's parameters (counterpart of
neuralbody_tpu/utils/transplant.py).

The port keys its parameters like the JAX pytree and keeps its layouts
(dense w [in, out], conv w [27, in, out]), so a JAX transplant is a
leaf-wise conversion. It takes numpy leaves (or anything np.asarray takes,
e.g. the arrays neuralbody_tpu.models.latent_xyzc.init returns), so this
module needs no JAX.

A reference checkpoint (`latest.pth`, ref: lib/utils/net_utils.py:326-338:
{'net': state_dict, ...}) maps into latent_xyzc's params and BN stats:
  * nn.Embedding -> rows as they are (c.weight -> vertex_code, latent ->
    frame_latent)
  * nn.Conv1d(k=1) [out, in, 1] -> dense [in, out] (transposed)
  * spconv conv weights -> [27, in, out], from spconv 1.x's [kd, kh, kw,
    in, out] or torch's [out, in, kd, kh, kw]
  * BatchNorm1d weight / bias -> bn_scale / bn_bias, its running stats ->
    the BN stats
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
    """The state of an optax chain (clip -> [decay ->] adam or radam, or
    clip -> sgd) -> the port's optimizer state (load_state_dict of
    train/optimizer's Adam, RAdam or SGD), so that a JAX run resumes in the
    port: {mu, nu, count} from the element with mu/nu/count fields, or
    {trace, count} from sgd's trace element and the count of its learning
    rate's. The elements are found at any depth of the chain's nested
    tuples (optax's states are named tuples); the others hold no
    state."""
    def walk(s, fields):
        if set(fields) <= set(getattr(s, "_fields", ())):
            return [s]
        if isinstance(s, (list, tuple)):
            return [a for x in s for a in walk(x, fields)]
        return []

    found = walk(opt_state, ("mu", "nu", "count"))
    if len(found) == 1:
        adam = found[0]
        return {"mu": _tree(adam.mu, device), "nu": _tree(adam.nu, device),
                "count": int(np.asarray(adam.count))}
    traces = walk(opt_state, ("trace",))
    counts = walk(opt_state, ("count",))
    if not found and len(traces) == len(counts) == 1:
        return {"trace": _tree(traces[0].trace, device),
                "count": int(np.asarray(counts[0].count))}
    raise ValueError(f"expected one Adam state or one SGD trace in the "
                     f"chain, found {len(found)} and {len(traces)}")


def _dense(w, b):
    w = np.asarray(w)
    if w.ndim == 3:          # [out, in, 1]
        w = w[:, :, 0]
    return {"w": w.T, "b": np.asarray(b)}


def _sparse_conv_weight(w):
    """Any known sparse-conv weight layout -> [27, in, out]."""
    w = np.asarray(w)
    if w.ndim == 3 and w.shape[0] == 27:
        return w
    if w.ndim == 5:
        if w.shape[0] == 3 and w.shape[1] == 3 and w.shape[2] == 3:
            # [kd, kh, kw, in, out]
            return w.reshape(27, w.shape[3], w.shape[4])
        # torch layout [out, in, kd, kh, kw]
        return w.transpose(2, 3, 4, 1, 0).reshape(27, w.shape[1], w.shape[0])
    raise ValueError(f"unrecognized sparse conv weight shape {w.shape}")


# (our block name, number of conv layers) in reference Sequential order
_ENCODER_BLOCKS = [
    ("conv0", 2), ("down0", 1), ("conv1", 2), ("down1", 1),
    ("conv2", 3), ("down2", 1), ("conv3", 3), ("down3", 1), ("conv4", 3),
]
_HEADS = ["fc_0", "fc_1", "fc_2", "alpha_fc", "feature_fc", "latent_fc",
          "view_fc", "rgb_fc"]


def transplant_state_dict(state, params, bn_stats):
    """A reference Network's state_dict -> new (params, bn_stats) trees of
    the port, on the device of `params` (whose other entries are kept).

    state: {reference name: array or tensor}; 'module.' (DDP) prefixes are
    stripped."""
    state = {k.replace("module.", ""): np.asarray(
        v.detach().cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in state.items()}
    device = params["vertex_code"].device
    new = {"vertex_code": state["c.weight"],
           "frame_latent": state["latent.weight"]}
    for name in _HEADS:
        new[name] = _dense(state[f"{name}.weight"], state[f"{name}.bias"])
    enc, stats = dict(params["xyzc_net"]), dict(bn_stats["xyzc_net"])
    for block, n_layers in _ENCODER_BLOCKS:
        layers, stats_layers = [], []
        for i in range(n_layers):
            # the reference's SparseSequential: convs at 0, 3, 6, BNs at
            # 1, 4, 7
            conv = f"xyzc_net.{block}.{3 * i}"
            bn = f"xyzc_net.{block}.{3 * i + 1}"
            layers.append({
                "w": _sparse_conv_weight(state[f"{conv}.weight"]),
                "bn_scale": state[f"{bn}.weight"],
                "bn_bias": state[f"{bn}.bias"],
            })
            stats_layers.append({"mean": state[f"{bn}.running_mean"],
                                 "var": state[f"{bn}.running_var"]})
        enc[block] = layers
        stats[block] = stats_layers
    params = dict(params, **_tree(new, device))
    params["xyzc_net"] = _tree(enc, device)
    return params, {"xyzc_net": _tree(stats, device)}


def load_torch_checkpoint(path):
    """Read a reference .pth on the CPU: ({name: numpy array}, its epoch,
    -1 when it has none)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    net = payload.get("net", payload)
    return ({k: v.detach().numpy() for k, v in net.items()},
            payload.get("epoch", -1))


def transplant_from_pth(path, params, bn_stats):
    """(params, bn_stats, epoch) of a reference .pth (see
    transplant_state_dict)."""
    state, epoch = load_torch_checkpoint(path)
    params, bn_stats = transplant_state_dict(state, params, bn_stats)
    return params, bn_stats, epoch
