"""SparseConvNet: latent-code diffusion over the posed body volume
(counterpart of neuralbody_tpu/models/sparse_conv_net.py).

Double/triple submanifold conv blocks with stride-2 downsamples, emitting
site-list features at 4 scales (32/64/128/128 channels at strides 2/4/8/16);
each conv is bias-free and followed by active-site BatchNorm (eps=1e-3,
momentum=0.01) and ReLU. Parameters are a plain dict keyed like the JAX
pytree: {name: [{"w": [27, cin, cout], "bn_scale", "bn_bias"}, ...]}.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.sparse_conv import (
    down_conv, masked_batch_norm, site_mask, subm_conv, subm_conv_xtri,
)

# (name, kind, n_convs, cin, cout); kind 'subm' keeps the site set,
# 'down' moves to the next (half-res) level.
ARCH = [
    ("conv0", "subm", 2, 16, 16),
    ("down0", "down", 1, 16, 32),
    ("conv1", "subm", 2, 32, 32),      # -> net1 (stride 2)
    ("down1", "down", 1, 32, 64),
    ("conv2", "subm", 3, 64, 64),      # -> net2 (stride 4)
    ("down2", "down", 1, 64, 128),
    ("conv3", "subm", 3, 128, 128),    # -> net3 (stride 8)
    ("down3", "down", 1, 128, 128),
    ("conv4", "subm", 3, 128, 128),    # -> net4 (stride 16)
]
DENSE_AFTER = ("conv1", "conv2", "conv3", "conv4")   # -> levels 1..4
BN_EPS = 1e-3
BN_MOMENTUM = 0.01


class EncoderStatic(NamedTuple):
    """Static spec: full-res grid shape + per-level site capacities.

    compute_dtype="bfloat16" stores conv activations (the gathered bytes)
    in bf16 with f32 matmul accumulation and f32 BatchNorm.
    """
    out_sh: tuple    # (D, H, W), multiples of 32
    site_caps: tuple  # 5 ints
    compute_dtype: str = "float32"


def init(gen):
    """Conv weights U(-1/sqrt(27 cin), +) (torch conv default), BN identity;
    drawn on the CPU from the torch.Generator `gen`."""
    params, stats = {}, {}
    for name, _, n, cin, cout in ARCH:
        layers, bn_layers = [], []
        c_in = cin
        for _ in range(n):
            bound = 1.0 / math.sqrt(27.0 * c_in)
            layers.append({
                "w": (torch.rand((27, c_in, cout), generator=gen) * 2.0 - 1.0)
                * bound,
                "bn_scale": torch.ones((cout,)),
                "bn_bias": torch.zeros((cout,)),
            })
            bn_layers.append({"mean": torch.zeros((cout,)),
                              "var": torch.ones((cout,))})
            c_in = cout
        params[name] = layers
        stats[name] = bn_layers
    return params, stats


def _conv_bn_relu(layer, feats, table, mask, up_table=None, xtri=None):
    """One (conv -> masked BN -> relu) layer over batched site lists.

    feats [B, S_in, C_in] -> [B, S_out, C_out] f32. BN statistics are joint
    over the batch's active sites. up_table given => strided conv; xtri
    given => w-triple packed submanifold conv.
    """
    if xtri is not None:
        y = subm_conv_xtri(feats, layer["w"], *xtri)
    elif up_table is not None:
        y = down_conv(feats, layer["w"], table, up_table)
    else:
        y = subm_conv(feats, layer["w"], table)
    y, bn_batch = masked_batch_norm(
        y, mask, layer["bn_scale"], layer["bn_bias"], eps=BN_EPS)
    return torch.relu(y) * mask[..., None], bn_batch


def apply_sites(params, codes, geom, static: EncoderStatic):
    """Run the encoder, returning SITE-LIST features (no densification).

    Args:
      params: dict from init().
      codes: [B, S0_cap, 16] level-0 site features (scattered vertex codes).
      geom: batched frame-geometry tensors (each [B, ...]).
      static: EncoderStatic.

    Returns (site_feats, new_batch_stats): site_feats is a list of 4
    per-level f32 feature tables [B, S_l, C_l] (levels 1..4).
    """
    caps = static.site_caps
    masks = [site_mask(geom[f"nsite{l}"], caps[l]) for l in range(5)]

    def xtri_tabs(lvl):
        if f"xnbr9{lvl}" not in geom:
            return None  # geoms built without the packed tables
        return tuple(geom[f"x{n}{lvl}"]
                     for n in ("lnbr", "rnbr", "nbr9", "augl", "augr"))

    dt = (torch.bfloat16 if static.compute_dtype == "bfloat16"
          else torch.float32)
    x = codes.to(dt)
    lvl = 0
    site_feats = []
    new_stats = {}
    for name, kind, n, _, _ in ARCH:
        if kind == "down":
            table = geom[f"down{lvl}"]
            up = geom[f"up{lvl}"]
            lvl += 1
        else:
            table = geom[f"nbr{lvl}"]
            up = None
        layer_stats = []
        for i in range(n):
            is_down = kind == "down" and i == 0
            tbl = table if i == 0 else geom[f"nbr{lvl}"]
            x, bn_batch = _conv_bn_relu(
                params[name][i], x, tbl, masks[lvl],
                up_table=up if is_down else None,
                xtri=None if is_down else xtri_tabs(lvl))
            # conv accumulates f32, BN runs f32; only the STORED activation
            # (= next conv's gathered bytes) drops to compute_dtype
            x = x.to(dt)
            # the statistics feed the running-stat EMA, which carries no
            # graph
            layer_stats.append({"mean": bn_batch[0].detach(),
                                "var": bn_batch[1].detach()})
        new_stats[name] = layer_stats

        if name in DENSE_AFTER:
            site_feats.append(x.float())

    return site_feats, new_stats


def update_running_stats(stats, new_batch_stats, momentum=BN_MOMENTUM):
    """EMA update of BN running stats (torch momentum semantics)."""
    return {name: [{k: (1.0 - momentum) * run[k] + momentum * batch[k]
                    for k in run}
                   for run, batch in zip(stats[name], new_batch_stats[name])]
            for name in stats}
