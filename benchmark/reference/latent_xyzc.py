"""Plain reference of Neural Body's latent_xyzc model (Peng et al., CVPR
2021): structured latent codes on the posed SMPL vertices, a SparseConvNet
that diffuses them, trilinear interpolation of its four feature volumes,
and the density and colour MLP with a per-frame appearance code.

Written as the paper's code computes it, densely: the codes are summed
into a full-resolution voxel volume, every submanifold convolution is a
dense 3x3x3 convolution masked to the active voxels, every strided one a
dense stride-2 convolution whose active voxels are a 3x3x3 max-pool of the
input's, BatchNorm (batch statistics, eps 1e-3) runs over the active
voxels, and the features are F.grid_sample'd (align_corners=True, zeros
outside) at grid coordinates normalised by the full-resolution shape.
Float32 throughout. Nothing here imports the program under test.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (composite, dense_spec, linspace_depths,
                     positional_encoding)

# (name, kind, convs, cin, cout) of the SparseConvNet; the volumes after
# conv1..conv4 are the four feature scales
ARCH = [("conv0", "subm", 2, 16, 16), ("down0", "down", 1, 16, 32),
        ("conv1", "subm", 2, 32, 32), ("down1", "down", 1, 32, 64),
        ("conv2", "subm", 3, 64, 64), ("down2", "down", 1, 64, 128),
        ("conv3", "subm", 3, 128, 128), ("down3", "down", 1, 128, 128),
        ("conv4", "subm", 3, 128, 128)]
SCALES = ("conv1", "conv2", "conv3", "conv4")
FEATURE_DIM = 32 + 64 + 128 + 128
BN_EPS = 1e-3


def weight_spec(nv, n_frames, code_dim=16, latent_dim=128, xyz_res=10,
                view_res=4):
    """The parameter tree with each leaf's initialisation (common.
    make_weights): N(0, 1) codes, U(+-1/sqrt(27 cin)) convolutions,
    identity BatchNorm, torch.nn.Linear's layers (the density's bias
    lifted by 1)."""
    enc = {}
    for name, _, n, cin, cout in ARCH:
        layers = []
        for _ in range(n):
            layers.append({
                "w": ("uniform", (27, cin, cout), 1.0 / math.sqrt(27.0 * cin)),
                "bn_scale": ("const", (cout,), 1.0),
                "bn_bias": ("const", (cout,), 0.0)})
            cin = cout
        enc[name] = layers
    xyz_dim, view_dim = 3 * (1 + 2 * xyz_res), 3 * (1 + 2 * view_res)
    return {"vertex_code": ("normal", (nv, code_dim)),
            "frame_latent": ("normal", (n_frames, latent_dim)),
            "xyzc_net": enc,
            "fc_0": dense_spec(FEATURE_DIM, 256),
            "fc_1": dense_spec(256, 256), "fc_2": dense_spec(256, 256),
            # the density's bias lifted by 1: with torch's initialisation
            # alone many seeds give no density anywhere, a network with no
            # gradient and black views
            "alpha_fc": {"w": dense_spec(256, 1)["w"],
                         "b": ("uniform", (1,), 256 ** -0.5, 1.0)},
            "feature_fc": dense_spec(256, 256),
            "latent_fc": dense_spec(256 + latent_dim, 256),
            "view_fc": dense_spec(256 + view_dim + xyz_dim, 128),
            "rgb_fc": dense_spec(128, 3)}


# -- the posed body in voxels ----------

def active_pairs(coords, shape):
    """For the work counts of the convolutions: per layer of ARCH (in
    order), (active input voxels, active output voxels, active (output,
    tap) pairs). Computed densely from the vertices' voxels."""
    dev = "cpu"
    occ = torch.zeros((1, 1) + tuple(shape), device=dev)
    c = torch.as_tensor(coords, device=dev)
    occ[0, 0, c[:, 0], c[:, 1], c[:, 2]] = 1.0
    ones = torch.ones((1, 1, 3, 3, 3), device=dev)
    out = []
    for _, kind, n, _, _ in ARCH:
        for i in range(n):
            if kind == "down" and i == 0:
                nxt = F.max_pool3d(occ, 3, 2, 1)
                taps = F.conv3d(occ, ones, stride=2, padding=1) * nxt
            else:
                nxt = occ
                taps = F.conv3d(occ, ones, padding=1) * occ
            out.append((int(occ.sum()), int(nxt.sum()), int(taps.sum())))
            occ = nxt
    return out


# -- the network ----------

def encode(params, geo):
    """The four feature volumes [1, C, D_l, H_l, W_l] of one frame."""
    dev = params["vertex_code"].device
    shape = geo["shape"]
    c = torch.as_tensor(geo["coords"], device=dev)
    lin = (c[:, 0] * shape[1] + c[:, 1]) * shape[2] + c[:, 2]
    code = params["vertex_code"]
    x = torch.zeros((math.prod(shape), code.shape[1]), device=dev)
    x = x.index_add(0, lin, code).T.reshape((1, code.shape[1]) + shape)
    occ = torch.zeros((1, 1) + shape, device=dev)
    occ.view(-1)[lin] = 1.0
    vols = []
    for name, kind, n, _, _ in ARCH:
        for i, layer in enumerate(params["xyzc_net"][name]):
            w = layer["w"]
            w = w.permute(2, 1, 0).reshape(w.shape[2], w.shape[1], 3, 3, 3)
            if kind == "down" and i == 0:
                x = F.conv3d(x, w, stride=2, padding=1)
                occ = F.max_pool3d(occ, 3, 2, 1)
            else:
                x = F.conv3d(x, w, padding=1)
            n_act = occ.sum()
            mean = (x * occ).sum((0, 2, 3, 4), keepdim=True) / n_act
            var = (((x - mean) ** 2) * occ).sum((0, 2, 3, 4),
                                                keepdim=True) / n_act
            x = ((x - mean) * torch.rsqrt(var + BN_EPS)
                 * layer["bn_scale"].reshape(1, -1, 1, 1, 1)
                 + layer["bn_bias"].reshape(1, -1, 1, 1, 1))
            x = torch.relu(x) * occ
        if name in SCALES:
            vols.append(x)
    return vols


def _dense(layer, x):
    return x @ layer["w"] + layer["b"]


def decode(params, vols, geo, wpts, viewdir, latent_index, voxel_size):
    """Raw [N, 4] (rgb logits, density) at world points wpts [N, 3] seen
    along viewdir [N, 3]."""
    dev = wpts.device
    R = torch.as_tensor(geo["R"], device=dev)
    Th = torch.as_tensor(geo["Th"], device=dev)
    lo = torch.as_tensor(geo["bounds"][0], device=dev)
    ppts = (wpts - Th) @ R
    dhw = (ppts.flip(-1) - lo.flip(-1)) / torch.tensor(
        voxel_size, device=dev).flip(-1)
    grid = (dhw / torch.tensor(geo["shape"], device=dev) * 2.0 - 1.0).flip(-1)
    grid = grid.reshape(1, -1, 1, 1, 3)
    feat = torch.cat([F.grid_sample(v, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
                      .reshape(v.shape[1], -1).T for v in vols], dim=-1)
    net = torch.relu(_dense(params["fc_0"], feat))
    net = torch.relu(_dense(params["fc_1"], net))
    net = torch.relu(_dense(params["fc_2"], net))
    alpha = _dense(params["alpha_fc"], net)
    h = _dense(params["feature_fc"], net)
    lat = params["frame_latent"][latent_index].expand(h.shape[0], -1)
    h = _dense(params["latent_fc"], torch.cat([h, lat], dim=-1))
    h = torch.cat([h, positional_encoding(viewdir, 4),
                   positional_encoding(wpts, 10)], dim=-1)
    rgb = _dense(params["rgb_fc"], torch.relu(_dense(params["view_fc"], h)))
    return torch.cat([rgb, alpha], dim=-1)


def render(params, vols, geo, ray_o, ray_d, z, latent_index, voxel_size,
           chunk=2048):
    """rgb [R, 3] of rays (ray_o, ray_d [R, 3]) sampled at depths z [R, S],
    decoded `chunk` rays at a time."""
    out = []
    for r0 in range(0, ray_o.shape[0], chunk):
        ro, rd, zc = (t[r0:r0 + chunk] for t in (ray_o, ray_d, z))
        S = zc.shape[1]
        pts = (ro[:, None] + rd[:, None] * zc[..., None]).reshape(-1, 3)
        vd = rd / rd.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        raw = decode(params, vols, geo, pts, vd.repeat_interleave(S, 0),
                     latent_index, voxel_size)
        out.append(composite(raw.reshape(-1, S, 4), zc, rd)[0])
    return torch.cat(out)


def render_view(params, geo, ray_o, ray_d, near, far, n_samples,
                latent_index, voxel_size):
    """An evaluation render: the frame encoded once, n_samples evenly
    spaced depths a ray."""
    with torch.no_grad():
        vols = encode(params, geo)
        return render(params, vols, geo, ray_o, ray_d,
                      linspace_depths(near, far, n_samples), latent_index,
                      voxel_size)


def loss(params, steps, geos, config):
    """The training loss of one step: steps is a list of batch elements,
    each a dict with frame, latent_index, ray_o, ray_d, z [R, S], rgb,
    ray_mask; the mean squared error over every valid ray and channel."""
    voxel_size = config["voxel_size"]
    se, count = 0.0, 0.0
    for el in steps:
        geo = geos[el["frame"]]
        vols = encode(params, geo)
        rgb = render(params, vols, geo, el["ray_o"], el["ray_d"], el["z"],
                     el["latent_index"], voxel_size, chunk=el["z"].shape[0])
        m = el["ray_mask"][:, None]
        se = se + (((rgb - el["rgb"]) ** 2) * m).sum()
        count = count + m.sum() * 3
    return se / count.clamp(min=1.0)


def render_image(params, geo, frame, ray_o, ray_d, near, far, config):
    """A held-out view's rgb as the evaluation renders it."""
    return render_view(params, geo, ray_o, ray_d, near, far,
                       int(config["N_samples"]), frame,
                       config["voxel_size"])
