"""What the plain references share: the weights drawn from the seed, the
positional encoding, NeRF's quadrature and importance sampling, the rays of
a held-out view, Adam with a value clip, and the precision switch.

Plain PyTorch and numpy. Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch


# -- precision ----------

@contextlib.contextmanager
def precision(tf32):
    """float32 matmuls and convolutions in full f32 (tf32=False, the
    reference) or on the TF32 tensor cores (tf32=True, the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# -- weights ----------

def make_weights(spec, seed, device):
    """A parameter tree from a spec tree of leaves ("uniform", shape,
    bound[, offset]), ("normal", shape) or ("const", shape, value): the
    uniform leaves are cut from one draw of U(-1, 1) and the normal leaves
    from one draw of N(0, 1), both from a torch.Generator on `device`
    seeded with `seed`, in the spec's leaf order."""
    leaves = list(iter_leaves(spec))
    n_u = sum(math.prod(s[1]) for _, s in leaves if s[0] == "uniform")
    n_n = sum(math.prod(s[1]) for _, s in leaves if s[0] == "normal")
    gen = torch.Generator(device).manual_seed(seed)
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    at = {"uniform": 0, "normal": 0}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        kind, shape = node[0], node[1]
        if kind == "const":
            return torch.full(shape, float(node[2]), device=device)
        n = math.prod(shape)
        src = uni if kind == "uniform" else nor
        out = src[at[kind]:at[kind] + n].reshape(shape).clone()
        at[kind] += n
        if kind == "normal":
            return out
        return out * node[2] + (node[3] if len(node) > 3 else 0.0)

    return build(spec)


def iter_leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from iter_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, path + (i,))
    else:
        yield path, tree


def dense_spec(cin, cout):
    """torch.nn.Linear's initialisation: U(+-1/sqrt(cin)) weight and bias."""
    b = 1.0 / math.sqrt(cin)
    return {"w": ("uniform", (cin, cout), b), "b": ("uniform", (cout,), b)}


# -- network pieces ----------

def positional_encoding(x, n_freqs):
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...]: NeRF's embedder."""
    out = [x]
    for i in range(n_freqs):
        out += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(out, dim=-1)


def composite(raw, z, rays_d):
    """NeRF's quadrature of raw [R, S, 4] (rgb logits, density) at depths
    z [R, S]: (rgb [R, 3], weights [R, S])."""
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * rays_d.norm(dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1)[:, :-1]
    weights = alpha * trans
    rgb = (weights[..., None] * torch.sigmoid(raw[..., :3])).sum(1)
    return rgb, weights


def linspace_depths(near, far, n):
    """Evenly spaced depths from near to far [R] -> [R, n]."""
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    return near[:, None] * (1.0 - t) + far[:, None] * t


def importance_depths(bins, weights, n, u=None):
    """Inverse-CDF samples of the piecewise-constant density with weights
    [R, B-1] over bins [R, B] at the CDF values u [R, n] (default
    deterministic: linspace(0, 1, n))."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(
            bins.shape[0], n).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = (idx - 1).clamp(min=0)
    hi = idx.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b0, b1 = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


# -- the rays of a view ----------

def rodrigues(rvec):
    """Axis-angle [3] -> rotation matrix [3, 3] (float64)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.cos(th) * np.eye(3) + (1 - np.cos(th)) * np.outer(k, k)
            + np.sin(th) * kx)


def pad_bounds(xyz, pad=0.05):
    """The body's box with 5 cm of room along z (ZJU-MoCap's)."""
    mn, mx = xyz.min(0).copy(), xyz.max(0).copy()
    mn[2] -= pad
    mx[2] += pad
    return np.stack([mn, mx]).astype(np.float32)


def view_rays(K, R, T, H, W, box):
    """The pixels of an H x W view whose rays cross the world box:
    (ray_o [N, 3], ray_d [N, 3], near [N], far [N], hit [H*W]) in f32,
    pixels in row-major order, near and far in units of |ray_d|."""
    center = -R.T @ T.reshape(3)
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    pix = np.stack([i, j, np.ones_like(i)], axis=2)
    dirs = (pix @ np.linalg.inv(K).T - T.reshape(3)) @ R - center
    rd = dirs.reshape(-1, 3).astype(np.float32)
    ro = np.broadcast_to(center.astype(np.float32), rd.shape)
    near, far, hit = near_far(box, ro, rd)
    return np.ascontiguousarray(ro[hit]), rd[hit], near, far, hit


def view_cameras(root, ratio):
    """The sequence's cameras at the image scale `ratio`: (K [C, 3, 3], R
    [C, 3, 3], T [C, 3] in metres, centre [C, 3]) in float64, and the
    image paths ims[frame][camera] relative to root."""
    ann = np.load(os.path.join(root, "annots.npy"), allow_pickle=True).item()
    cams = ann["cams"]
    K = np.array(cams["K"], np.float64)
    K[:, :2] *= ratio
    R = np.array(cams["R"], np.float64)
    T = np.array(cams["T"], np.float64).reshape(-1, 3) / 1000.0
    centre = -np.einsum("cji,cj->ci", R, T)
    return (K, R, T, centre), [f["ims"] for f in ann["ims"]]


def target_image(root, rel, ratio):
    """A view's training targets as ZJU-MoCap's recipe makes them from the
    raw files: the JPEG decoded to RGB in [0, 1], scaled down by the whole
    factor 1 / ratio with each output pixel the mean of its block, and the
    pixels beyond the mask's 5 x 5 dilation (its boundary band kept) set to
    0 -> [H, W, 3] float32."""
    import cv2
    img = cv2.imread(os.path.join(root, rel), cv2.IMREAD_COLOR)
    msk = cv2.imread(os.path.join(root, "mask_cihp", rel)[:-4] + ".png",
                     cv2.IMREAD_UNCHANGED)
    f = int(round(1.0 / ratio))
    h, w = img.shape[0] // f, img.shape[1] // f
    rgb = img[..., ::-1].astype(np.float32) / 255.0
    rgb = rgb[:h * f, :w * f].reshape(h, f, w, f, 3).mean((1, 3))
    m = np.pad(msk != 0, 2)
    band = np.zeros(msk.shape, bool)
    for dy in range(5):
        for dx in range(5):
            band |= m[dy:dy + msk.shape[0], dx:dx + msk.shape[1]]
    rgb[~band[::f, ::f][:h, :w]] = 0.0
    return rgb.astype(np.float32)


def pixels_of_rays(cams, ro, rd):
    """Where rays of one image (ro, rd [N, 3]) come from and pass through:
    (camera index, whose centre is nearest the first origin; the largest
    distance of an origin from that centre; the pixel columns and rows
    [N] that the rays meet, as floats: whole numbers for rays through
    pixel centres)."""
    K, R, T, centre = cams
    ro, rd = ro.astype(np.float64), rd.astype(np.float64)
    c = int(np.argmin(np.linalg.norm(centre - ro[:1], axis=1)))
    off = float(np.linalg.norm(ro - centre[c], axis=1).max())
    x = (ro + rd) @ R[c].T + T[c]
    uv = x @ K[c].T
    return c, off, uv[:, 0] / uv[:, 2], uv[:, 1] / uv[:, 2]


def near_far(box, ro, rd):
    """Where rays from one origin (ro [N, 3], rd [N, 3]) enter and leave
    the box, in units of |rd|, for the rays that cross it: (near, far,
    hit [N])."""
    norm = np.linalg.norm(rd, axis=-1, keepdims=True)
    v = rd / norm
    v[(v < 1e-5) & (v > -1e-10)] = 1e-5
    v[(v > -1e-5) & (v < 1e-10)] = -1e-5
    t0 = (box[:1] - ro[:1]) / v
    t1 = (box[1:2] - ro[:1]) / v
    near = np.minimum(t0, t1).max(-1)
    far = np.maximum(t0, t1).min(-1)
    hit = near < far
    return ((near[hit] / norm[hit, 0]).astype(np.float32),
            (far[hit] / norm[hit, 0]).astype(np.float32), hit)


# -- the posed body ----------

def frame_geometry(root, frame, voxel_size):
    """One frame of the sequence at `root`: its SMPL-frame rotation R and
    translation Th, the world box (box, where rays start and end), the
    SMPL-frame box (bounds) and the vertices' voxel coordinates (dhw, the
    box's corner at 0) with the grid shape they need (a multiple of 32
    above the box)."""
    wxyz = np.load(os.path.join(root, "vertices", f"{frame}.npy")).astype(
        np.float32)
    p = np.load(os.path.join(root, "params", f"{frame}.npy"),
                allow_pickle=True).item()
    R = rodrigues(p["Rh"]).astype(np.float32)
    Th = np.asarray(p["Th"], np.float32).reshape(1, 3)
    sxyz = (wxyz - Th) @ R
    bounds = pad_bounds(sxyz)
    dhw = sxyz[:, [2, 1, 0]]
    lo, hi = bounds[0][[2, 1, 0]], bounds[1][[2, 1, 0]]
    vs = np.asarray(voxel_size)
    coords = np.round((dhw - lo) / vs).astype(np.int64)
    shape = (np.ceil((hi - lo) / vs).astype(np.int64) | 31) + 1
    return {"R": R, "Th": Th, "box": pad_bounds(wxyz), "bounds": bounds,
            "coords": coords, "shape": shape}


def sequence_geometry(root, frames, voxel_size):
    """frame_geometry of each frame, every grid at the largest shape."""
    geo = {f: frame_geometry(root, f, voxel_size) for f in frames}
    shape = np.max([g["shape"] for g in geo.values()], axis=0)
    for g in geo.values():
        g["shape"] = tuple(int(s) for s in shape)
    return geo



# -- the optimizer ----------

class Adam:
    """Value clip, then Adam (b1 0.9, b2 0.999, eps 1e-8), on a list of
    tensors updated in place."""

    def __init__(self, params, lr, clip=40.0, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.clip = params, lr, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Returns the clipped gradients, as the moments take them."""
        self.t += 1
        lr = self.lr(self.t - 1)
        out = []
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g.clamp(-self.clip, self.clip)
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            mh = m / (1.0 - self.b1 ** self.t)
            vh = v / (1.0 - self.b2 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + self.eps))
            out.append(g)
        return out
