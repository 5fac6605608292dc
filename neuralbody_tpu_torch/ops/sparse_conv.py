"""Sparse 3D convolution: host rulebook (numpy) + device forward (torch).

Counterpart of neuralbody_tpu/ops/sparse_conv.py. The host half is a numpy
copy of the rulebook builder (active-site lists per level and gather tables
padded to static capacities); the device half runs the convolutions as a
row gather followed by a batched matmul over the 27 taps, plus the masked
BatchNorm over active sites.

Gather tables point missing/padded entries at row S (a zero row appended
to the features), so every index is in range by construction; nothing here
clamps an index.

The three convolutions are torch.autograd.Functions with the JAX package's
scatter-free backwards: every backward is a gather of the COTANGENT, never
a scatter-add and never a re-gather of the input x:
  subm:  dx = conv(gy) with the kernel tap-flipped and transposed
         (off_{26-k} = -off_k under the lexicographic enumeration);
         dW[k] = sum_q x[q] gy[nbr[q, 26-k]]^T reuses that gather of gy and
         flips the small [27, Cin, Cout] result.
  xtri:  one packed gather of gy serves dx and dW; the [9, Cin, 3Cout]
         result is laid out as [27, Cin, Cout] and flipped.
  down:  dx gathers gy through the host-built up table; dW reuses it
         (down_tbl[s, k] = q  <=>  up_tbl[q, k] = s).
The cotangent is cast to x's dtype before it is gathered and dx returns in
x's dtype, as the JAX backwards do.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

# 27 kernel taps in (kd, kh, kw) lexicographic order; tap k touches input
# coordinate  p + k - 1  (submanifold)  or  2p + k - 1  (stride-2, pad 1).
KERNEL_OFFSETS = np.array(
    list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.int32
)  # [27, 3]


# ---------------------------------------------------------------------------
# Host-side rulebook construction (numpy, vectorized)
# ---------------------------------------------------------------------------

def _hash_coords(coords: np.ndarray, sh) -> np.ndarray:
    return (coords[..., 0].astype(np.int64) * sh[1] + coords[..., 1]) * sh[2] \
        + coords[..., 2]


class _SiteLookup:
    """coord -> site-row index map via sorted linearized codes."""

    def __init__(self, sites: np.ndarray, sh):
        self.sh = np.asarray(sh, dtype=np.int64)
        codes = _hash_coords(sites, sh)
        self.order = np.argsort(codes)
        self.sorted_codes = codes[self.order]

    def __call__(self, query: np.ndarray) -> np.ndarray:
        """query: [..., 3] int coords -> row index into sites, or -1."""
        inb = np.all((query >= 0) & (query < self.sh), axis=-1)
        qc = _hash_coords(np.clip(query, 0, None), self.sh)
        pos = np.searchsorted(self.sorted_codes, qc)
        pos_c = np.minimum(pos, len(self.sorted_codes) - 1)
        found = inb & (self.sorted_codes[pos_c] == qc)
        return np.where(found, self.order[pos_c], -1).astype(np.int32)


def dedup_sites(coords: np.ndarray, sh) -> tuple[np.ndarray, np.ndarray]:
    """Unique voxel coords (sorted by linear code) + inverse map per input."""
    codes = _hash_coords(coords, sh)
    _, first, inverse = np.unique(codes, return_index=True, return_inverse=True)
    return coords[first].astype(np.int32), inverse.astype(np.int32)


def subm_table(sites: np.ndarray, lookup: _SiteLookup) -> np.ndarray:
    """[S, 27] gather table for a submanifold 3x3x3 conv (identity site set)."""
    query = sites[:, None, :] + KERNEL_OFFSETS[None]          # [S, 27, 3]
    return lookup(query)


def downsample_sites(sites: np.ndarray, sh) -> np.ndarray:
    """Output active sites of SparseConv3d(k=3, s=2, p=1) on `sites`.

    Input coord c feeds output p iff 2p = c + 1 - k for some k in {0,1,2}
    per dim, i.e. p in {(c-1)/2, c/2, (c+1)/2} ∩ Z, clipped to [0, sh/2).
    """
    out_sh = np.asarray(sh, dtype=np.int64) // 2
    cands = []
    for off in itertools.product((-1, 0, 1), repeat=3):
        c = sites + np.array(off, dtype=np.int32)
        ok = np.all(c % 2 == 0, axis=-1)
        p = c[ok] // 2
        p = p[np.all((p >= 0) & (p < out_sh), axis=-1)]
        cands.append(p)
    cands = np.concatenate(cands, axis=0)
    if len(cands) == 0:
        return np.zeros((0, 3), np.int32)
    out, _ = dedup_sites(cands, out_sh)
    return out


def down_table(out_sites: np.ndarray, in_lookup: _SiteLookup) -> np.ndarray:
    """[S_out, 27] gather table into the input level for the strided conv."""
    query = 2 * out_sites[:, None, :] + KERNEL_OFFSETS[None]
    return in_lookup(query)


def up_table(in_sites: np.ndarray, out_lookup: _SiteLookup) -> np.ndarray:
    """[S_in, 27] transpose table for the strided conv's backward.

    Entry (q, k) is the output site p with 2p + off_k = q (or -1).
    """
    num = in_sites[:, None, :] - KERNEL_OFFSETS[None]      # [S, 27, 3]
    even = np.all(num % 2 == 0, axis=-1)
    p = num // 2
    idx = out_lookup(p)
    return np.where(even, idx, -1).astype(np.int32)


def xtri_aug_tables(nbr: np.ndarray, cap: int, fix_cap: int) -> dict:
    """w-triple packing tables from a [S, 27] subm table (-1 = missing).

    The packed conv gathers ONE row per (dd, dh) column instead of three:
    xtri[q] = [x[w-left(q)] | x[q] | x[w-right(q)]]. Columns whose center
    (dd, dh, 0) neighbor is missing but a (dd, dh, +-1) neighbor exists
    read an AUGMENTED row [x[augl] | 0 | x[augr]] appended to the xtri
    table.

    Returns (sentinels noted):
      lnbr/rnbr [cap]    w-neighbor rows (cap = zero row of xpad)
      nbr9 [9, cap]      xtri-row index per column (cap+fix_cap = zero row)
      augl/augr [fix_cap] aug-row sources (cap = zero row of xpad)
      n_aug []           actual aug rows used
    """
    S = nbr.shape[0]
    lnbr = np.where(nbr[:, 12] < 0, cap, nbr[:, 12]).astype(np.int32)
    rnbr = np.where(nbr[:, 14] < 0, cap, nbr[:, 14]).astype(np.int32)

    sent9 = cap + fix_cap
    nbr9 = np.full((9, cap), sent9, np.int32)
    augl = np.full((fix_cap,), cap, np.int32)
    augr = np.full((fix_cap,), cap, np.int32)
    n_aug = 0
    for t in range(9):
        center = nbr[:, t * 3 + 1]
        left = nbr[:, t * 3]
        right = nbr[:, t * 3 + 2]
        col = np.where(center < 0, sent9, center).astype(np.int32)
        fix = (center < 0) & ((left >= 0) | (right >= 0))
        idx = np.flatnonzero(fix)
        if len(idx):
            if n_aug + len(idx) > fix_cap:
                raise ValueError(
                    f"xtri aug overflow: needs >{fix_cap} rows; raise "
                    f"the sequence fix caps (compute_fix_caps)")
            rows = cap + n_aug + np.arange(len(idx), dtype=np.int32)
            col[idx] = rows
            augl[n_aug:n_aug + len(idx)] = np.where(
                left[idx] < 0, cap, left[idx])
            augr[n_aug:n_aug + len(idx)] = np.where(
                right[idx] < 0, cap, right[idx])
            n_aug += len(idx)
        nbr9[t, :S] = col
    return {"lnbr": _pad_rows(lnbr, cap, cap), "rnbr": _pad_rows(rnbr, cap, cap),
            "nbr9": nbr9, "augl": augl, "augr": augr,
            "n_aug": np.int32(n_aug)}


def compute_fix_caps(frames_coords, out_sh, site_caps,
                     round_to: int = 64) -> list[int]:
    """Max per-level xtri aug-row counts over frames (static capacities)."""
    out_sh = np.asarray(out_sh, dtype=np.int64)
    caps = [0] * 5
    for coords in frames_coords:
        sites, _ = dedup_sites(coords.astype(np.int32), out_sh)
        sh = out_sh.copy()
        for lvl in range(5):
            nbr = subm_table(sites, _SiteLookup(sites, sh))
            center = nbr[:, 1::3]
            side = (nbr[:, 0::3] >= 0) | (nbr[:, 2::3] >= 0)
            caps[lvl] = max(caps[lvl], int(((center < 0) & side).sum()))
            if lvl < 4:
                sites = downsample_sites(sites, sh)
                sh = sh // 2
    return [max(round_to, -(-c // round_to) * round_to) for c in caps]


def _pad_rows(a: np.ndarray, cap: int, fill) -> np.ndarray:
    if len(a) > cap:
        raise ValueError(
            f"site count {len(a)} exceeds static capacity {cap}; raise "
            f"the sequence site caps")
    pad = np.full((cap - len(a),) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def measure_site_counts(vertex_coords: np.ndarray, out_sh) -> list[int]:
    """Actual per-level active-site counts for one frame (for cap sizing)."""
    out_sh = np.asarray(out_sh, dtype=np.int64)
    sites, _ = dedup_sites(vertex_coords.astype(np.int32), out_sh)
    counts = []
    sh = out_sh.copy()
    for lvl in range(5):
        counts.append(len(sites))
        if lvl < 4:
            sites = downsample_sites(sites, sh)
            sh = sh // 2
    return counts


def compute_site_caps(frames_coords, out_sh, round_to: int = 256) -> list[int]:
    """Max per-level site counts over frames, rounded up (static capacities)."""
    caps = [0] * 5
    for coords in frames_coords:
        for l, c in enumerate(measure_site_counts(coords, out_sh)):
            caps[l] = max(caps[l], c)
    return [max(round_to, -(-c // round_to) * round_to) for c in caps]


def build_frame_geometry(vertex_coords: np.ndarray, out_sh, site_caps,
                         fix_caps=None):
    """Build all static-shape index tables for one frame.

    Args:
      vertex_coords: [nv, 3] int voxel coords (dhw) of the SMPL vertices.
      out_sh: static full-resolution grid shape (dhw), multiple of 32.
      site_caps: list of 5 static per-level site capacities.

    Returns:
      dict of int32 numpy arrays:
        vert_idx   [nv]        vertex -> level-0 site row
        sites{l}   [S_l, 3]    site coords (padding 2**30)
        nbr{l}     [27, S_l]   submanifold gather tables (tap-major)
        x*{l}                  w-triple packed tables (xtri_aug_tables)
        down{l}    [27, S_{l+1}] strided-conv gather tables, l in 0..3
        up{l}      [27, S_l]   transpose tables for the strided backward
        nsite{l}   []          actual site count per level
        ivol{l}    [D_l, H_l, W_l] site-index volumes, l in 1..4
        rowcum{l}  [D_l*H_l + 1]   per-(d, h) slice row offsets, l in 1..4
      Missing/padded gather entries point at row S_l (a zero row appended on
      device).
    """
    out_sh = np.asarray(out_sh, dtype=np.int64)
    geom = {}

    sites, inverse = dedup_sites(vertex_coords.astype(np.int32), out_sh)
    sh = out_sh.copy()
    for lvl in range(5):
        cap = site_caps[lvl]
        lookup = _SiteLookup(sites, sh)
        if lvl == 0:
            geom["vert_idx"] = np.where(
                inverse >= 0, inverse, cap
            ).astype(np.int32)
        nbr_raw = subm_table(sites, lookup)          # [S, 27], -1 missing
        if fix_caps is None:
            center = nbr_raw[:, 1::3]
            side = (nbr_raw[:, 0::3] >= 0) | (nbr_raw[:, 2::3] >= 0)
            fcap = max(64, -(-int(((center < 0) & side).sum()) // 64) * 64)
        else:
            fcap = fix_caps[lvl]
        for n, v in xtri_aug_tables(nbr_raw, cap, fcap).items():
            geom[f"x{n}{lvl}"] = v
        nbr = np.where(nbr_raw < 0, cap, nbr_raw)
        geom[f"nbr{lvl}"] = np.ascontiguousarray(_pad_rows(nbr, cap, cap).T)
        geom[f"nsite{lvl}"] = np.int32(len(sites))
        geom[f"sites{lvl}"] = _pad_rows(
            sites, cap, np.int32(2 ** 30)
        )
        if lvl >= 1:
            ivol = np.full(tuple(sh), cap, np.int32)
            ivol[sites[:, 0], sites[:, 1], sites[:, 2]] = np.arange(
                len(sites), dtype=np.int32)
            geom[f"ivol{lvl}"] = ivol
            Dl, Hl = int(sh[0]), int(sh[1])
            cnt = np.bincount(sites[:, 0].astype(np.int64) * Hl
                              + sites[:, 1], minlength=Dl * Hl)
            geom[f"rowcum{lvl}"] = np.concatenate(
                [[0], np.cumsum(cnt)]).astype(np.int32)

        if lvl < 4:
            nxt = downsample_sites(sites, sh)
            dtab = down_table(nxt, lookup)
            dtab = np.where(dtab < 0, cap, dtab)
            geom[f"down{lvl}"] = np.ascontiguousarray(
                _pad_rows(dtab, site_caps[lvl + 1], cap).T)
            out_lookup = _SiteLookup(nxt, sh // 2)
            utab = up_table(sites, out_lookup)
            cap_out = site_caps[lvl + 1]
            utab = np.where(utab < 0, cap_out, utab)
            geom[f"up{lvl}"] = np.ascontiguousarray(
                _pad_rows(utab, cap, cap_out).T)
            sites = nxt
            sh = sh // 2

    return geom


# ---------------------------------------------------------------------------
# Device-side compute (torch)
# ---------------------------------------------------------------------------

def site_mask(nsite, cap):
    """[cap] (or [B, cap] for nsite [B]) f32 validity mask from site
    counts."""
    ar = torch.arange(cap, device=nsite.device)
    return (ar < nsite[..., None]).float()


def scatter_vertex_codes(codes, vert_idx, cap):
    """Sum per-vertex codes into their level-0 site rows.

    codes: [nv, C]; vert_idx: [nv] or [B, nv] (rows in [0, cap], cap =
    dump row). Duplicate-voxel vertices are sum-combined. On CUDA,
    index_add_ sums with atomics whose order changes from run to run, so
    a site with duplicate vertices is reproducible only to f32 rounding.
    """
    C = codes.shape[-1]
    if vert_idx.dim() == 1:
        out = torch.zeros((cap + 1, C), dtype=codes.dtype, device=codes.device)
        out.index_add_(0, vert_idx.long(), codes)
        return out[:cap]
    B, nv = vert_idx.shape
    offs = (torch.arange(B, device=vert_idx.device) * (cap + 1))[:, None]
    flat_idx = (vert_idx.long() + offs).reshape(-1)
    out = torch.zeros((B * (cap + 1), C), dtype=codes.dtype,
                      device=codes.device)
    out.index_add_(0, flat_idx,
                   codes.expand(B, nv, C).reshape(B * nv, C))
    return out.reshape(B, cap + 1, C)[:, :cap]


def _rows(table, feats_flat):
    """Row gather feats_flat[table] for any table shape."""
    idx = table.reshape(-1).long()
    return torch.index_select(feats_flat, 0, idx).reshape(
        *table.shape, feats_flat.shape[-1])


def _batch_rows(table, n_rows):
    """Add per-batch row offsets for flattened batched gathers."""
    B = table.shape[0]
    offs = torch.arange(B, device=table.device, dtype=torch.int64) * n_rows
    return table.long() + offs.reshape((B,) + (1,) * (table.dim() - 1))


def gather_taps(feats, table):
    """feats [S, C] or [B, S, C] (+ implicit zero row per batch) gathered
    by TAP-MAJOR table [27, S_out] / [B, 27, S_out].

    Returns [27, S_out, C] / [B, 27, S_out, C]. Index S (== len(feats))
    reads the zero row.
    """
    if feats.dim() == 2:
        fpad = torch.cat([feats, torch.zeros_like(feats[:1])], dim=0)
        return _rows(table, fpad)
    B, S, C = feats.shape
    fpad = torch.cat([feats, feats.new_zeros((B, 1, C))], dim=1)
    return _rows(_batch_rows(table, S + 1), fpad.reshape(B * (S + 1), C))


def sparse_conv_matmul(gathered, w):
    """[(B,) 27, S, Cin] x [27, Cin, Cout] -> [(B,) S, Cout] (f32).

    Batched matmul over the tap axis, then a tap-sum. The operands are
    rounded to the activations' dtype and multiplied in f32: a bf16 value is
    exact in f32, and so is the product of two, so with f32 accumulation
    this is the TPU's bf16 x bf16 -> f32 contraction.
    """
    w = w.to(gathered.dtype).float()
    gathered = gathered.float()
    if gathered.dim() == 3:
        return torch.bmm(gathered, w).sum(0)
    return torch.einsum("bksc,kcd->bksd", gathered, w).sum(1)


def _weight_grad(x, gathered):
    """x [(B,) S, Cin] against the gathered cotangent [(B,) K, S, E] summed
    over sites (and batch) -> [K, Cin, E] in f32 (bf16 values are exact in
    f32, so this is the bf16 x bf16 -> f32 contraction)."""
    spec = "sc,kse->kce" if x.dim() == 2 else "bsc,bkse->kce"
    return torch.einsum(spec, x.float(), gathered.float())


class _SubmConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, nbr):
        ctx.save_for_backward(x, w, nbr)
        return sparse_conv_matmul(gather_taps(x, nbr), w)

    @staticmethod
    def backward(ctx, gy):
        x, w, nbr = ctx.saved_tensors
        gyg = gather_taps(gy.to(x.dtype), nbr)          # [(B,) 27, S, Cout]
        w_t = torch.flip(w, (0,)).transpose(1, 2)       # [27, Cout, Cin]
        dx = sparse_conv_matmul(gyg, w_t).to(x.dtype)
        dw = torch.flip(_weight_grad(x, gyg), (0,))
        return dx, dw.to(w.dtype), None


def subm_conv(x, w, nbr):
    """Submanifold conv: x [(B,) S, Cin], w [27, Cin, Cout],
    nbr [(B,) 27, S]."""
    return _SubmConv.apply(x, w, nbr)


def xtri_gather(x, lnbr, rnbr, nbr9, augl, augr):
    """Packed neighborhood gather.

    x [(B,) cap, C]; lnbr/rnbr [(B,) cap]; nbr9 [(B,) 9, cap];
    augl/augr [(B,) F]. Returns [(B,) 9, cap, 3C] where slot j of column t
    holds x at offset (dd_t, dh_t, j-1) — fixup rows included.
    """
    if x.dim() == 2:
        cap, C = x.shape
        xpad = torch.cat([x, x.new_zeros((1, C))])
        base = torch.cat([_rows(lnbr, xpad), x, _rows(rnbr, xpad)], dim=-1)
        al = _rows(augl, xpad)
        aug = torch.cat([al, torch.zeros_like(al), _rows(augr, xpad)], dim=-1)
        tri = torch.cat([base, aug, x.new_zeros((1, 3 * C))], dim=0)
        return _rows(nbr9, tri)
    B, cap, C = x.shape
    xpad = torch.cat([x, x.new_zeros((B, 1, C))], dim=1)
    flat = xpad.reshape(B * (cap + 1), C)
    xl = _rows(_batch_rows(lnbr, cap + 1), flat)
    xr = _rows(_batch_rows(rnbr, cap + 1), flat)
    base = torch.cat([xl, x, xr], dim=-1)                  # [B, cap, 3C]
    al = _rows(_batch_rows(augl, cap + 1), flat)
    ar = _rows(_batch_rows(augr, cap + 1), flat)
    aug = torch.cat([al, torch.zeros_like(al), ar], dim=-1)
    F = augl.shape[-1]
    tri = torch.cat([base, aug, x.new_zeros((B, 1, 3 * C))], dim=1)
    tri_flat = tri.reshape(B * (cap + F + 1), 3 * C)
    return _rows(_batch_rows(nbr9, cap + F + 1), tri_flat)  # [B, 9, cap, 3C]


def xtri_matmul(g9, w):
    """[(B,) 9, S, 3Cin] x w [27, Cin, Cout] -> [(B,) S, Cout] (f32).

    w reshaped to [9, 3Cin, Cout] matches the packed slot order (taps are
    (dd, dh, dw) lexicographic with dw fastest, KERNEL_OFFSETS)."""
    cin, cout = w.shape[1], w.shape[2]
    # operands rounded to g9's dtype, multiplied in f32 (sparse_conv_matmul)
    w9 = w.reshape(9, 3 * cin, cout).to(g9.dtype).float()
    g9 = g9.float()
    if g9.dim() == 3:
        return torch.bmm(g9, w9).sum(0)
    return torch.einsum("bkse,ked->bksd", g9, w9).sum(1)


class _SubmConvXtri(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, lnbr, rnbr, nbr9, augl, augr):
        ctx.save_for_backward(x, w, lnbr, rnbr, nbr9, augl, augr)
        return xtri_matmul(xtri_gather(x, lnbr, rnbr, nbr9, augl, augr), w)

    @staticmethod
    def backward(ctx, gy):
        x, w, *tabs = ctx.saved_tensors
        gyg9 = xtri_gather(gy.to(x.dtype), *tabs)       # [(B,) 9, S, 3Cout]
        w_t = torch.flip(w, (0,)).transpose(1, 2)       # [27, Cout, Cin]
        dx = xtri_matmul(gyg9, w_t).to(x.dtype)
        cin, cout = w.shape[1], w.shape[2]
        d = _weight_grad(x, gyg9)                # [9, Cin, 3Cout]
        d27 = d.reshape(9, cin, 3, cout).transpose(1, 2).reshape(
            27, cin, cout)
        dw = torch.flip(d27, (0,)).to(w.dtype)
        return dx, dw, None, None, None, None, None


def subm_conv_xtri(x, w, lnbr, rnbr, nbr9, augl, augr):
    """Packed submanifold conv: x [(B,) cap, Cin] -> [(B,) cap, Cout]."""
    return _SubmConvXtri.apply(x, w, lnbr, rnbr, nbr9, augl, augr)


class _DownConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, down_tbl, up_tbl):
        ctx.save_for_backward(x, w, up_tbl)
        return sparse_conv_matmul(gather_taps(x, down_tbl), w)

    @staticmethod
    def backward(ctx, gy):
        x, w, up_tbl = ctx.saved_tensors
        gup = gather_taps(gy.to(x.dtype), up_tbl)       # [(B,) 27, S_in, Cout]
        dx = sparse_conv_matmul(gup, w.transpose(1, 2)).to(x.dtype)
        dw = _weight_grad(x, gup)
        return dx, dw.to(w.dtype), None, None


def down_conv(x, w, down_tbl, up_tbl):
    """Stride-2 conv: x [(B,) S_in, Cin] -> [(B,) S_out, Cout]; tables
    down [(B,) 27, S_out] (forward gather) and up [(B,) 27, S_in] (its
    transpose, for the backward)."""
    return _DownConv.apply(x, w, down_tbl, up_tbl)


def masked_batch_norm(x, mask, scale, bias, eps=1e-3):
    """BatchNorm over active sites only.

    x: [..., S, C]; mask: [..., S]. Statistics are over all leading dims and
    S, weighted by mask. Returns normalized x (zeroed at padded rows) plus
    batch (mean, var), where the returned var is UNBIASED (n/(n-1)) to match
    what torch BatchNorm1d stores in running_var — normalization itself
    uses the biased var.
    """
    m = mask[..., None]
    dims = tuple(range(x.dim() - 1))
    n = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum(dim=dims) / n
    var = (((x - mean) ** 2) * m).sum(dim=dims) / n
    y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    return y * m, (mean, var * (n / torch.clamp(n - 1.0, min=1.0)))
