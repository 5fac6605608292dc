"""Grouped hat-basis trilinear interpolation: host planner + device side.

Counterpart of neuralbody_tpu/ops/hat_interp.py. Trilinear interpolation
with zeros padding equals an evaluation of the hat (tent) basis anchored at
the occupied cells:

    out[p] = sum_over_sites  prod_axis max(0, 1 - |pos(p) - coord(site)|)
             * feats[site]

The HOST (numpy) samples depths, sorts ray samples into spatial groups and
emits, per (level, group), the site rows whose hat support can touch the
group as compact (start, cumulative-length) segments. The DEVICE expands
the segments, contracts each group against its rows (ops/hat_kernel.py)
and de-sorts with the inverse permutation. The gradient reaches the site
features through one autograd Function around the four levels, whose
backward is the hat kernel's backward (the JAX package's custom VJP,
neuralbody_tpu/ops/pallas_hat.py).

Once the static sizes are known the host half plans in C++
(ops/hat_planner_native.py); the first batches, which derive those sizes,
and a batch that overflows them (for numpy's error message) plan in numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.platform import constant
from .hat_kernel import hat_interp_level, hat_interp_level_bwd, sort_rows

# ---------------------------------------------------------------------------
# host: planning (numpy; steady-state path dispatches to the C++ planner)
# ---------------------------------------------------------------------------


def stratified_z_np(near, far, n_samples, rng=None):
    """Host-side stratified depth sampling.

    near/far: [R]. Returns z_vals [R, S] float32. rng=None -> midpoints
    (deterministic eval, perturb off).
    """
    t = np.linspace(0.0, 1.0, n_samples, dtype=np.float32)
    z = near[:, None] * (1.0 - t) + far[:, None] * t
    if rng is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = np.concatenate([mids, z[:, -1:]], axis=1)
        lower = np.concatenate([z[:, :1], mids], axis=1)
        z = lower + (upper - lower) * rng.uniform(
            size=z.shape).astype(np.float32)
    return z.astype(np.float32)


def _level_scale(out_sh, lvl):
    """(size_l - 1) / out_sh per axis — the reference normalization chain
    (divide by out_sh, NOT out_sh-1) composed with align_corners
    unnormalization at the level grid."""
    sh_l = np.array([s // (2 ** lvl) for s in out_sh], np.float64)
    return ((sh_l - 1.0) / np.asarray(out_sh, np.float64)).astype(np.float32)


def plan_hat_groups(dhw_pts, geom, out_sh, site_caps, group_size=128,
                    tile=(4, 8), rows_caps=None, n_groups=None,
                    seg_caps=None, levels=(1, 2, 3, 4)):
    """Bucket points into spatial tiles, chunk each tile into point groups,
    and build per-(level, group) site-row SEGMENTS.

    Tiles are fixed (d, h) (or (d, h, w)) rectangles of level-1 cells;
    groups never straddle a tile, so every group's row list is bounded by
    the tile footprint + 1-cell hat halo.

    Args:
      dhw_pts: [N, 3] float32 continuous full-res voxel coords of all ray
        samples (SMPL frame).
      geom: single-frame geometry dict (numpy; sites{l}, nsite{l}).
      out_sh: full-res grid shape (tuple of 3).
      site_caps: per-level static site capacities.
      group_size: points per group (P); tiles are padded to multiples of P
        with repeats of an in-tile point (first occurrence wins on de-sort).
      tile: (d, h) or (d, h, w) tile extent in level-1 cells.
      rows_caps / n_groups / seg_caps: static sizes, or None to derive.

    Returns dict:
      perm        [n_groups*P]       sorted-point -> original index
      seg_a{l}    [ngrp, segcap_l]   segment start rows (padding 0)
      seg_cum{l}  [ngrp, segcap_l]   inclusive cumulative segment lengths
      rows_caps, seg_caps, n_groups  the static sizes used
    """
    if (rows_caps is not None and n_groups is not None
            and seg_caps is not None and tuple(levels) == (1, 2, 3, 4)):
        # the C++ planner, built at first use. A failed build raises with
        # the compiler's message: the numpy planner takes about ten times
        # as long a batch, and a run on it would silently be another system
        # (the JAX package warns and falls back)
        from . import hat_planner_native
        plan = hat_planner_native.plan_hat_segments_native(
            dhw_pts, geom, out_sh, site_caps, group_size, tile,
            rows_caps, seg_caps, n_groups)
        if plan is not None:
            return plan
        # overflow: fall through to numpy for the informative error

    P = group_size
    s1 = _level_scale(out_sh, 1)
    pos1 = dhw_pts * s1
    D1, H1, W1 = (s // 2 for s in out_sh)
    dc = np.clip(np.floor(pos1[:, 0]).astype(np.int64), 0, D1 - 1)
    hc = np.clip(np.floor(pos1[:, 1]).astype(np.int64), 0, H1 - 1)
    n_th = -(-H1 // tile[1])
    tile_id = (dc // tile[0]) * n_th + hc // tile[1]
    if len(tile) > 2:
        wc = np.clip(np.floor(pos1[:, 2]).astype(np.int64), 0, W1 - 1)
        n_tw = -(-W1 // tile[2])
        tile_id = tile_id * n_tw + wc // tile[2]

    order = np.argsort(tile_id, kind="stable").astype(np.int32)
    tids = tile_id[order]
    starts = np.flatnonzero(np.r_[True, tids[1:] != tids[:-1]])
    counts = np.diff(np.r_[starts, len(tids)])
    # pad each tile's chunk to a multiple of P with repeats of its first point
    padded = -(-counts // P) * P
    total = int(padded.sum())
    pos = np.arange(total, dtype=np.int64)
    tile_of = np.repeat(np.arange(len(counts)), padded)
    rel = pos - np.repeat(np.cumsum(padded) - padded, padded)
    src = np.where(rel < counts[tile_of], rel, 0)
    perm = (order[starts[tile_of] + src].astype(np.int32) if total
            else np.zeros((0,), np.int32))
    used_groups = len(perm) // P
    if n_groups is None:
        n_groups = used_groups
    if used_groups > n_groups:
        raise ValueError(
            f"hat group overflow: batch needs {used_groups} groups but the "
            f"static count is {n_groups}")
    # inert padding groups: repeat point 0, zero-length segment lists
    perm = np.concatenate(
        [perm, np.zeros(((n_groups - used_groups) * P,), np.int32)])

    ngrp = n_groups
    sorted_dhw = dhw_pts[perm]                       # [ngrp*P, 3]
    grp_dhw = sorted_dhw.reshape(ngrp, P, 3)
    g_min = grp_dhw.min(axis=1)                      # [ngrp, 3]
    g_max = grp_dhw.max(axis=1)

    out = {"perm": perm}
    used_caps, used_seg_caps = [], []
    for li, lvl in enumerate(levels):
        sl = _level_scale(out_sh, lvl)
        sh_l = tuple(s // (2 ** lvl) for s in out_sh)
        Dl, Hl, Wl = sh_l
        # touched corner cells per group: [floor(min), floor(max)+1]
        lo = np.floor(g_min * sl).astype(np.int64)            # [ngrp, 3]
        hi = np.floor(g_max * sl).astype(np.int64) + 1
        d_lo = np.clip(lo[:, 0], 0, Dl - 1)
        d_hi = np.clip(hi[:, 0], 0, Dl - 1)
        h_lo = np.clip(lo[:, 1], 0, Hl - 1)
        h_hi = np.clip(hi[:, 1], 0, Hl - 1)

        ns = int(geom[f"nsite{lvl}"])
        sites = geom[f"sites{lvl}"][:ns].astype(np.int64)     # sorted by code
        key = (sites[:, 0] * Hl + sites[:, 1]) * Wl + sites[:, 2]

        # 2D tiles -> one (d, h-range, all-w) segment per d-slice; 3D tiles
        # -> one (d, h, w-range) segment per (d, h) pair
        nd = int((d_hi - d_lo).max()) + 1 if ngrp else 1
        ds = d_lo[:, None] + np.arange(nd, dtype=np.int64)[None, :]
        dvalid = ds <= d_hi[:, None]
        dsc = np.minimum(ds, d_hi[:, None])
        if len(tile) > 2:
            w_lo = np.clip(lo[:, 2], 0, Wl - 1)
            w_hi = np.clip(hi[:, 2], 0, Wl - 1)
            nh = int((h_hi - h_lo).max()) + 1 if ngrp else 1
            hs = h_lo[:, None] + np.arange(nh, dtype=np.int64)[None, :]
            hvalid = hs <= h_hi[:, None]
            hsc = np.minimum(hs, h_hi[:, None])
            base = (dsc[:, :, None] * Hl + hsc[:, None, :]) * Wl
            q_lo = base + w_lo[:, None, None]
            q_hi = base + w_hi[:, None, None] + 1
            seg_valid = dvalid[:, :, None] & hvalid[:, None, :]
        else:
            q_lo = ((dsc * Hl + h_lo[:, None]) * Wl)[:, :, None]
            q_hi = ((dsc * Hl + h_hi[:, None] + 1) * Wl)[:, :, None]
            seg_valid = dvalid[:, :, None]
        nseg = q_lo.shape[1] * q_lo.shape[2]
        seg_a = np.searchsorted(key, q_lo.ravel()).reshape(ngrp, nseg)
        seg_b = np.searchsorted(key, q_hi.ravel()).reshape(ngrp, nseg)
        lens = np.where(seg_valid.reshape(ngrp, nseg), seg_b - seg_a, 0)
        gl = lens.sum(axis=1)

        need = int(gl.max()) if ngrp else 0
        cap = (rows_caps[li] if rows_caps is not None
               else max(64, -(-need // 32) * 32))
        if need > cap:
            raise ValueError(
                f"hat rows overflow at level {lvl}: group needs {need} rows "
                f"but cap is {cap}")
        used_caps.append(cap)

        # compact the per-group segment lists (drop empties, keep order)
        nz = lens > 0
        n_used = nz.sum(axis=1)
        seg_need = int(n_used.max()) if ngrp else 0
        scap = (seg_caps[li] if seg_caps is not None
                else max(4, -(-seg_need // 8) * 8))
        if seg_need > scap:
            raise ValueError(
                f"hat segs overflow at level {lvl}: group needs {seg_need} "
                f"segments but cap is {scap}")
        used_seg_caps.append(scap)
        sa = np.zeros((ngrp, scap), np.int32)
        sl = np.zeros((ngrp, scap), np.int64)
        g_idx, s_idx = np.nonzero(nz)
        pos_in_g = (np.cumsum(nz, axis=1) - 1)[g_idx, s_idx]
        sa[g_idx, pos_in_g] = seg_a[g_idx, s_idx].astype(np.int32)
        sl[g_idx, pos_in_g] = lens[g_idx, s_idx]
        out[f"seg_a{lvl}"] = sa
        out[f"seg_cum{lvl}"] = np.cumsum(sl, axis=1).astype(np.int32)
    out["rows_caps"] = tuple(used_caps)
    out["seg_caps"] = tuple(used_seg_caps)
    out["n_groups"] = n_groups
    return out


def expand_segments_np(seg_a, seg_cum, cap, sentinel):
    """Expand (start, cum-length) segments back to padded row lists
    (numpy mirror of expand_segments)."""
    seg_a = np.asarray(seg_a, np.int64)
    seg_cum = np.asarray(seg_cum, np.int64)
    ngrp, S = seg_a.shape
    j = np.arange(cap, dtype=np.int64)
    s = (seg_cum[:, None, :] <= j[None, :, None]).sum(-1)    # [ngrp, cap]
    sc = np.minimum(s, S - 1)
    prev = np.where(
        s > 0, np.take_along_axis(seg_cum, np.maximum(s - 1, 0), axis=1), 0)
    rows = np.take_along_axis(seg_a, sc, axis=1) + (j[None, :] - prev)
    valid = j[None, :] < seg_cum[:, -1:]
    return np.where(valid, rows, sentinel).astype(np.int32)


def prepare_hat_batch(batch, out_sh, site_caps, voxel_size, n_samples,
                      group_size=128, tile=(4, 8), rows_caps=None,
                      n_groups=None, seg_caps=None, rng=None,
                      quantize_z=False):
    """Augment a numpy batch with host-planned hat-interpolation fields.

    Adds (per batch element, stacked):
      z_vals   [B, R, S]        host-sampled depths (rng=None -> perturb off)
        or z_frac [B, R, S] u16 slab fractions when quantize_z (the device
        decodes near + (far-near) * (q * f32(1/65535)); the host plans with
        the decoded values, so group rows match the device's points)
      hat_sort [B, ngrp*P]      sorted slot -> original sample index
                                (uint16 when R*S <= 65536)
      hat_seg_a{l}   [B, ngrp, segcap_l]  row-segment starts
      hat_seg_cum{l} [B, ngrp, segcap_l]  inclusive cumulative lengths

    Returns (batch, hat_static) where hat_static = {rows_caps, seg_caps,
    n_groups, group_size, tile}; rows_caps is also the device expansion
    width (RenderSettings.hat_rows_caps).
    """
    B, R = batch["ray_o"].shape[:2]
    vs = np.asarray(voxel_size, np.float32)
    rev = [2, 1, 0]
    sort_dt = np.uint16 if R * n_samples <= 65536 else np.int32

    zs, zqs, sorts, seg_acc = [], [], [], None
    for b in range(B):
        z = stratified_z_np(batch["near"][b], batch["far"][b], n_samples, rng)
        if quantize_z:
            near = batch["near"][b][:, None].astype(np.float32)
            far = batch["far"][b][:, None].astype(np.float32)
            slab = np.maximum(far - near, 1e-12)
            q = np.clip(np.rint((z - near) / slab * 65535.0),
                        0, 65535).astype(np.uint16)
            # decode exactly as the device will: plan with these values
            z = near + (far - near) * (
                q.astype(np.float32) * np.float32(1.0 / 65535.0))
            zqs.append(q)
        pts = (batch["ray_o"][b][:, None, :]
               + batch["ray_d"][b][:, None, :] * z[..., None])   # [R, S, 3]
        pts = pts.reshape(-1, 3)
        Rm = batch["R"][b]
        Th = batch["Th"][b].reshape(1, 3)
        ppts = (pts - Th) @ Rm
        dhw = (ppts[:, rev] - batch["bounds"][b][0][rev]) / vs

        geom_b = {k: v[b] for k, v in batch["geom"].items()}
        plan = plan_hat_groups(dhw, geom_b, out_sh, site_caps,
                               group_size=group_size, tile=tile,
                               rows_caps=rows_caps, n_groups=n_groups,
                               seg_caps=seg_caps)
        rows_caps = plan["rows_caps"]
        seg_caps = plan["seg_caps"]
        n_groups = plan["n_groups"]

        zs.append(z)
        sorts.append(plan["perm"].astype(sort_dt, copy=False))
        if seg_acc is None:
            seg_acc = {k: [] for k in plan if k.startswith("seg_")
                       and k != "seg_caps"}
        for k in seg_acc:
            seg_acc[k].append(plan[k].astype(np.uint16, copy=False)
                              if max(site_caps) <= 65535
                              and max(rows_caps) <= 65535
                              else plan[k])

    def _stack(xs):
        return np.asarray(xs[0])[None] if len(xs) == 1 else np.stack(xs)

    batch = dict(batch)
    if quantize_z:
        batch["z_frac"] = _stack(zqs)
    else:
        batch["z_vals"] = _stack(zs).astype(np.float32, copy=False)
    batch["hat_sort"] = _stack(sorts)
    for k, v in seg_acc.items():
        batch[f"hat_{k}"] = _stack(v)
    hat_static = {"rows_caps": rows_caps, "seg_caps": seg_caps,
                  "n_groups": n_groups, "group_size": group_size,
                  "tile": tuple(tile)}
    return batch, hat_static


def decode_z_np(z_frac, near, far):
    """u16 slab fractions -> f32 depths (numpy mirror of decode_z)."""
    near = np.asarray(near, np.float32)[:, None]
    far = np.asarray(far, np.float32)[:, None]
    return near + (far - near) * (
        np.asarray(z_frac).astype(np.float32) * np.float32(1.0 / 65535.0))


def sorted_pts_np(batch, b, n_samples):
    """Host-side reconstruction of the sorted group points/dirs."""
    z = (decode_z_np(batch["z_frac"][b], batch["near"][b], batch["far"][b])
         if "z_frac" in batch else batch["z_vals"][b])
    pts = (batch["ray_o"][b][:, None, :]
           + batch["ray_d"][b][:, None, :] * z[..., None]).reshape(-1, 3)
    srt = np.asarray(batch["hat_sort"][b]).astype(np.int64)
    ngrp = batch["hat_seg_a1"].shape[-2]
    P = srt.shape[0] // ngrp
    vd = batch["ray_d"][b] / np.maximum(
        np.linalg.norm(batch["ray_d"][b], axis=-1, keepdims=True), 1e-8)
    return (pts[srt].reshape(-1, P, 3),
            vd[srt // n_samples].reshape(-1, P, 3))


# ---------------------------------------------------------------------------
# device: expansion, de-sort and the interpolation (torch)
# ---------------------------------------------------------------------------


def decode_z(z_frac, near, far):
    """u16 slab fractions (as int32) -> f32 depths [R, S]; bit-identical to
    decode_z_np: the scale is multiplied, never divided."""
    scale = constant(1.0 / 65535.0, torch.float32, z_frac.device)
    return near[:, None] + (far - near)[:, None] * (z_frac.float() * scale)


def expand_segments(seg_a, seg_cum, cap, sentinel):
    """Expand compact (start, cum-length) row segments to [ngrp, cap] lists.

    seg_a/seg_cum: [ngrp, S] int. Slots past a group's total get the
    sentinel row. Slot j lies in segment k iff prev_k <= j < cum_k; the
    segments are disjoint, so the masked sum selects exactly one.
    """
    seg_a = seg_a.long()
    seg_cum = seg_cum.long()
    j = torch.arange(cap, device=seg_a.device)
    prev = torch.cat([torch.zeros_like(seg_cum[:, :1]), seg_cum[:, :-1]],
                     dim=1)
    in_seg = ((prev[:, None, :] <= j[None, :, None])
              & (j[None, :, None] < seg_cum[:, None, :]))  # [ngrp, cap, S]
    row_of = seg_a[:, None, :] + (j[None, :, None] - prev[:, None, :])
    rows = torch.where(in_seg, row_of, 0).sum(-1)
    rows = torch.where(j[None, :] < seg_cum[:, -1:], rows, sentinel)
    return rows.to(torch.int32)


def inverse_perm(perm, n):
    """De-sort indices from the sort permutation: inv[i] = first slot j
    with perm[j] == i (padding slots repeat real points; first occurrence
    matches the host planner's convention). A scatter-min over a tensor
    pre-filled with the slot count."""
    slots = perm.shape[0]
    inv = torch.full((n,), slots, dtype=torch.int64, device=perm.device)
    return inv.scatter_reduce_(
        0, perm.long(), torch.arange(slots, device=perm.device),
        reduce="amin")


class _HatInterpolate(torch.autograd.Function):
    """The four levels' hat interpolation into one [ngrp, P, sum C] buffer.

    Forward: each level's kernel writes its own column slice (no
    concatenation). Backward: each level's backward kernel reads its column
    slice of the output gradient through the row stride (no copy) and
    returns d_feats in the features' dtype; sites, rows and positions get
    none (ray geometry and site coordinates carry no parameter gradient).
    In bf16 mode the level's whole f32 sum is rounded to bf16 once (the
    JAX package rounds each group's d_rf before its scatter).
    """

    @staticmethod
    def forward(ctx, levels, *feats):
        ngrp, P = levels[0][2].shape[:2]
        out = torch.empty((ngrp, P, sum(f.shape[-1] for f in feats)),
                          dtype=torch.float32, device=feats[0].device)
        c0 = 0
        for (sites, rows, pos), f in zip(levels, feats):
            C = f.shape[-1]
            hat_interp_level(f, sites, rows, pos, out=out[..., c0:c0 + C])
            c0 += C
        ctx.save_for_backward(*(t for lvl in levels for t in lvl))
        ctx.feat_meta = [(f.shape[-1], f.dtype) for f in feats]
        return out

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors
        if gout.stride(-1) != 1 or gout.stride(0) != gout.shape[1] * \
                gout.stride(1):
            gout = gout.contiguous()
        need = [i for i in range(len(ctx.feat_meta))
                if ctx.needs_input_grad[1 + i]]
        # on the card one sort orders every level's row ids for the
        # backward's fixed-order sums
        srt = dict(zip(need, sort_rows(
            [(saved[3 * i + 1], saved[3 * i].shape[0]) for i in need])
            if gout.is_cuda and need else []))
        grads, c0 = [], 0
        for i, (C, dtype) in enumerate(ctx.feat_meta):
            if ctx.needs_input_grad[1 + i]:
                sites, rows, pos = saved[3 * i:3 * i + 3]
                grads.append(hat_interp_level_bwd(
                    gout[..., c0:c0 + C], sites, rows, pos, dtype,
                    srt.get(i)).to(dtype))
            else:
                grads.append(None)
            c0 += C
        return (None, *grads)


def hat_interpolate(site_feats, geom, rows, dhw_grouped, static):
    """Multi-scale feature interpolation via grouped hat contractions.

    Args:
      site_feats: list of per-level site features [capS_l, C_l] (levels 1-4).
      geom: single-element frame geometry (sites{l} tables on device).
      rows: dict {lvl: [ngrp, capR_l]} int32 row lists.
      dhw_grouped: [ngrp, P, 3] full-res voxel coords in sorted group order.
      static: ModelStatic (for out_sh).

    Returns [ngrp, P, sum C_l] f32; each level writes its own column slice.
    Differentiable with respect to site_feats.
    """
    dev = dhw_grouped.device
    out_sh = constant(static.out_sh, torch.float32, dev)
    levels = []
    for lvl in (1, 2, 3, 4):
        sh_l = constant(tuple(s // (2 ** lvl) for s in static.out_sh),
                        torch.float32, dev)
        pos = (dhw_grouped * ((sh_l - 1.0) / out_sh)).detach()
        levels.append((geom[f"sites{lvl}"], rows[lvl], pos))
    return _HatInterpolate.apply(tuple(levels), *site_feats)
