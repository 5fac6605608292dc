"""The hat plan built on the card (counterpart of
neuralbody_tpu/ops/device_plan.py).

The host planner (ops/hat_interp.plan_hat_groups, the C++ planner in the
loader's workers) sorts a batch's ray samples into groups and ships the
plan with the batch. With cfg.tpu.hat_plan_device the loader ships rays
only, and the training step builds the same plan from the frame's device
geometry: a stable tile sort, each tile's points padded to whole groups
with repeats of its first point, and each (group, d-slice) segment of the
code-sorted site table, expanded to row lists. Given the same voxel
coordinates it gives the host planner's perm and rows bit for bit
(tests/test_torch_device_plan.py).

It is plain torch on the device, as the JAX function is plain XLA. It runs
inside the training step's CUDA graph, so it reads nothing back to the
host: no .item(), no boolean-mask indexing, no nonzero, and tensors sized
by the static DevicePlanSpec only. A plan that exceeds the static sizes
cannot raise in the graph; it sets the overflow flag, which the step
returns as the plan_overflow stat and the config run raises on
(train/fresh.ConfigRun).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.platform import constant
from .hat_interp import _level_scale, expand_segments

SENTINEL_KEY = 2 ** 30   # past every real site key (padded site rows)


class DevicePlanSpec(NamedTuple):
    """Static plan sizes (lives in RenderSettings.hat_plan)."""
    out_sh: tuple         # full-res (D, H, W)
    site_caps: tuple      # 5 ints (index 1..4 used)
    group_size: int       # P
    tile: tuple           # (td, th) in level-1 cells (2D tiles only)
    n_groups: int         # static group count
    rows_caps: tuple      # per-level expansion widths (4)
    seg_caps: tuple       # per-level d-slice capacities (4)

    def level_sh(self, lvl):
        return tuple(s // (2 ** lvl) for s in self.out_sh)


def spec_from_state(hat_state, encoder_static, group_size=128,
                    tile=(4, 8)):
    """DevicePlanSpec from the loader's derived hat statics (hat_state:
    n_groups, rows_caps, seg_caps) and the EncoderStatic."""
    return DevicePlanSpec(
        out_sh=tuple(encoder_static.out_sh),
        site_caps=tuple(encoder_static.site_caps),
        group_size=int(group_size), tile=tuple(tile[:2]),
        n_groups=int(hat_state["n_groups"]),
        rows_caps=tuple(hat_state["rows_caps"]),
        seg_caps=tuple(hat_state["seg_caps"]))


def _cells(x, hi, plus=0):
    """clip(floor(x) + plus, 0, hi) as int64, clipped before the cast."""
    return torch.clamp(torch.floor(x) + plus, 0, hi).long()


def plan_hat_device(dhw, geom, spec: DevicePlanSpec):
    """Full-res voxel coords [N, 3] -> the hat plan, on dhw's device.

    geom: one frame's device geometry (sites{l} [capS, 3] code-sorted with
    huge-coordinate padding, nsite{l} scalars, and rowcum{l}, the per-(d,
    h) slice offsets, where the frame has them; without rowcum the segment
    bounds come from a binary search over the site keys).

    Returns (perm [n_groups * P] int32, rows {l: [n_groups, capR_l]
    int32}, overflow: a 0-d f32 tensor, 1 when the plan needed more groups,
    rows or d-slices than the spec holds).
    """
    dev = dhw.device
    N = dhw.shape[0]
    P = spec.group_size
    td, th = spec.tile
    D1, H1, _ = spec.level_sh(1)
    n_th = -(-H1 // th)
    n_tiles = -(-D1 // td) * n_th

    pos1 = dhw * constant(tuple(_level_scale(spec.out_sh, 1).tolist()),
                          torch.float32, dev)
    dc = _cells(pos1[:, 0], D1 - 1)
    hc = _cells(pos1[:, 1], H1 - 1)
    tile_id = (dc // td) * n_th + hc // th                       # [N]

    # the host's np.argsort(kind="stable")
    order = torch.sort(tile_id, stable=True).indices
    h = torch.zeros(n_tiles, dtype=torch.int64, device=dev).index_add_(
        0, tile_id, torch.ones_like(tile_id))
    starts = torch.cumsum(h, 0) - h                               # exclusive
    padded = (h + (P - 1)) // P * P
    offs = torch.cumsum(padded, 0) - padded
    total = offs[-1] + padded[-1]

    slots = torch.arange(spec.n_groups * P, device=dev)
    # the tile of each slot: the last tile whose offset is <= the slot
    # (offs is nondecreasing; the JAX function counts a dense compare)
    tile_of = torch.clamp(
        torch.searchsorted(offs, slots, right=True) - 1, 0, n_tiles - 1)
    rel = slots - offs[tile_of]
    src = torch.where(rel < h[tile_of], rel, 0)
    # past the last point only for slots after the plan's end, which read
    # point 0 (a gather out of range clamps in XLA)
    at = torch.clamp(starts[tile_of] + src, max=N - 1)
    perm = torch.where(slots < total, order[at], 0)

    grp = dhw[perm].reshape(spec.n_groups, P, 3)
    g_min = grp.amin(dim=1)
    g_max = grp.amax(dim=1)

    rows = {}
    flags = [total > spec.n_groups * P]
    for li, lvl in enumerate((1, 2, 3, 4)):
        sl = constant(tuple(_level_scale(spec.out_sh, lvl).tolist()),
                      torch.float32, dev)
        Dl, Hl, Wl = spec.level_sh(lvl)
        d_lo = _cells(g_min[:, 0] * sl[0], Dl - 1)
        d_hi = _cells(g_max[:, 0] * sl[0], Dl - 1, plus=1)
        h_lo = _cells(g_min[:, 1] * sl[1], Hl - 1)
        h_hi = _cells(g_max[:, 1] * sl[1], Hl - 1, plus=1)

        nseg = spec.seg_caps[li]
        ds = d_lo[:, None] + torch.arange(nseg, device=dev)[None, :]
        dvalid = ds <= d_hi[:, None]
        dsc = torch.minimum(ds, d_hi[:, None])
        if f"rowcum{lvl}" in geom:
            rowcum = geom[f"rowcum{lvl}"]                  # [Dl*Hl + 1]
            seg_a = rowcum[dsc * Hl + h_lo[:, None]].long()
            seg_b = rowcum[dsc * Hl + h_hi[:, None] + 1].long()
        else:
            sites = geom[f"sites{lvl}"].long()             # [capS, 3]
            # padded rows (coordinate 2^30) would overflow the keys: an
            # explicit past-the-end key keeps the table sorted
            sc = torch.clamp(sites, 0, max(Dl, Hl, Wl) - 1)
            key = (sc[:, 0] * Hl + sc[:, 1]) * Wl + sc[:, 2]
            live = (torch.arange(key.shape[0], device=dev)
                    < geom[f"nsite{lvl}"].long())
            key = torch.where(live, key, SENTINEL_KEY)
            q_lo = (dsc * Hl + h_lo[:, None]) * Wl         # [G, nseg]
            q_hi = (dsc * Hl + h_hi[:, None] + 1) * Wl
            seg_a = torch.searchsorted(key, q_lo)
            seg_b = torch.searchsorted(key, q_hi)
        lens = torch.where(dvalid, seg_b - seg_a, 0)
        seg_cum = torch.cumsum(lens, dim=1)
        flags.append(seg_cum[:, -1].amax() > spec.rows_caps[li])
        flags.append((d_hi - d_lo + 1).amax() > nseg)
        rows[lvl] = expand_segments(seg_a, seg_cum, spec.rows_caps[li],
                                    spec.site_caps[lvl])
    overflow = torch.stack(flags).any().float()
    return perm.to(torch.int32), rows, overflow
