"""How far eager training steps on the card drift apart from run to run,
and how far a graphed run of the same steps lies from one of them: the data
behind the graph-vs-eager tolerances (chip_smoke.py GRAPH_TOL and
CONFIG_TOL, tests/test_torch_graph_cuda.py, tests/test_torch_fresh_cuda.py),
and the comparison those checks share. Needs an NVIDIA GPU.

    python -m neuralbody_tpu_torch.tools.graph_noise [--runs 20]
        [--scenes full,small,config,fresh] [--graph-runs 10] [--ckpt DIR]
        [--fixed-sum none|codes|hat|both]

Two sums on the hat path added floats in an order that changed from run
to run: the hat backward's atomicAdd to device memory (it sums in one
fixed order now) and index_add_ in scatter_vertex_codes (three or more
vertices in one voxel; it moves the last bits of f32 codes, which bf16
storage mostly rounds away). So eager runs of the same steps from the same
state can differ, and the encoder's conditioning amplifies that from step
to step; the tolerances were measured with the atomic backward and hold
for it. The comparison: per leaf of the state a run leaves (params, Adam's
mu and nu, the BN running stats, the losses as one leaf), the L2 distance
||a - b|| over the group's scale, the largest max(||a_l||, ||b_l||) of the
group's leaves l; a leaf whose two tensors are equal is at 0. A group's
distance is its farthest leaf's. The scale is the group's and not the
leaf's because near-zero leaves (BatchNorm scales and biases whose
gradients are mostly noise) flip the sign of their Adam steps from run to
run: over its own norm such a leaf moves by up to 2 between two correct
runs, so a tolerance over leaf norms passes any state at all (a negated
leaf is at 2 too). Over the group's largest norm the same noise is small,
and a fault in a leaf that carries the group's weight (a negated or stale
moment or parameter) stands out; the price is that a fault confined to a
leaf far smaller than its group's largest reads small too.

For each scene and mode the tool makes --runs eager runs of the scene's
steps, prints the farthest pair's distance per group (the spread), and
holds --graph-runs graphed runs (StepGraph, the scene's dispatches) and one
graphed run whose second dispatch replays the first's batches (a stale
copy: the fault the check must catch) against the first eager run, each as
a ratio to 4 x the spread; and the first graphed run's state with the two
faults of mutations() made in it. One JSON line per scene and mode, with
the card's name and power limit.

Scenes:
  full    chip_smoke.py's graph_vs_eager: 1024 rays x 64 samples, 6890
          vertices, 5 mm voxels; batches A and B (batch_pair: two ray
          sets of one body), dispatches [A, A] and [B, B] of G = 2
  small   tests/test_torch_graph_cuda.py's: 64 rays x 16 samples, 500
          vertices, 2 cm voxels; the chains [A, A, B, B] (G = 2) and [B, B]
  config  chip_smoke.py's config_path: the 313 config's loader over a
          SyntheticDataset (4 frames, 4 cams, 512^2, 1024 rays), two
          dispatches of G = 8 distinct batches, bf16
  fresh   tests/test_torch_fresh_cuda.py's: its small loader, two
          dispatches of G = 2

--ckpt DIR starts the full scene from the trained state in DIR's latest
checkpoint (tools/convergence_run's <workdir>/trained: its params, BN
stats and Adam state, its frame latents; alpha_fc's bias as trained) in
place of the seeded one: the spread of trained weights. Only the full
scene has the trained model's widths, so --ckpt takes no other scene.

--fixed-sum swaps one (or both) of the two run-to-run sums for a sum in
one fixed order, for this tool's runs only (the program has no such
switch): "codes" makes scatter_vertex_codes a segment sum over the
vertices sorted by row, "hat" makes the hat backward its plain version
(ops/hat_kernel.hat_interp_level_bwd_plain) with the same segment sum in
place of index_add_, under torch.use_deterministic_algorithms(True).
The spread that is left says how much of it the swapped sum made. A swap
holds for the eager runs only, whose spread is the question (no graphed
runs, no stale copy, no mutations).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess

import numpy as np
import torch

from ..train import fresh

GROUPS = ("params", "mu", "nu", "bn", "loss")
MARGIN = 4   # a tolerance is this many times the worst eager spread


# ---------------------------------------------------------------------------
# the comparison (chip_smoke.py and the card tests use these)
# ---------------------------------------------------------------------------

def _named(tree, prefix):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def run_state(params, bn_stats, opt, losses):
    """The state a run of training steps leaves, copied: {group: [(path,
    f32 tensor)]} over GROUPS (losses: the run's per-step losses, one
    leaf)."""
    trees = {"params": params, "mu": opt.mu, "nu": opt.nu, "bn": bn_stats}
    out = {g: [(p, t.detach().float().clone()) for p, t in _named(tree, g)]
           for g, tree in trees.items()}
    out["loss"] = [("loss", torch.as_tensor(losses).detach().float()
                    .flatten().clone())]
    return out


def group_scale(x, y, group):
    """The scale of a group's distances: the largest max(||a||, ||b||) of
    its leaves over two run_states, in f64."""
    return max(max(a.double().norm().item(), b.double().norm().item())
               for (_, a), (_, b) in zip(x[group], y[group]))


def distances(x, y):
    """{group: [(path, distance)]} between two run_states: a leaf's
    ||a - b|| over its group's scale (group_scale), in f64; 0 where a
    equals b."""
    out = {}
    for g in GROUPS:
        scale = group_scale(x, y, g)
        out[g] = [(p, 0.0 if torch.equal(a, b) else
                   (a.double() - b.double()).norm().item() / scale)
                  for (p, a), (_, b) in zip(x[g], y[g])]
    return out


def ratio(d, tol):
    """A distance over its tolerance; where the tolerance is 0 (the eager
    runs agreed exactly), 0 for a distance of 0 and inf for any other."""
    return d / tol if tol else 0.0 if d == 0 else math.inf


def check(graph, eager, tol):
    """A graphed run's state against one eager run's, group by group:
    {group: {worst, path, ratio}} (ratio: worst / tol[group]) and the
    leaves over their group's tolerance as (path, distance, tol)."""
    groups, over = {}, []
    for g, rows in distances(graph, eager).items():
        path, worst = max(rows, key=lambda r: r[1])
        groups[g] = dict(worst=worst, path=path, ratio=ratio(worst, tol[g]))
        over += [(p, d, tol[g]) for p, d in rows if not d <= tol[g]]
    return groups, over


def mutations(state, before):
    """Two faults made in a run_state that the check must catch: "mu" with
    the largest leaf of Adam's mu negated, and "params" with the largest
    parameter leaf left at its value in `before` (the run_state of the
    seeded state the steps started from). {name: (group, path of the
    leaf, the state with the fault)}"""
    out = {}
    for name, fault in (("mu", lambda i, t: -t),
                        ("params", lambda i, t: before["params"][i][1])):
        rows = list(state[name])
        i = max(range(len(rows)), key=lambda j: rows[j][1].norm().item())
        rows[i] = (rows[i][0], fault(i, rows[i][1]))
        out[name] = (name, rows[i][0], dict(state, **{name: rows}))
    return out


def spread(runs):
    """The farthest pair of eager runs' distance per group, as {group:
    (distance, path)}."""
    worst = {g: (0.0, "") for g in GROUPS}
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            for g, rows in distances(runs[i], runs[j]).items():
                path, d = max(rows, key=lambda r: r[1])
                if d > worst[g][0]:
                    worst[g] = (d, path)
    return worst


# ---------------------------------------------------------------------------
# the sums in one fixed order (--fixed-sum)
# ---------------------------------------------------------------------------

FIXED_SUMS = ("none", "codes", "hat", "both")


def segment_sum(idx, src, n):
    """out[r] = the sum of src's rows i with idx[i] == r, r < n, in one
    order whatever the device: the rows sorted by index (a stable sort, so
    a row's addends keep their order), each segment summed by
    torch.segment_reduce, which adds a segment's addends one after the
    other. idx [N] int in [0, n); src [N, C]. Differentiable with respect
    to src."""
    idx = idx.long()
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=n)
    return torch.segment_reduce(src[order], "sum", lengths=counts, axis=0,
                                unsafe=True)


def fixed_scatter_vertex_codes(codes, vert_idx, cap):
    """ops/sparse_conv.scatter_vertex_codes as a segment_sum."""
    C = codes.shape[-1]
    if vert_idx.dim() == 1:
        return segment_sum(vert_idx, codes, cap + 1)[:cap]
    B, nv = vert_idx.shape
    offs = (torch.arange(B, device=vert_idx.device) * (cap + 1))[:, None]
    out = segment_sum((vert_idx.long() + offs).reshape(-1),
                      codes.expand(B, nv, C).reshape(B * nv, C),
                      B * (cap + 1))
    return out.reshape(B, cap + 1, C)[:, :cap]


def fixed_hat_bwd(grad, sites, rows, pos, dtype, sorted_rows=None):
    """ops/hat_kernel.hat_interp_level_bwd_plain with segment_sum in place
    of its index_add_, under torch.use_deterministic_algorithms(True)
    (sorted_rows, the kernel's sort, is not needed)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        capS = sites.shape[0]
        spad = torch.cat([sites.float(), torch.full(
            (1, 3), 1e9, device=sites.device)], dim=0)
        idx = rows.long()
        rc = spad[idx]
        tent = torch.clamp(
            1.0 - (pos[:, :, None, :] - rc[:, None, :, :]).abs(), min=0.0)
        hat = tent[..., 0] * tent[..., 1] * tent[..., 2]
        if dtype == torch.bfloat16:
            hat = hat.bfloat16().float()
        d_rf = torch.bmm(hat.transpose(1, 2), grad.float())
        C = grad.shape[-1]
        return segment_sum(idx.reshape(-1), d_rf.reshape(-1, C),
                           capS + 1)[:capS]
    finally:
        torch.use_deterministic_algorithms(prev)


@contextlib.contextmanager
def fixed_sums(which):
    """Swap the sums that `which` names (FIXED_SUMS) for their fixed-order
    versions inside the with block: the names the render path calls them
    by (models/latent_xyzc.scatter_vertex_codes, ops/hat_interp's
    hat_interp_level_bwd) are rebound and restored after."""
    from ..models import latent_xyzc
    from ..ops import hat_interp
    swaps = []
    if which in ("codes", "both"):
        swaps.append((latent_xyzc, "scatter_vertex_codes",
                      fixed_scatter_vertex_codes))
    if which in ("hat", "both"):
        swaps.append((hat_interp, "hat_interp_level_bwd", fixed_hat_bwd))
    old = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in old:
            setattr(m, n, f)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def batch_pair(n_rays, n_verts, voxel_size, n_samples, seed):
    """Two hat batches of one body: A is make_batch(seed)'s, B has the rays
    and colours of make_batch(seed + 1) and its own draw of the sample
    depths; both planned to one set of static sizes (the larger of each's
    own). Returns ([A, B], static) as make_batch does."""
    from ..ops.hat_interp import prepare_hat_batch
    from ..utils.synthetic import make_batch

    def rays(s):
        return make_batch(n_rays=n_rays, n_verts=n_verts,
                          voxel_size=voxel_size, seed=s)
    raw, static = rays(seed)
    other = rays(seed + 1)[0]
    raws = [raw, dict(raw, **{k: other[k] for k in
                              ("ray_o", "ray_d", "near", "far", "rgb")})]
    vs = (voxel_size,) * 3

    def plan(i, hs=None):
        hs = hs or {}
        return prepare_hat_batch(
            raws[i], static["out_sh"], static["site_caps"], vs, n_samples,
            rows_caps=hs.get("rows_caps"), seg_caps=hs.get("seg_caps"),
            n_groups=hs.get("n_groups"),
            rng=np.random.RandomState(seed + 1 + i))

    own = [plan(i)[1] for i in (0, 1)]
    hs = dict(own[0], n_groups=max(h["n_groups"] for h in own),
              **{k: tuple(max(c) for c in zip(*(h[k] for h in own)))
                 for k in ("rows_caps", "seg_caps")})
    static["hat"] = hs
    return [plan(i, hs)[0] for i in (0, 1)], static


CONFIG_313 = fresh.CONFIG_313
ALPHA_BIAS = 1.0   # added to alpha_fc's bias: random weights leave the
# rays empty (chip_smoke.py raises it alike)
SIZES = {   # SyntheticDataset's arguments and the samples a ray
    "full": dict(n_frames=4, n_cams=4, hw=(512, 512), n_verts=6890,
                 voxel_size=0.005, n_rand=1024, n_samples=64),
    "small": dict(n_frames=2, n_cams=2, hw=(64, 64), n_verts=500,
                  voxel_size=0.02, n_rand=64, n_samples=16),
}


def config_case(size, mode, G, n_batches):
    """(cfg, dataset): the 313 config over a SyntheticDataset of SIZES[size]
    as chip_smoke.py's config_path ("full") and
    tests/test_torch_fresh_cuda.py ("small") train it: the opts set the
    compute dtype, G steps a dispatch, n_batches an epoch, and (at the small
    size) the dataset's rays, samples, voxels and vertices; at full size
    those are the YAML's own."""
    from ..train.fresh import synthetic_cfg
    from ..utils.synthetic import SyntheticDataset
    kw = dict(SIZES[size])
    n_samples = kw.pop("n_samples")
    ds = SyntheticDataset(**kw)
    return synthetic_cfg(ds, mode, G, n_batches, n_samples), ds


def config_run(cfg, dataset, device, pool=None, bank=True):
    """train/fresh.ConfigRun of the case, alpha_fc's bias raised."""
    run = fresh.ConfigRun(cfg, dataset=dataset, pool=pool, device=device,
                          bank=bank)
    with torch.no_grad():
        run.params["alpha_fc"]["b"] += ALPHA_BIAS
    return run


def _hat_scene(dev, mode, n_rays, n_verts, vox, n_samples, seed, schedule,
               ckpt=None):
    from ..models import latent_xyzc as lx
    from ..models.sparse_conv_net import EncoderStatic
    from ..renderer.renderer import RenderSettings
    from ..train import optimizer
    from ..utils.platform import to_device
    (a, b), static = batch_pair(n_rays, n_verts, vox, n_samples, seed)
    a, b = to_device(a, dev), to_device(b, dev)
    settings = RenderSettings(
        model=lx.ModelStatic(encoder=EncoderStatic(
            out_sh=static["out_sh"], site_caps=static["site_caps"],
            compute_dtype=mode)),
        voxel_size=(vox,) * 3, hat_rows_caps=static["hat"]["rows_caps"])

    n_frames = 1
    if ckpt is not None:
        from ..train.checkpoint import _pick, read_checkpoint
        path = _pick(ckpt, -1)
        if path is None:
            raise SystemExit(f"no checkpoint under {ckpt}")
        n_frames = len(read_checkpoint(path)["params"]["frame_latent"])

    def init():
        params, bn = lx.init(torch.Generator().manual_seed(0),
                             num_train_frame=n_frames, nv=n_verts,
                             device=dev)
        opt = optimizer.build_optimizer(params, schedule())
        if ckpt is None:
            params["alpha_fc"]["b"] += ALPHA_BIAS
        else:
            from ..train.checkpoint import load_checkpoint
            load_checkpoint(ckpt, params, bn, opt)
        return params, bn, opt
    return (a, b), settings, init


def eager_run(dev, init, steps, settings):
    from ..train.step import train_steps
    params, bn, opt = init()
    bn, st = train_steps(params, bn, opt, steps, settings, device=dev)
    return run_state(params, bn, opt, st["loss"])


def graph_run(dev, init, dispatches, settings):
    """One StepGraph over the stacked dispatches from the seeded state."""
    from ..train.graphs import StepGraph
    params, bn, opt = init()
    graph, losses = StepGraph(dev), []
    for batches in dispatches:
        bn, st = graph(params, bn, opt, batches, settings)
        losses.append(st["loss"])
    return run_state(params, bn, opt, torch.cat(losses))


def scenes(dev, names, mode, ckpt=None):
    """(name, settings, init, chains) per scene of `names`: init() gives a
    run's seeded (params, bn_stats, opt), or the full scene's from the
    checkpoint under `ckpt`; per chain its eager steps, its dispatches and
    the dispatches of its stale-copy run (None: none)."""
    from ..train import optimizer
    from ..train.fresh import stack_batches
    if "full" in names:
        def schedule():
            return optimizer.make_lr_schedule(5e-4, "exponential",
                                              ep_iter=500, gamma=0.1,
                                              decay_epochs=1000)
        (a, b), st, init = _hat_scene(dev, mode, 1024, 6890, 0.005, 64, 0,
                                      schedule, ckpt)
        yield "full", st, init, [([a, a, b, b], [stack_batches([a, a]),
                                                 stack_batches([b, b])],
                                  [stack_batches([a, a])] * 2)]
    if "small" in names:
        (a, b), st, init = _hat_scene(dev, mode, 64, 500, 0.02, 16, 3,
                                      lambda: (lambda t: 5e-4))
        yield "small", st, init, [
            ([a, a, b, b], [stack_batches([a, a]), stack_batches([b, b])],
             [stack_batches([a, a])] * 2),
            ([b, b], [stack_batches([b, b])], None)]
    for name, size, G in (("config", "full", 8), ("fresh", "small", 2)):
        if name in names:
            from ..datasets.loader import make_data_loader
            from ..utils.platform import to_device
            cfg, ds = config_case(size, mode, G, 2 * G)
            hs = {}
            steps = [to_device(b, dev) for b, _ in make_data_loader(
                cfg, "train", dataset=ds, hat_state=hs)]
            run = config_run(cfg, ds, dev)
            settings = run.settings._replace(
                hat_rows_caps=tuple(hs["rows_caps"]))

            def init(cfg=cfg, ds=ds):
                run = config_run(cfg, ds, dev)
                return run.params, run.bn_stats, run.opt
            d = [stack_batches(steps[:G]), stack_batches(steps[G:])]
            yield name, settings, init, [(steps, d, [d[0], d[0]])]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--graph-runs", type=int, default=10)
    ap.add_argument("--scenes", default="full,small")
    ap.add_argument("--modes", default="bfloat16,float32")
    ap.add_argument("--ckpt", default=None,
                    help="start the full scene from this checkpoint dir")
    ap.add_argument("--fixed-sum", default="none", choices=FIXED_SUMS,
                    help="swap these sums for fixed-order ones (eager "
                    "runs only)")
    args = ap.parse_args(argv)
    graph_runs = 0 if args.fixed_sum != "none" else args.graph_runs
    if args.ckpt is not None and args.scenes != "full":
        raise SystemExit("--ckpt holds the full scene only: --scenes full")
    if not torch.cuda.is_available():
        raise SystemExit("graph_noise needs an NVIDIA GPU")
    from ..ops import conv_kernel, hat_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    conv_kernel.build()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    names = args.scenes.split(",")
    for mode in args.modes.split(","):
        # the config path trains in bf16, as the bench and production do
        todo = [n for n in names if mode == "bfloat16" or n != "config"]
        for name, settings, init, chains in scenes(dev, todo, mode,
                                                   args.ckpt):
            with fixed_sums(args.fixed_sum):
                eager = [[eager_run(dev, init, steps, settings) for _ in
                          range(args.runs)] for steps, _, _ in chains]
            worst = {g: (0.0, "") for g in GROUPS}
            for runs in eager:
                for g, w in spread(runs).items():
                    worst[g] = max(worst[g], w)
            tol = {g: MARGIN * d for g, (d, _) in worst.items()}
            ratios, teeth, faults = {g: [] for g in GROUPS}, None, {}
            p0, bn0, opt0 = init()
            before = run_state(p0, bn0, opt0, [])
            del p0, bn0, opt0
            for (steps, disp, stale), runs in zip(chains, eager):
                for r in range(graph_runs):
                    state = graph_run(dev, init, disp, settings)
                    groups, _ = check(state, runs[0], tol)
                    for g in GROUPS:
                        ratios[g].append(groups[g]["ratio"])
                    if r == 0 and not faults:
                        for what, (g, path, bad) in mutations(
                                state, before).items():
                            groups, _ = check(bad, runs[0], tol)
                            faults[what] = dict(
                                {k: v["ratio"] for k, v in groups.items()},
                                leaf=path, leaf_ratio=ratio(dict(distances(
                                    bad, runs[0])[g])[path], tol[g]))
                if stale is not None and graph_runs:
                    teeth, _ = check(graph_run(dev, init, stale, settings),
                                     runs[0], tol)
            print(json.dumps(dict(
                scene=name, mode=mode, card=card, ckpt=args.ckpt,
                fixed_sum=args.fixed_sum, eager_runs=args.runs,
                chains=[len(s) for s, _, _ in chains],
                spread={g: dict(worst=d, path=p)
                        for g, (d, p) in worst.items()},
                tol=tol, margin=MARGIN, graph_runs=graph_runs,
                graph_ratio_max={g: max(r, default=None)
                                 for g, r in ratios.items()},
                stale_copy=teeth, mutation_ratio=faults,
                stale_copy_worst_ratio=None if teeth is None else max(
                    v["ratio"] for v in teeth.values()))), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
