"""Two (or more) ranks of the sharded steps against one process, on the
card: what chip_smoke.py's "dist_two_ranks" phase and
tests/test_torch_dist_cuda.py hold. Needs an NVIDIA GPU.

    python -m neuralbody_tpu_torch.tools.dist_check [--world 2]
        [--backend nccl|gloo] [--size full|small] [--out DIR] [--cpu]

(--cpu runs the ranks on the CPU under gloo: a rehearsal of the plumbing,
at the small size; no number it prints is a card's.)

launch() starts `world` processes of this module (NB_COORDINATOR on a free
localhost port), all on the card of their LOCAL_RANK or, by default, on
card rank modulo the visible cards: two ranks share one card. NCCL refuses
two ranks on one device ("Duplicate GPU detected") in the versions known;
gloo on CUDA tensors takes them (parallel/collectives.py uses only
all_reduce and broadcast, the collectives gloo supports on the card).

Each rank, for bf16 and f32, on a hat batch (make_batch(hat=True), the
group count padded to a multiple of 8 as the loader pads it):
  * STEPS sharded steps in rays mode with group sharding from seeded
    weights; its parameters' SHA-256 (the ranks must agree bit for bit);
  * then TIMED_STEPS more, timed: ms a step, and the collectives' ms and
    bytes a step (every all_reduce and broadcast timed between two
    synchronizes: a measurement, not the steps' own timing);
  * on rank 0, the same STEPS in one process (train_step) twice: the
    sharded run's distance from the first (tools/graph_noise.distances, by
    group) and the two one-process runs' distance (their spread);
  * ShardedEval of a rays-only batch (EVAL_RAYS, four hull views) against
    eval_step (rank 0): the largest error over the maps' scale;
  * batch mode over two frames (the second with its vertices at each
    other's sites, so that their BatchNorm statistics differ), each rank
    one frame, against one process over both;
  * in both layouts, two planted faults' distances from one process: the
    parameter leaf that moved farthest left stale, and the gradients'
    all_reduce dropped (a tolerance that passes either is too loose).
The hat and conv kernels' launches over each rank's sharded steps are
counted. Each rank writes rank{r}.json under --out.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 2
TIMED_STEPS = 3
LR = 5e-4
EVAL_RAYS = 8192
HULL_VIEWS = 4
SIZES = {   # rays, vertices, voxel, samples, eval chunk
    "full": dict(n_rays=1024, n_verts=6890, voxel_size=0.005, n_samples=64,
                 chunk=2048),
    "small": dict(n_rays=128, n_verts=512, voxel_size=0.04, n_samples=8,
                  chunk=64),
}
ALPHA_BIAS = 1.0   # random weights leave the rays empty (graph_noise's)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(world=2, backend="gloo", size="full", out=".", timeout=900,
           cpu=False):
    """Run `world` ranks of this module (on the CPU with cpu=True);
    returns (their results by rank, the processes' combined output). A
    rank that fails raises with its output."""
    os.makedirs(out, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NB_", "RANK", "WORLD_SIZE", "MASTER_",
                                "LOCAL_RANK"))}
    env.update(NB_COORDINATOR=f"localhost:{_free_port()}",
               NB_NUM_PROCESSES=str(world), NB_DIST_BACKEND=backend,
               NB_DIST_TIMEOUT="300",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [env.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "neuralbody_tpu_torch.tools.dist_check",
         "--rank-of-group", "--size", size, "--out", out]
        + (["--cpu"] if cpu else []),
        env=dict(env, NB_PROCESS_ID=str(r)), cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = "\n".join(f"[rank {r}] {log}" for r, log in enumerate(logs))
    if any(p.returncode for p in procs):
        raise RuntimeError(f"a rank failed ({backend}):\n{text[-6000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, text


def _digest(params):
    from ..train.optimizer import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


class _Timed:
    """Every all_reduce and broadcast timed (synchronize before and after)
    and its bytes counted, while the block runs."""

    def __init__(self, sync):
        self.sync = sync

    def __enter__(self):
        import torch.distributed as dist
        self.ms, self.bytes, self.calls = 0.0, 0, 0
        self._orig = {n: getattr(dist, n) for n in ("all_reduce",
                                                    "broadcast")}

        def timed(fn):
            def call(t, *a, **k):
                self.sync()
                t0 = time.perf_counter()
                out = fn(t, *a, **k)
                self.sync()
                self.ms += 1e3 * (time.perf_counter() - t0)
                self.bytes += t.numel() * t.element_size()
                self.calls += 1
                return out
            return call
        for n, fn in self._orig.items():
            setattr(dist, n, timed(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self._orig.items():
            setattr(dist, n, fn)


def _scene(size, world):
    """(hat batch, its static sizes, rays-only eval batch, its static
    sizes, batch-mode frames) at SIZES[size]."""
    from ..utils.synthetic import make_batch
    z = SIZES[size]
    kw = dict(n_rays=z["n_rays"], n_verts=z["n_verts"],
              voxel_size=z["voxel_size"], seed=0)
    _, derive = make_batch(**kw, hat=True, n_samples=z["n_samples"],
                           hat_perturb=False)
    hs = dict(derive["hat"])
    hs["n_groups"] = -(-hs["n_groups"] // 8) * 8   # the loader's padding
    hat, static = make_batch(**kw, hat=True, n_samples=z["n_samples"],
                             hat_perturb=False, hat_static=hs)
    n_eval = EVAL_RAYS if size == "full" else 4 * z["chunk"]
    ebatch, estatic = make_batch(**dict(kw, n_rays=n_eval),
                                 num_views=HULL_VIEWS)
    plain, _ = make_batch(**kw)
    frames = {}
    per = z["n_rays"] // world
    for k, v in plain.items():
        if k == "geom":
            frames[k] = {n: np.repeat(a, world, axis=0) for n, a in v.items()}
        elif k in ("ray_o", "ray_d", "near", "far", "rgb", "ray_mask"):
            frames[k] = v[0].reshape(world, per, *v.shape[2:])
        else:
            frames[k] = np.repeat(v, world, axis=0)
    frames["latent_index"] = np.zeros(world, np.int32)
    vi = frames["geom"]["vert_idx"]
    for b in range(1, world):
        vi[b] = np.random.RandomState(b).permutation(vi[b])
    return hat, static, ebatch, estatic, frames


def rank_main(size, out, cpu=False):
    import torch.distributed as dist

    from ..parallel import bootstrap

    # the group first: a backend that refuses it fails before the imports
    assert bootstrap.maybe_initialize_distributed(
        device="cpu" if cpu else None)
    rank, world = bootstrap.rank(), bootstrap.world()
    if cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = bootstrap.local_device()
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)           # the backend takes this group
    assert float(probe) == world

    from ..models import latent_xyzc as lx
    from ..models.sparse_conv_net import EncoderStatic
    from ..ops import conv_kernel, hat_kernel
    from ..parallel import mesh
    from ..parallel import train as ptrain
    from ..renderer.renderer import RenderSettings
    from ..train import optimizer
    from ..train.step import eval_step, train_step
    from . import graph_noise

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    z = SIZES[size]
    hat, static, ebatch, estatic, frames = _scene(size, world)
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "card": (torch.cuda.get_device_name(dev)
                                        if dev.type == "cuda" else None),
           "n_groups": int(hat["hat_seg_a1"].shape[1]), "modes": {}}

    def settings(mode, st, **kw):
        return RenderSettings(
            model=lx.ModelStatic(encoder=EncoderStatic(
                out_sh=st["out_sh"], site_caps=st["site_caps"],
                compute_dtype="bfloat16" if mode == "bf16" else "float32")),
            voxel_size=(z["voxel_size"],) * 3, n_samples=z["n_samples"],
            perturb=False, **kw)

    def fresh():
        params, bn = lx.init(torch.Generator().manual_seed(0),
                             num_train_frame=1, nv=z["n_verts"], device=dev)
        with torch.no_grad():
            params["alpha_fc"]["b"] += ALPHA_BIAS
        return params, bn, optimizer.build_optimizer(params, lambda t: LR)

    def run(step, batch, s, n):
        params, bn, opt = fresh()
        losses = []
        for _ in range(n):
            bn, st = step(params, bn, opt, batch, s, device=dev)
            losses.append(st["loss"])
        return graph_noise.run_state(params, bn, opt, torch.stack(losses)), \
            params, bn, opt

    def worst(a, b):
        return {g: max(d for _, d in rows)
                for g, rows in graph_noise.distances(a, b).items()}

    def faults(step, batch, s, state, one):
        """The two planted faults' distances from one process (rank 0;
        every rank runs the second): the parameter leaf that moved
        farthest left at its start value (the stale leaf the group
        distance sees best), and STEPS steps with the gradients'
        all_reduce dropped (each rank steps on its own part of the
        gradient)."""
        params, bn, opt = fresh()
        before = graph_noise.run_state(params, bn, opt,
                                       torch.zeros(STEPS, device=dev))
        moved = graph_noise.distances(state, before)["params"]
        i = max(range(len(moved)), key=lambda j: moved[j][1])
        stale = dict(state, params=[before["params"][j] if j == i else
                                    leaf for j, leaf in
                                    enumerate(state["params"])])
        n_leaves = len(before["params"])
        reduce = ptrain.all_reduce_tensors
        ptrain.all_reduce_tensors = lambda ts: (
            None if len(ts) == n_leaves else reduce(ts))
        try:
            dropped, *_ = run(step, batch, s, STEPS)
        finally:
            ptrain.all_reduce_tensors = reduce
        if rank == 0:
            return {"stale_leaf": worst(stale, one),
                    "stale_path": moved[i][0],
                    "no_grad_all_reduce": worst(dropped, one)}

    sharded = ptrain.make_sharded_train_step("rays")
    for mode in ("bf16", "f32"):
        s = settings(mode, static, hat_rows_caps=tuple(static["hat"][
            "rows_caps"]))
        hat_kernel.LAUNCHES = hat_kernel.BWD_LAUNCHES = 0
        conv_kernel.CONV_LAUNCHES = conv_kernel.CONV_DX_LAUNCHES = 0
        state, params, bn, opt = run(sharded, hat, s, STEPS)
        launches = dict(hat_fwd=hat_kernel.LAUNCHES,
                        hat_bwd=hat_kernel.BWD_LAUNCHES,
                        conv=conv_kernel.CONV_LAUNCHES,
                        conv_dx=conv_kernel.CONV_DX_LAUNCHES)
        row = {"digest": _digest(params), "launches": launches,
               "loss": state["loss"][0][1].tolist()}
        sync()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            bn, _ = sharded(params, bn, opt, hat, s, device=dev)
        sync()
        row["step_ms"] = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
        with _Timed(sync) as timed:
            for _ in range(TIMED_STEPS):
                bn, _ = sharded(params, bn, opt, hat, s, device=dev)
        row.update(collective_ms=timed.ms / TIMED_STEPS,
                   collective_bytes=timed.bytes // TIMED_STEPS,
                   collective_calls=timed.calls // TIMED_STEPS)
        del params, bn, opt
        one = None
        if rank == 0:
            one, *_ = run(train_step, hat, s, STEPS)
            two, *_ = run(train_step, hat, s, STEPS)
            row.update(single_loss=one["loss"][0][1].tolist(),
                       vs_single=worst(state, one), spread=worst(one, two))
        row["faults"] = faults(sharded, hat, s, state, one)
        # the plan-free eval render over the ranks against eval_step
        es = settings(mode, estatic, chunk_rays=z["chunk"],
                      hull_views=HULL_VIEWS)
        params, _, _ = fresh()
        ret = ptrain.ShardedEval(es, dev)(params, ebatch)
        if rank == 0:
            want = eval_step(params, ebatch, es, device=dev)
            row["eval_err"] = max(
                ((ret[k] - want[k]).abs().max()
                 / want[k].abs().max().clamp(min=1e-30)).item()
                for k in ("rgb_map", "acc_map", "depth_map"))
        row["eval_digest"] = hashlib.sha256(
            ret["rgb_map"].cpu().numpy().tobytes()).hexdigest()
        # batch mode: one frame a rank against one process over both
        fs = settings(mode, static, chunk_rays=z["n_rays"] // world)
        local = mesh.shard_batch(frames, rank, world, mode="batch")
        batched = ptrain.make_sharded_train_step("batch")
        bstate, params, _, _ = run(batched, local, fs, STEPS)
        row["batch_digest"] = _digest(params)
        one = None
        if rank == 0:
            one, *_ = run(train_step, frames, fs, STEPS)
            row["batch_vs_single"] = worst(bstate, one)
            row["batch_loss"] = bstate["loss"][0][1].tolist()
            row["batch_single_loss"] = one["loss"][0][1].tolist()
        row["batch_faults"] = faults(batched, local, fs, bstate, one)
        res["modes"][mode] = row
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    bootstrap.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--size", default="full", choices=sorted(SIZES))
    ap.add_argument("--out", default="build/dist_check")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rank-of-group", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of_group:
        return rank_main(args.size, args.out, args.cpu)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("dist_check: no CUDA device is available")
    results, _ = launch(args.world, "gloo" if args.cpu else args.backend,
                        args.size, args.out, cpu=args.cpu)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
