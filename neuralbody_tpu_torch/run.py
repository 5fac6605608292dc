"""Tool entry point of the port (mirrors the root run.py):

    python -m neuralbody_tpu_torch.run --type T --cfg_file CFG [--device cpu]
        [opts ...]

dataset:     iterate the training loader (pipeline smoke test, ref run.py:4-11)
network:     time forward renders (perf smoke, ref run.py:14-38)
evaluate:    PSNR/SSIM metrics on held-out views / unseen poses (ref :41-69)
visualize:   demo renders per the vis_* mode overlays (ref :72-123); with
             vis_mesh the iso-surface of the density grid (renderer/mesh.py)
light_stage: point clouds -> packed occupancy volumes (ref :103-106)
evaluate_nv: score saved competitor renders against GT (ref :109-122)

The config is make_cfg_from_args's (the YAML, then `key value` opts; --type
sets task "run" before the YAML, as the reference does), with perturb off.
Every render runs through parallel/train.ShardedEval, on the card or on
the CPU with --device cpu: with one process that is train/step.eval_step;
in a process group a caller formed (parallel/bootstrap.py) the eval rays
split over the ranks, as the JAX package splits them over its devices. Checkpoints load through train/checkpoint.load_params, so either
package's checkpoint evaluates.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def setup(argv=None):
    """(cfg, args, device) from the command line (default sys.argv)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    ns, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)

    from .config import make_cfg_from_args
    cfg, args = make_cfg_from_args(rest)
    cfg.perturb = 0  # deterministic samples at tool time (ref run.py:50)
    return cfg, args, ns.device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_eval_state(cfg, device=None):
    """(params, settings, loader, eval_fn, device) for the test split: the
    network built from the config and loaded from cfg.trained_model_dir
    (cfg.test.epoch, default the latest), eval_fn(params, batch) ->
    eval_step's output on `device` (the card unless "cpu"), through
    parallel/train.ShardedEval."""
    from . import datasets, evaluators, models, renderer, visualizers  # noqa: F401
    from .config import build
    from .datasets.loader import make_data_loader, make_dataset
    from .parallel.train import ShardedEval
    from .train.checkpoint import load_params
    from .utils.platform import resolve_device

    device = resolve_device(device)
    dataset = make_dataset(cfg, "test")
    model_static = build("model_static", cfg.network_module, cfg, dataset)
    settings = build("renderer", cfg.renderer_module, cfg, model_static)

    init_fn, _ = build("network", cfg.network_module, cfg)
    params, bn_stats = init_fn(torch.Generator().manual_seed(0),
                               device=device)
    load_params(cfg.trained_model_dir, params, bn_stats, epoch=cfg.test.epoch)

    eval_fn = ShardedEval(settings, device)
    loader = make_data_loader(cfg, "test", dataset=dataset)
    return params, settings, loader, eval_fn, device


def run_dataset(cfg, device=None):
    """Iterate the training loader; returns the number of batches."""
    from . import datasets  # noqa: F401
    from .datasets.loader import make_data_loader
    loader = make_data_loader(cfg, "train")
    n = 0
    for i, (batch, meta) in enumerate(loader):
        if i % 10 == 0:
            print(f"batch {i}: {batch['rgb'].shape[1]} rays")
        n += 1
    print("dataset OK")
    return n


def run_network(cfg, device=None):
    """Time up to ten renders after the first (its warm-up): host clock
    around eval_step and a device synchronize. Returns the seconds a
    render."""
    params, settings, loader, eval_fn, device = build_eval_state(cfg, device)
    times = []
    for i, (batch, meta) in enumerate(loader):
        t0 = time.perf_counter()
        eval_fn(params, batch)
        _sync(device)
        if i > 0:
            times.append(time.perf_counter() - t0)
        if i >= 10:
            break
    print(f"forward: {np.mean(times) if times else float('nan'):.4f}"
          f"s/batch over {len(times)} batches")
    return times


def run_evaluate(cfg, device=None):
    """Render the test split and score it with cfg.evaluator_module;
    returns the evaluator's summary."""
    from .config import build

    params, settings, loader, eval_fn, device = build_eval_state(cfg, device)
    evaluator = build("evaluator", cfg.evaluator_module, cfg)
    for batch, meta in loader:
        evaluator.evaluate(eval_fn(params, batch), batch, meta)
    return evaluator.summarize()


def run_visualize(cfg, device=None):
    """Render (or, with cfg.vis_mesh, mesh) every test item and hand it to
    cfg.visualizer_module; returns the number of items."""
    from .config import build
    from .renderer.mesh import extract_mesh

    params, settings, loader, eval_fn, device = build_eval_state(cfg, device)
    visualizer = build("visualizer", cfg.visualizer_module, cfg)
    n = 0
    for batch, meta in loader:
        if cfg.vis_mesh:
            output = extract_mesh(params, batch, meta, settings, cfg,
                                  device=device)
        else:
            output = eval_fn(params, batch)
        visualizer.visualize(output, batch, meta)
        n += 1
    return n


def run_light_stage(cfg, device=None):
    """Point clouds -> packed occupancy volumes (ref run.py:103-106 ->
    lib/utils/light_stage/ply_to_occupancy.py:41-66). Converts every
    pointcloud/*.ply under the dataset root into voxel/*.npz; returns the
    paths written."""
    import glob
    import os
    import types

    from .tools.dataset_tools import cmd_occupancy

    root = cfg.train_dataset.data_root
    plys = sorted(glob.glob(os.path.join(root, "pointcloud", "*.ply")))
    if not plys:
        print(f"no pointcloud/*.ply under {root}")
        return []
    out_dir = os.path.join(root, "voxel")
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for ply in plys:
        stem = os.path.splitext(os.path.basename(ply))[0]
        out.append(os.path.join(out_dir, stem + ".npz"))
        cmd_occupancy(types.SimpleNamespace(ply=ply, res=256, out=out[-1]))
    return out


def run_evaluate_nv(cfg, device=None):
    """Score a competitor's saved renders against GT with identical masking
    (ref run.py:109-122; evaluator: lib/evaluators/neural_volume.py). Needs
    only the data loader — no network forward."""
    from . import datasets, evaluators  # noqa: F401
    from .config import build
    from .datasets.loader import make_data_loader

    loader = make_data_loader(cfg, "test")
    evaluator = build("evaluator", "neural_volume", cfg)
    for batch, meta in loader:
        evaluator.evaluate(None, batch, meta)
    return evaluator.summarize()


RUNNERS = {
    "dataset": run_dataset,
    "network": run_network,
    "evaluate": run_evaluate,
    "visualize": run_visualize,
    "light_stage": run_light_stage,
    "evaluate_nv": run_evaluate_nv,
}


def main(argv=None):
    """Run the --type runner on the command line's config; returns what
    the runner returns."""
    cfg, args, device = setup(argv)
    if args.type not in RUNNERS:
        raise SystemExit(
            f"unknown --type {args.type!r}; valid: {', '.join(RUNNERS)}")
    return RUNNERS[args.type](cfg, device)


if __name__ == "__main__":
    main()
