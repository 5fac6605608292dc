"""Novel-pose evaluation of the converged checkpoint: the port's
counterpart of the repository's tools/novel_pose_eval.py.

The reference's second headline metric is unseen-pose synthesis
(test_novel_pose: frames past the training window, the appearance latent
pinned to the last trained frame). This writes the shaded fixture with
two extra frames (8; the same seed gives frames 0-5 identical to the
training fixture's), loads tools/convergence_run's checkpoint from
<train-workdir>/trained, and evaluates the held-out camera on the two
never-trained poses with Trainer.validate. Writes --out as JSON with the
JAX tool's keys, plus the card's name and power limit.

    python -m neuralbody_tpu_torch.tools.novel_pose_eval
        [--train-workdir build/convergence] [--out NOVELPOSE_torch_r12.json]
        [--workdir build/novelpose] [--cpu] [--tiny]

--tiny and --cpu as in convergence_run (--tiny reads a --tiny run's
checkpoint).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .convergence_run import REPO, platform_of, run_cfg


def main(argv=None):
    """Run the tool; returns the JSON it writes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--train-workdir",
                    default=os.path.join(REPO, "build", "convergence"))
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "NOVELPOSE_torch_r12.json"))
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "build", "novelpose"))
    args = ap.parse_args(argv)

    from ..train.trainer import Trainer
    from ..utils.platform import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = run_cfg(args.workdir, 8, args.tiny)
    cfg.trained_model_dir = os.path.join(args.train_workdir, "trained")
    cfg.test_novel_pose = True
    cfg.num_novel_pose_frame = 2
    cfg.test.frame_sampler_interval = 1
    platform, card = platform_of(device)
    print(f"platform: {platform} ({card or device})", flush=True)

    trainer = Trainer(cfg, device=device)
    try:
        begin = trainer.resume()
        if begin <= 0:
            raise SystemExit(f"no checkpoint under {cfg.trained_model_dir}: "
                             "run tools/convergence_run first")
        print(f"loaded checkpoint at epoch {begin}", flush=True)
        t0 = time.perf_counter()
        m = trainer.validate()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        trainer.close()
    out = {
        "metric": "novel_pose_psnr",
        "platform": platform,
        "card": card,
        "protocol": ("test_novel_pose: frames 6-7 (never trained, poses "
                     "past the training window), held-out camera, latent "
                     "pinned to the last trained frame (ref "
                     "multi_view_dataset novel-pose windows)"),
        "value": round(float(m["psnr"]), 3),
        "ssim": round(float(m["ssim"]), 4),
        "trained_epochs": begin,
        "eval_s": round(dt, 1),
    }
    print(json.dumps(out), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
