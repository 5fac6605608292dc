"""Train the flagship to a plateau and score the held-out view: the port's
counterpart of the repository's tools/convergence_run.py.

Trains latent_xyzc on the view-consistent shaded fixture
(utils/fake_zju.make_fake_zju(shaded=True): 6 frames, 5 training views and
1 held-out view) at the reference working point (512^2, 5 mm voxels, 1024
rays x 64 samples, lr 5e-4 with an exponential decay of 0.1 over 40 epochs
of 250 steps, G = 8 steps a dispatch, two loader workers, f32) through
train/trainer.Trainer, and evaluates the held-out camera every
--eval-every epochs with Trainer.validate (run.py's evaluate protocol).
It stops at the plateau rule of the JAX tool, at --epochs, or before
--budget-s seconds run out, checking the clock at epoch boundaries; then
it writes latest.ckpt under <workdir>/trained and the PSNR / SSIM curve to
--out as JSON with the JAX tool's keys, plus the card's name and power
limit.

    python -m neuralbody_tpu_torch.tools.convergence_run [--budget-s 1500]
        [--epochs N] [--eval-every 2] [--out QUALITY_torch_r12.json]
        [--workdir build/convergence]
    python -m neuralbody_tpu_torch.tools.convergence_run --cpu --tiny

--tiny is the 96^2 sanity run (4 cameras, 400 vertices, 2 cm voxels, 256
rays x 32 samples, G = 2, 50 steps an epoch); --cpu runs on the CPU. The
run resumes from <workdir>/trained when a checkpoint is there.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_cfg(root, workdir, tiny=False, n_cams=6, ep_iter=250):
    """The run's config: the JAX tool's make_cfg key for key (its
    experiment name apart), built by the port's config.make_cfg."""
    from ..config import make_cfg as _make_cfg
    cfg = _make_cfg(opts=["task", "if_nerf", "exp_name", "convergence"])
    cfg.H = cfg.W = 96 if tiny else 512
    cfg.ratio = 1.0
    cfg.N_rand = 256 if tiny else 1024
    cfg.N_samples = 32 if tiny else 64
    cfg.num_train_frame = 6
    cfg.training_view = list(range(n_cams - 1))   # hold out the last camera
    cfg.voxel_size = [0.02] * 3 if tiny else [0.005] * 3
    cfg.nv = 400 if tiny else 6890
    cfg.tpu.chunk_rays = 256 if tiny else 2048
    cfg.tpu.steps_per_dispatch = 2 if tiny else 8
    cfg.ep_iter = ep_iter
    cfg.train.epoch = 10000        # driven by the budget loop
    cfg.train.num_workers = 2
    cfg.train.lr = 5e-4
    cfg.train.scheduler.type = "exponential"
    cfg.train.scheduler.gamma = 0.1
    # the flagship YAML decays over 1000 epochs x 500 steps; scaled to
    # this run's length
    cfg.train.scheduler.decay_epochs = 40 if not tiny else 30
    cfg.save_ep = 10000
    cfg.save_latest_ep = 10000     # checkpoints written by the budget loop
    cfg.eval_ep = 10000            # evaluation driven by the loop
    cfg.log_interval = 100
    cfg.record_interval = 50
    cfg.record_dir = os.path.join(workdir, "record")
    cfg.trained_model_dir = os.path.join(workdir, "trained")
    cfg.result_dir = os.path.join(workdir, "result")
    cfg.test.sampler = "FrameSampler"
    cfg.test.frame_sampler_interval = 2   # 3 of 6 frames per eval pass
    cfg.train_dataset.data_root = root
    cfg.train_dataset.human = "CoreView_999"
    cfg.train_dataset.ann_file = f"{root}/annots.npy"
    cfg.test_dataset.update(cfg.train_dataset)
    cfg.test_dataset.split = "test"
    return cfg


def fixture(workdir, n_frames, tiny):
    """The shaded fixture under <workdir>/CoreView_999, written unless it
    is there (the same seed gives the same first frames at any n_frames).
    Returns (root, n_cams)."""
    from ..utils.fake_zju import make_fake_zju
    n_cams = 4 if tiny else 6
    root = os.path.join(workdir, "CoreView_999")
    if not os.path.exists(f"{root}/annots.npy"):
        print(f"rendering the shaded fixture ({n_frames} frames)...",
              flush=True)
        make_fake_zju(root, n_frames=n_frames, n_cams=n_cams,
                      hw=96 if tiny else 512,
                      n_verts=400 if tiny else 6890, shaded=True)
    return root, n_cams


def run_cfg(workdir, n_frames=6, tiny=False):
    """The run's config over the fixture under `workdir` (written with
    n_frames frames unless it is there)."""
    root, n_cams = fixture(workdir, n_frames, tiny)
    return make_cfg(root, workdir, tiny=tiny, n_cams=n_cams,
                    ep_iter=50 if tiny else 250)


def platform_of(device):
    """("gpu" and the card's `nvidia-smi` name and power limit) or ("cpu",
    None)."""
    if device.type != "cuda":
        return "cpu", None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return "gpu", card


def _point(epoch, cfg, m):
    return {"epoch": epoch, "step": epoch * cfg.ep_iter,
            "psnr": round(float(m["psnr"]), 3),
            "ssim": round(float(m["ssim"]), 4)}


def plateaued(curve):
    """The JAX tool's stop rule: at least 10 evaluations, the last 6 within
    0.1 dB, no SSIM gain in the last, and the last PSNR within 0.1 dB of
    the best."""
    if len(curve) < 10:
        return False
    last = curve[-6:]
    ps = [c["psnr"] for c in last]
    ss = [c["ssim"] for c in last]
    return (max(ps) - min(ps) < 0.1 and ss[-1] <= max(ss[:-1]) + 0.002
            and ps[-1] >= max(c["psnr"] for c in curve) - 0.1)


def main(argv=None):
    """Run the tool; returns the JSON it writes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="96^2 learning-sanity run")
    ap.add_argument("--budget-s", type=float, default=1500.0)
    ap.add_argument("--epochs", type=int, default=None,
                    help="stop after this many epochs (default: the "
                         "budget or the plateau)")
    ap.add_argument("--eval-every", type=int, default=2,
                    help="evaluate the held-out view every N epochs")
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "QUALITY_torch_r12.json"))
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "build", "convergence"))
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    from ..train.trainer import Trainer
    from ..utils.platform import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = run_cfg(args.workdir, 6, args.tiny)
    platform, card = platform_of(device)
    print(f"platform: {platform} ({card or device})", flush=True)

    trainer = Trainer(cfg, device=device)
    try:
        begin = trainer.resume()
        curve = []
        train_s = 0.0
        rays_done = 0
        epoch = begin
        while True:
            t0 = time.perf_counter()
            trainer.recorder.epoch = epoch
            trainer.train_epoch(epoch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            train_s += dt
            rays_done += cfg.ep_iter * cfg.N_rand
            epoch += 1

            if epoch % args.eval_every == 0:
                curve.append(_point(epoch, cfg, trainer.validate()))
                print(f"[{time.perf_counter() - t_start:7.1f}s] epoch "
                      f"{epoch} ({dt:.1f}s/ep) held-out psnr "
                      f"{curve[-1]['psnr']:.2f} ssim "
                      f"{curve[-1]['ssim']:.4f}", flush=True)

            if args.epochs is not None and epoch - begin >= args.epochs:
                break
            elapsed = time.perf_counter() - t_start
            # leave room for one more epoch + eval before the budget ends
            if elapsed + 1.5 * dt + 20 > args.budget_s:
                break
            if plateaued(curve):
                print("plateaued", flush=True)
                break

        trainer.save(epoch - 1, latest=True)
        if not curve or curve[-1]["epoch"] != epoch:
            curve.append(_point(epoch, cfg, trainer.validate()))
    finally:
        trainer.close()

    out = {
        "metric": "held_out_view_psnr",
        "platform": platform,
        "card": card,
        "fixture": ("shaded ellipsoid, view-consistent albedo+Lambert, "
                    f"{len(cfg.training_view)} train views / 1 held-out, "
                    f"6 frames, "
                    f"{cfg.H}^2"),
        "value": curve[-1]["psnr"],
        "best_psnr": round(max(c["psnr"] for c in curve), 3),
        "final_ssim": curve[-1]["ssim"],
        "epochs": epoch,
        "steps": epoch * cfg.ep_iter,
        "rays_per_step": cfg.N_rand,
        "train_s": round(train_s, 1),
        "train_rays_per_s": round(rays_done / max(train_s, 1e-9), 1),
        "curve": curve,
    }
    print(json.dumps(out), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
