"""The training harness on the card (train/trainer.Trainer) at a small
size: the 313 config over a fake ZJU sequence (utils/fake_zju: 2 frames x
3 cameras at 64^2, 400 vertices, 2 cm voxels, 64 rays x 16 samples), G = 2
in bf16 and f32: fit() of two epochs through the graphed banked step
(one capture), its checkpoints, validate(), and a second Trainer resumed
from latest.ckpt bit for bit; and the NeRF baseline's config through the
eager branch (no graph) with validate(). Skips where no NVIDIA GPU is
present; run on the card with
`python -m pytest --noconftest tests/test_torch_trainer_cuda.py -q`.
"""
import math
import os

import pytest
import torch

from neuralbody_tpu_torch.config import make_cfg
from neuralbody_tpu_torch.ops import conv_kernel, dense_kernel, hat_kernel
from neuralbody_tpu_torch.train.optimizer import tree_leaves
from neuralbody_tpu_torch.train.trainer import Trainer
from neuralbody_tpu_torch.utils.fake_zju import make_fake_zju

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    conv_kernel.build()
    dense_kernel.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fake_zju(str(tmp_path_factory.mktemp("zju")
                             / "CoreView_999"), n_frames=2, n_cams=3,
                         hw=64, n_verts=400, shaded=True)


def _cfg(root, out, path, opts=()):
    cfg = make_cfg(os.path.join(ROOT, path), opts=[
        "H", "64", "W", "64", "ratio", "1.0", "N_rand", "64",
        "num_train_frame", "2", "training_view", "[0, 1]",
        "voxel_size", "[0.02, 0.02, 0.02]", "nv", "400",
        "tpu.chunk_rays", "256", "tpu.steps_per_dispatch", "2",
        "train.num_workers", "0", "ep_iter", str(STEPS), "train.epoch", "2",
        "save_ep", "1", "save_latest_ep", "1", "eval_ep", "100",
        "test.frame_sampler_interval", "1", *opts])
    for split in ("train", "test"):
        data = cfg[f"{split}_dataset"]
        data.data_root, data.human = root, "CoreView_999"
        data.ann_file = f"{root}/annots.npy"
    for k in ("trained_model_dir", "record_dir", "result_dir"):
        cfg[k] = str(out / k)
    return cfg


def _state(t):
    return tree_leaves([t.params, t.bn_stats, t.opt.mu, t.opt.nu])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fit_resume_validate(dev, root, tmp_path, dtype):
    cfg = _cfg(root, tmp_path, "configs/zju_mocap_exp/latent_xyzc_313.yaml",
               ["N_samples", "16", "tpu.compute_dtype", dtype])
    trainer = Trainer(cfg, device=dev)
    with torch.no_grad():
        trainer.params["alpha_fc"]["b"] += 1.0
    hat_kernel.LAUNCHES = conv_kernel.CONV_LAUNCHES = 0
    trainer.fit()
    assert trainer.opt.step_graph.captures == 1
    assert hat_kernel.LAUNCHES > 0 and conv_kernel.CONV_LAUNCHES > 0
    assert {"latest.ckpt", "0.ckpt", "1.ckpt"} <= set(
        os.listdir(cfg.trained_model_dir))
    assert trainer.recorder.step == 2 * STEPS
    metrics = trainer.validate()
    assert math.isfinite(metrics["psnr"]) and 0 <= metrics["ssim"] <= 1

    second = Trainer(cfg, device=dev)
    assert second.resume() == 2
    assert second.recorder.step == trainer.recorder.step
    for a, b in zip(_state(trainer), _state(second)):
        assert torch.equal(a, b)
    # a resume into the first Trainer keeps the tensors its graph captured
    trainer.resume()
    trainer.train_epoch(2)
    assert trainer.opt.step_graph.captures == 1
    trainer.close()


def test_nerf_trains_eagerly_and_validates(dev, root, tmp_path):
    cfg = _cfg(root, tmp_path, "configs/nerf/nerf_313.yaml",
               ["N_samples", "8", "N_importance", "8", "train.epoch", "1"])
    trainer = Trainer(cfg, device=dev)
    dense_kernel.MM_LAUNCHES = 0
    trainer.fit()
    assert trainer.opt.step_graph is None and trainer.opt.count == STEPS
    assert dense_kernel.MM_LAUNCHES > 0
    assert math.isfinite(trainer.recorder.scalars["loss"].median)
    metrics = trainer.validate()
    assert math.isfinite(metrics["psnr"]) and 0 <= metrics["ssim"] <= 1
    trainer.close()
