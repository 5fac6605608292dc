"""The T-pose variant on the card: the conv kernel at the T-pose encoder's
full-width layer shapes (6890 template vertices of a synthetic SMPL model
in 5 mm voxels) against its plain version, forward and dx; a render of
configs/tpose/tpose_313.yaml at a small size (a fake ZJU sequence of 64^2
views, 400 vertices, 2 cm voxels, 8 samples a ray, warping from a posed
synthetic SMPL model) against the same render on the CPU; and a Trainer
fit + validate of that config with one loader worker (the shared geometry
key -1 through the worker's protocol, the parent's cache and the bank).
Skips where no NVIDIA GPU is present; run on the card with
`python -m pytest --noconftest tests/test_torch_tpose_cuda.py -q`.

Tolerances: the conv kernel at 1e-5 of the layer's scale (chip_smoke.py's
CONV_TOL: the same products summed in another order); the render at 1e-4
of scale (RENDER_TOL, f32).
"""
import os

import numpy as np
import pytest
import torch

from neuralbody_tpu_torch.config import build, make_cfg
from neuralbody_tpu_torch.datasets.loader import (make_data_loader,
                                                  make_dataset)
from neuralbody_tpu_torch.datasets.tpose_dataset import build_tpose_geometry
from neuralbody_tpu_torch.models import tpose_xyzc
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
from neuralbody_tpu_torch.ops import conv_kernel, sparse_conv
from neuralbody_tpu_torch.tools.prepare_warping import write_synthetic_warping
from neuralbody_tpu_torch.train.step import eval_step
from neuralbody_tpu_torch.utils import smpl
from neuralbody_tpu_torch.utils.fake_zju import make_fake_zju
from neuralbody_tpu_torch.utils.platform import to_device

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV_TOL = 1e-5
RENDER_TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_kernel.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_fake_zju(str(tmp_path_factory.mktemp("zju") / "CoreView_999"),
                         n_frames=2, n_cams=3, hw=64, n_verts=400,
                         shaded=True)
    write_synthetic_warping(root, 2, n_verts=400, ptot_vsize=0.08,
                            device="cpu")
    return root


def _cfg(root, out, *opts):
    data = []
    for split in ("train", "test"):
        data += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.human", "CoreView_999",
                 f"{split}_dataset.ann_file", f"{root}/annots.npy"]
    cfg = make_cfg(os.path.join(ROOT, "configs/tpose/tpose_313.yaml"), opts=[
        "exp_name", "tpose_cuda", "H", "64", "W", "64", "ratio", "1.0",
        "N_rand", "64", "N_samples", "8", "num_train_frame", "2",
        "training_view", "[0, 1]", "voxel_size", "[0.02, 0.02, 0.02]",
        "ptot_vsize", "[0.08, 0.08, 0.08]", "nv", "400",
        "tpu.chunk_rays", "256", "tpu.steps_per_dispatch", "2",
        "ep_iter", "4", "train.epoch", "1", "train.num_workers", "1",
        "save_ep", "10", "save_latest_ep", "10", "eval_ep", "100",
        "test.frame_sampler_interval", "1", *data, *opts])
    for k in ("trained_model_dir", "record_dir", "result_dir"):
        cfg[k] = os.path.join(str(out), k)
    return cfg


def test_conv_kernel_at_the_tpose_encoders_shapes(dev):
    """Every conv of a full-width T-pose encode and of its backward (17
    forward, 17 dx), f32, against sparse_conv_plain on the same inputs."""
    model = smpl.make_synthetic_model(n_verts=6890, seed=0)
    tgeo = build_tpose_geometry(model["v_template"], (0.005,) * 3)
    static = EncoderStatic(out_sh=tgeo.out_sh, site_caps=tgeo.site_caps)
    params, _ = tpose_xyzc.init(torch.Generator().manual_seed(0),
                                num_train_frame=1, device=dev)
    geom = to_device({k: v[None] for k, v in tgeo.geom.items()}, dev)
    launch, calls = sparse_conv.sparse_conv, []

    def recorder(T, idx, W, dx=False):
        calls.append((T, idx, W))
        return launch(T, idx, W, dx=dx)

    enc = [params["vertex_code"]] + [
        p["w"] for layers in params["xyzc_net"].values() for p in layers]
    for p in enc:
        p.requires_grad_(True)
    sparse_conv.sparse_conv = recorder
    try:
        vols, _ = tpose_xyzc.encode_tpose_voxels(
            params, geom, tpose_xyzc.TposeStatic(encoder=static,
                                                 ptot_shape=(1, 1, 1)))
        torch.autograd.grad(sum(v.square().sum() for v in vols), enc)
    finally:
        sparse_conv.sparse_conv = launch
    assert len(calls) == 34
    for layer, (T, idx, W) in enumerate(calls):
        assert T.dtype == torch.float32
        out = conv_kernel.sparse_conv(T, idx, W)
        ref = conv_kernel.sparse_conv_plain(T, idx, W)
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        assert scale > 0 and err <= CONV_TOL * scale, (layer, err, scale)


def test_render_matches_the_cpu(dev, root, tmp_path):
    cfg = _cfg(root, tmp_path)
    ds = make_dataset(cfg, "train")
    static = build("model_static", cfg.network_module, cfg, ds)
    settings = build("renderer", cfg.renderer_module, cfg, static)
    batch, _ = next(iter(make_data_loader(cfg, "train", dataset=ds)))
    init, _ = build("network", cfg.network_module, cfg)
    params, _ = init(torch.Generator().manual_seed(0), device="cpu")
    params["alpha_fc"]["b"] += 1.0
    before = conv_kernel.CONV_LAUNCHES
    card = eval_step(params, batch, settings, device=dev)
    assert conv_kernel.CONV_LAUNCHES - before == 17
    ref = eval_step(params, batch, settings, device="cpu")
    for k in ("rgb_map", "acc_map", "depth_map"):
        scale = max(1.0, ref[k].abs().max().item())
        err = (card[k].cpu() - ref[k]).abs().max().item()
        assert err <= RENDER_TOL * scale, (k, err, scale)
    assert ref["acc_map"].max().item() > 0


def test_trainer_fits_and_validates(dev, root, tmp_path):
    from neuralbody_tpu_torch.train.trainer import Trainer
    cfg = _cfg(root, tmp_path)
    trainer = Trainer(cfg, device=dev)
    try:
        before = conv_kernel.CONV_DX_LAUNCHES
        trainer.fit()
        assert conv_kernel.CONV_DX_LAUNCHES - before == 4 * 17
        assert trainer.recorder.step == 4
        assert trainer.run.bank.installs == 1
        assert trainer.run.opt.step_graph is None   # the eager loop
        metrics = trainer.validate()
    finally:
        trainer.close()
    assert np.isfinite(metrics["psnr"]) and 0 <= metrics["ssim"] <= 1
