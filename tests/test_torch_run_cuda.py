"""The tool entry point (neuralbody_tpu_torch/run.py) on the card at a
small size: the 313 config over a fake ZJU sequence (utils/fake_zju: 2
frames x 3 cameras at 64^2, 400 vertices, 2 cm voxels, 8 samples a ray),
weights from a seed with alpha_fc's bias raised, saved as a checkpoint:
`evaluate` on the card against the same runner on the CPU, and
`visualize` with vis_mesh (extract_mesh's density cube on the card against
the CPU's, the mesh written with V > 0 and T > 0); the NeRF baseline's
evaluate likewise. Skips where no NVIDIA GPU is present; run on the card
with `python -m pytest --noconftest tests/test_torch_run_cuda.py -q`.

Tolerances: PSNR within 1e-3 dB and SSIM within 1e-4 (the renders agree
at 1e-4 of scale in f32, chip_smoke.py's RENDER_TOL); the density cube at
1e-4 of its scale.
"""
import os

import numpy as np
import pytest
import torch

from neuralbody_tpu_torch import run
from neuralbody_tpu_torch.config import build, make_cfg
from neuralbody_tpu_torch.ops import conv_kernel, dense_kernel, hat_kernel
from neuralbody_tpu_torch.renderer.mesh import extract_mesh
from neuralbody_tpu_torch.train.checkpoint import save_checkpoint
from neuralbody_tpu_torch.train.optimizer import build_optimizer
from neuralbody_tpu_torch.utils.fake_zju import make_fake_zju
from neuralbody_tpu_torch.utils.mesh_io import load_ply

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_TOL = 1e-3
SSIM_TOL = 1e-4
CUBE_TOL = 1e-4


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


def _cfg(root, path, *opts):
    cfg = make_cfg(os.path.join(ROOT, path), opts=[
        "exp_name", "run_cuda", "H", "64", "W", "64", "ratio", "1.0",
        "N_rand", "64", "N_samples", "8", "num_train_frame", "2",
        "training_view", "[0, 1]", "voxel_size", "[0.02, 0.02, 0.02]",
        "nv", "400", "tpu.chunk_rays", "256", "tpu.mesh_pt_chunk", "4096",
        "test.frame_sampler_interval", "1", *opts])
    for split in ("train", "test"):
        data = cfg[f"{split}_dataset"]
        data.data_root, data.human = root, "CoreView_999"
        data.ann_file = f"{root}/annots.npy"
    cfg.perturb = 0
    return cfg


def _save(cfg, heads):
    """Seeded weights of cfg's network, the alpha heads' biases raised,
    saved where run.py loads them (cfg.trained_model_dir)."""
    init_fn, _ = build("network", cfg.network_module, cfg)
    params, bn = init_fn(torch.Generator().manual_seed(0), device="cpu")
    for head in heads:
        node = params
        for k in head:
            node = node[k]
        node["b"] += 3.0
    save_checkpoint(cfg.trained_model_dir, 0, params, bn,
                    build_optimizer(params, lambda t: 5e-4), latest=True)


@pytest.mark.parametrize("path,heads", [
    ("configs/zju_mocap_exp/latent_xyzc_313.yaml", [("alpha_fc",)]),
    ("configs/nerf/nerf_313.yaml", [("coarse", "alpha_linear"),
                                    ("fine", "alpha_linear")])])
def test_evaluate_on_the_card(dev, root, tmp_path, monkeypatch, path,
                              heads):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(root, path)
    _save(cfg, heads)
    launches = dense_kernel.MM_LAUNCHES + conv_kernel.CONV_LAUNCHES
    card = run.run_evaluate(cfg, dev)
    assert dense_kernel.MM_LAUNCHES + conv_kernel.CONV_LAUNCHES > launches
    cpu = run.run_evaluate(cfg, "cpu")
    assert np.isfinite(card["psnr"]) and 0 <= card["ssim"] <= 1
    assert abs(card["psnr"] - cpu["psnr"]) <= PSNR_TOL, (card, cpu)
    assert abs(card["ssim"] - cpu["ssim"]) <= SSIM_TOL, (card, cpu)


def test_vis_mesh_on_the_card(dev, root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(root, "configs/zju_mocap_exp/latent_xyzc_313.yaml",
               "vis_mesh", "True", "mesh_th", "0.5")
    _save(cfg, [("alpha_fc",)])
    params, settings, loader, _, _ = run.build_eval_state(cfg, dev)
    batch, meta = next(iter(loader))
    conv = conv_kernel.CONV_LAUNCHES
    got = extract_mesh(params, batch, meta, settings, cfg, device=dev)
    assert conv_kernel.CONV_LAUNCHES > conv
    want = extract_mesh(params, batch, meta, settings, cfg, device="cpu")
    scale = max(1.0, float(np.abs(want["cube"]).max()))
    np.testing.assert_allclose(got["cube"], want["cube"], rtol=0,
                               atol=CUBE_TOL * scale)
    assert run.run_visualize(cfg, dev) == len(loader)
    mesh_dir = os.path.join(cfg.result_dir, "mesh")
    plys = sorted(os.listdir(mesh_dir))
    assert len(plys) == len(loader)
    for f in plys:
        v, t = load_ply(os.path.join(mesh_dir, f))
        assert len(v) > 0 and len(t) > 0
