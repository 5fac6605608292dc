"""The evaluators and their metrics on the CPU against the JAX package's
on the same (output, batch, meta): evaluators/metrics.py (PSNR, SSIM),
evaluators/if_nerf.py ("if_nerf" at B = 1 and B = 2, over the masked rays
and over the whole image; "neural_volume" on saved JPEG renders;
"if_nerf_mesh"), the Trainer's "val" record (only with metrics), and
utils/fake_zju against tests/fake_data.py.

Tolerances: the metric lists, metrics.npy and the comparison PNGs are
equal (the same numpy arithmetic on the same numbers; the port's render
output arrives as tensors and moves to numpy first); the fake ZJU trees'
arrays are equal and their images decode to the same pixels (OpenCV's
and imageio's JPEG encoders at the same quality).
"""
import os

import numpy as np
import pytest
import torch

import neuralbody_tpu.evaluators  # noqa: F401  (registers plugins)
from neuralbody_tpu.config import build as j_build
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.evaluators import metrics as j_metrics
import neuralbody_tpu_torch.evaluators  # noqa: F401  (registers plugins)
from neuralbody_tpu_torch.config import build as t_build
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.evaluators import metrics as t_metrics
from neuralbody_tpu_torch.train import trainer as t_trainer

torch.set_num_threads(1)

H = W = 24


def _cfgs(tmp_path, **over):
    out = []
    for pkg, make in (("jax", j_make_cfg), ("torch", t_make_cfg)):
        cfg = make(opts=["task", "if_nerf", "exp_name", "e"])
        cfg.result_dir = str(tmp_path / pkg)
        for k, v in over.items():
            cfg[k] = v
        out.append(cfg)
    return out


def _case(B, seed=0):
    """(output, batch, meta) of B views: each with its own box mask and
    ray count, rays padded to one length."""
    rng = np.random.RandomState(seed)
    masks, counts = [], []
    for b in range(B):
        m = np.zeros((H, W), bool)
        y0, x0 = rng.randint(0, 6, 2)
        m[y0:y0 + 12 + 2 * b, x0:x0 + 10 + b] = True
        masks.append(m)
        counts.append(int(m.sum()))
    R = max(counts) + 5
    mask = np.zeros((B, R), np.float32)
    for b, n in enumerate(counts):
        mask[b, :n] = 1
    batch = {"rgb": rng.rand(B, R, 3).astype(np.float32), "ray_mask": mask}
    output = {"rgb_map": torch.from_numpy(
        np.clip(batch["rgb"] + 0.1 * rng.randn(B, R, 3), 0, 1)
        .astype(np.float32))}
    def per(vals):
        return vals if B > 1 else vals[0]
    meta = {"img_hw": per([(H, W)] * B),
            "mask_at_box": per([m.reshape(-1) for m in masks]),
            "frame_index": per([3 + b for b in range(B)]),
            "cam_ind": per([b for b in range(B)])}
    return output, batch, meta


def _same_files(a, b):
    import cv2
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        if n.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(os.path.join(a, n)),
                                          cv2.imread(os.path.join(b, n)),
                                          err_msg=n)


def test_metrics_match_jax():
    rng = np.random.RandomState(1)
    for shape in ((16, 20, 3), (30, 9, 3), (12, 12)):
        x, y = rng.rand(*shape), rng.rand(*shape)
        assert t_metrics.psnr(x, y) == j_metrics.psnr(x, y)
        assert t_metrics.ssim(x, y) == j_metrics.ssim(x, y)


@pytest.mark.parametrize("B,whole", [(1, False), (2, False), (1, True)])
def test_if_nerf_matches_jax(tmp_path, B, whole):
    jcfg, tcfg = _cfgs(tmp_path, eval_whole_img=whole)
    j_ev = j_build("evaluator", "if_nerf", jcfg)
    t_ev = t_build("evaluator", "if_nerf", tcfg)
    for seed in (0, 1):
        output, batch, meta = _case(B, seed)
        j_ev.evaluate({k: v.numpy() for k, v in output.items()}, batch,
                      meta)
        t_ev.evaluate(output, batch, meta)
    assert t_ev.psnr == j_ev.psnr and t_ev.ssim == j_ev.ssim
    assert t_ev.mse == j_ev.mse and len(t_ev.psnr) == 2 * B
    for a, b in zip(t_ev.last_images, j_ev.last_images):
        np.testing.assert_array_equal(a, b)
    assert t_ev.summarize() == j_ev.summarize()
    got = np.load(os.path.join(tcfg.result_dir, "metrics.npy"),
                  allow_pickle=True).item()
    want = np.load(os.path.join(jcfg.result_dir, "metrics.npy"),
                   allow_pickle=True).item()
    assert got == want
    _same_files(os.path.join(tcfg.result_dir, "comparison"),
                os.path.join(jcfg.result_dir, "comparison"))


def test_neural_volume_matches_jax(tmp_path):
    """Saved renders of another method (JPEG files, frame_{i}/pred_{c + 1}
    .jpg) against the ground truth, in both packages."""
    import cv2
    pred = tmp_path / "nv"
    rng = np.random.RandomState(4)
    jcfg, tcfg = _cfgs(tmp_path, human="CoreView_999",
                       pred_result_dir=str(pred))
    j_ev = j_build("evaluator", "neural_volume", jcfg)
    t_ev = t_build("evaluator", "neural_volume", tcfg)
    for seed in (0, 1):
        output, batch, meta = _case(1, seed)
        path = pred / f"frame_{meta['frame_index']}"
        path.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path / f"pred_{meta['cam_ind'] + 1}.jpg"),
                    (rng.rand(H, W, 3) * 255).astype(np.uint8))
        j_ev.evaluate({}, batch, meta)
        t_ev.evaluate({}, batch, meta)
    assert t_ev.psnr == j_ev.psnr and t_ev.ssim == j_ev.ssim
    assert t_ev.mse == j_ev.mse and len(t_ev.mse) == 2
    assert t_ev.summarize() == j_ev.summarize()


def test_mesh_evaluator_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs(tmp_path, mesh_th=0.5)
    cube = np.random.RandomState(5).rand(6, 7, 8).astype(np.float32)
    meta = {"frame_index": 11}
    j_build("evaluator", "if_nerf_mesh", jcfg).evaluate(
        {"cube": cube}, {}, meta)
    t_ev = t_build("evaluator", "if_nerf_mesh", tcfg)
    t_ev.evaluate({"cube": torch.from_numpy(cube)}, {}, meta)
    assert t_ev.summarize() == {}
    np.testing.assert_array_equal(
        np.load(tcfg.result_dir + "/mesh/0011.npy"),
        np.load(jcfg.result_dir + "/mesh/0011.npy"))


class _Recorder:
    def __init__(self):
        self.records, self.images = [], {}

    def update_image_stats(self, images):
        self.images.update(images)

    def record(self, prefix="train", scalars=None):
        self.records.append((prefix, scalars))


@pytest.mark.parametrize("name", ["if_nerf", "if_nerf_mesh"])
def test_val_is_recorded_only_with_metrics(tmp_path, monkeypatch, name):
    """validate() records "val" with the evaluator's metrics, and nothing
    when it has none (the JAX Trainer records the smoothed training
    scalars under "val" then)."""
    _, cfg = _cfgs(tmp_path, mesh_th=0.5)
    output, batch, meta = _case(1)
    if name == "if_nerf_mesh":
        output = {"cube": torch.zeros(2, 2, 2)}
    monkeypatch.setattr(t_trainer, "make_dataset", lambda cfg, split: None)
    monkeypatch.setattr(t_trainer, "make_data_loader",
                        lambda cfg, split, dataset: [(batch, meta)])
    monkeypatch.setattr(t_trainer, "eval_step", lambda *a, **k: output)
    trainer = t_trainer.Trainer.__new__(t_trainer.Trainer)
    trainer.cfg, trainer.test_dataset, trainer.device = cfg, None, "cpu"
    trainer.run = type("Run", (), {"params": {}, "settings": None})()
    trainer.recorder = _Recorder()
    trainer.evaluator = t_build("evaluator", name, cfg)
    metrics = trainer.validate()
    if name == "if_nerf":
        assert trainer.recorder.records == [("val", metrics)]
        assert trainer.recorder.images["pred_vs_gt"].shape == (H, 2 * W, 3)
    else:
        assert metrics == {} and trainer.recorder.records == []


def test_fake_zju_matches_the_test_fixture(tmp_path):
    """The port's own fake ZJU writer (utils/fake_zju, shaded and flat)
    against tests/fake_data.make_fake_zju with the same arguments."""
    import cv2
    from fake_data import make_fake_zju as test_writer
    from neuralbody_tpu_torch.utils.fake_zju import make_fake_zju
    for shaded in (False, True):
        kw = dict(n_frames=2, n_cams=2, hw=48, n_verts=200, shaded=shaded)
        a = make_fake_zju(str(tmp_path / f"port{shaded}/CoreView_999"), **kw)
        b = test_writer(str(tmp_path / f"test{shaded}/CoreView_999"), **kw)
        ja = np.load(f"{a}/annots.npy", allow_pickle=True).item()
        jb = np.load(f"{b}/annots.npy", allow_pickle=True).item()
        assert ja["ims"] == jb["ims"]
        for k in jb["cams"]:
            np.testing.assert_array_equal(ja["cams"][k], jb["cams"][k])
        for f in range(2):
            np.testing.assert_array_equal(np.load(f"{a}/vertices/{f}.npy"),
                                          np.load(f"{b}/vertices/{f}.npy"))
            pa = np.load(f"{a}/params/{f}.npy", allow_pickle=True).item()
            pb = np.load(f"{b}/params/{f}.npy", allow_pickle=True).item()
            for k in pb:
                np.testing.assert_array_equal(pa[k], pb[k])
        for rel in (r for frame in jb["ims"] for r in frame["ims"]):
            ma, mb = (cv2.imread(f"{r}/mask_cihp/{rel[:-4]}.png",
                                 cv2.IMREAD_UNCHANGED) for r in (a, b))
            np.testing.assert_array_equal(ma, mb)
            ia, ib = (cv2.imread(f"{r}/{rel}") for r in (a, b))
            np.testing.assert_array_equal(ia, ib, err_msg=rel)
