"""The port's quality tools (neuralbody_tpu_torch/tools/convergence_run.py,
novel_pose_eval.py) against the repository's JAX tools, and graph_noise's
--ckpt start, on the CPU:

  * the convergence config equals the JAX tool's make_cfg key for key (the
    experiment's name apart), full size and --tiny;
  * the learning rate at epochs 0, 1, 20 and 40 equals the JAX schedule's
    (both exact: the same f64 arithmetic);
  * the 8-frame fixture's frames 0-5 equal the 6-frame fixture's, byte
    for byte;
  * `--cpu --tiny` trains two epochs and writes the JAX tool's keys, and
    novel_pose_eval --cpu --tiny reads its checkpoint;
  * graph_noise's scenes start from a checkpoint's state with --ckpt.
"""
import filecmp
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from neuralbody_tpu.train.optimizer import make_lr_schedule as j_schedule
from neuralbody_tpu_torch.tools import convergence_run, graph_noise
from neuralbody_tpu_torch.tools import novel_pose_eval
from neuralbody_tpu_torch.train.optimizer import lr_schedule_from_cfg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_run", os.path.join(REPO, "tools",
                                            "convergence_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tiny", [False, True])
def test_config_equals_the_jax_tools(jax_tool, tiny):
    args = ("/data/CoreView_999", "/work")
    kw = dict(tiny=tiny, n_cams=4 if tiny else 6, ep_iter=50 if tiny
              else 250)
    got = convergence_run.make_cfg(*args, **kw).to_dict()
    want = jax_tool.make_cfg(*args, **kw).to_dict()
    assert (got.pop("exp_name"), want.pop("exp_name")) == (
        "convergence", "convergence_r05")
    assert got == want
    assert got["trained_model_dir"] == "/work/trained"


@pytest.mark.parametrize("tiny", [False, True])
def test_lr_schedule_equals_the_jax_tools(jax_tool, tiny):
    args = ("/data/CoreView_999", "/work")
    kw = dict(tiny=tiny, n_cams=6, ep_iter=50 if tiny else 250)
    t_cfg = convergence_run.make_cfg(*args, **kw)
    sched, want = lr_schedule_from_cfg(t_cfg), j_schedule(
        jax_tool.make_cfg(*args, **kw))
    decay = t_cfg.train.scheduler.decay_epochs
    for epoch in (0, 1, 20, 40):
        step = epoch * t_cfg.ep_iter
        assert sched(step) == want(step)
        assert sched(step) == pytest.approx(5e-4 * 0.1 ** (epoch / decay),
                                            rel=1e-12)
    # the last step of an epoch is still that epoch's rate
    assert sched(2 * t_cfg.ep_iter - 1) == want(t_cfg.ep_iter)


def test_novel_pose_fixture_extends_the_training_one(tmp_path):
    six, n6 = convergence_run.fixture(str(tmp_path / "six"), 6, tiny=True)
    eight, n8 = convergence_run.fixture(str(tmp_path / "eight"), 8,
                                        tiny=True)
    assert n6 == n8 == 4
    a6 = np.load(f"{six}/annots.npy", allow_pickle=True).item()
    a8 = np.load(f"{eight}/annots.npy", allow_pickle=True).item()
    assert len(a6["ims"]) == 6 and len(a8["ims"]) == 8
    assert a8["ims"][:6] == a6["ims"]
    for k in a6["cams"]:
        np.testing.assert_array_equal(a6["cams"][k], a8["cams"][k])
    files = [im for frame in a6["ims"] for im in frame["ims"]]
    files += [f"mask_cihp/{im[:-4]}.png" for im in files]
    files += [f"{d}/{f}.npy" for d in ("vertices", "params")
              for f in range(6)]
    for rel in files:
        assert filecmp.cmp(f"{six}/{rel}", f"{eight}/{rel}",
                           shallow=False), rel


def test_tiny_run_and_novel_pose(tmp_path):
    """Two short epochs on the CPU, a held-out evaluation after each, the
    JSON with the JAX tool's keys; then the novel-pose tool on its
    checkpoint."""
    out = str(tmp_path / "quality.json")
    got = convergence_run.main([
        "--cpu", "--tiny", "--epochs", "2", "--eval-every", "1",
        "--workdir", str(tmp_path / "conv"), "--out", out])
    with open(os.path.join(REPO, "QUALITY_r05.json")) as f:
        jax_keys = set(json.load(f))
    with open(out) as f:
        written = json.load(f)
    assert written == got
    assert set(got) == jax_keys | {"card"}
    assert (got["platform"], got["card"], got["epochs"], got["steps"]) == (
        "cpu", None, 2, 100)
    assert [c["epoch"] for c in got["curve"]] == [1, 2]
    for c in got["curve"]:
        assert np.isfinite(c["psnr"]) and 0 <= c["ssim"] <= 1
    assert got["value"] == got["curve"][-1]["psnr"]
    assert sorted(os.listdir(tmp_path / "conv" / "trained")) == [
        "latest.ckpt"]

    out = str(tmp_path / "novelpose.json")
    np_got = novel_pose_eval.main([
        "--cpu", "--tiny", "--train-workdir", str(tmp_path / "conv"),
        "--workdir", str(tmp_path / "np"), "--out", out])
    with open(os.path.join(REPO, "NOVELPOSE_r05.json")) as f:
        assert set(np_got) == set(json.load(f)) | {"card"}
    assert np_got["trained_epochs"] == 2
    assert np.isfinite(np_got["value"]) and 0 <= np_got["ssim"] <= 1
    with pytest.raises(SystemExit, match="no checkpoint"):
        novel_pose_eval.main([
            "--cpu", "--tiny", "--train-workdir", str(tmp_path / "none"),
            "--workdir", str(tmp_path / "np"), "--out", out])


def test_plateau_rule():
    flat = [{"psnr": 20.0 + 0.01 * (i % 2), "ssim": 0.9} for i in range(10)]
    assert convergence_run.plateaued(flat)
    assert not convergence_run.plateaued(flat[:9])
    rising = flat[:-1] + [{"psnr": 20.0, "ssim": 0.95}]
    assert not convergence_run.plateaued(rising)


def test_graph_noise_starts_from_a_checkpoint(tmp_path):
    """--ckpt: a scene's init() gives the checkpoint's params, BN stats
    and Adam state (its frame latents too, and alpha_fc's bias as saved),
    in place of the seeded state with the raised bias."""
    from neuralbody_tpu_torch.models import latent_xyzc as lx
    from neuralbody_tpu_torch.train import optimizer
    from neuralbody_tpu_torch.train.checkpoint import save_checkpoint
    dev = torch.device("cpu")

    def schedule():
        return lambda t: 5e-4

    params, bn = lx.init(torch.Generator().manual_seed(7), num_train_frame=3,
                         nv=500, device=dev)
    opt = optimizer.build_optimizer(params, schedule())
    (a, _), settings, init = graph_noise._hat_scene(
        dev, "float32", 64, 500, 0.02, 16, 3, schedule)
    opt.mu = optimizer.tree_map(lambda x: torch.full_like(x, 0.25), opt.mu)
    opt.count = 9
    save_checkpoint(str(tmp_path), 4, params, bn, opt, {}, latest=True)

    _, _, ckpt_init = graph_noise._hat_scene(
        dev, "float32", 64, 500, 0.02, 16, 3, schedule, ckpt=str(tmp_path))
    p, b, o = ckpt_init()
    want = graph_noise.run_state(params, bn, opt, [])
    got = graph_noise.run_state(p, b, o, [])
    for g in ("params", "mu", "nu", "bn"):
        assert [k for k, _ in got[g]] == [k for k, _ in want[g]]
        for (k, x), (_, y) in zip(got[g], want[g]):
            assert torch.equal(x, y), k
    assert p["frame_latent"].shape[0] == 3 and o.count == 9
    seeded, _, _ = init()
    assert not torch.equal(seeded["alpha_fc"]["b"], p["alpha_fc"]["b"])
    # the trained state trains like a seeded one
    state = graph_noise.eager_run(dev, ckpt_init, [a, a], settings)
    assert all(torch.isfinite(t).all() for _, t in state["params"])
    with pytest.raises(SystemExit, match="full scene"):
        graph_noise.main(["--ckpt", str(tmp_path), "--scenes", "small"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        graph_noise._hat_scene(dev, "float32", 64, 500, 0.02, 16, 3,
                               schedule, ckpt=str(tmp_path / "none"))
