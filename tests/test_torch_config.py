"""The port's config system and factories (neuralbody_tpu_torch/config/,
the registered model_static / network / renderer / trainer factories)
against the JAX package's.

Everything here is exact: make_cfg's trees compare equal as dicts, and the
factories' settings compare field for field (floats included: both sides
compute them with the same Python arithmetic from the same config).
"""
import glob
import os
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import neuralbody_tpu.datasets  # noqa: F401  (registers plugins)
import neuralbody_tpu.evaluators  # noqa: F401
import neuralbody_tpu.models  # noqa: F401
import neuralbody_tpu.renderer  # noqa: F401
import neuralbody_tpu.train  # noqa: F401
import neuralbody_tpu.visualizers  # noqa: F401
from neuralbody_tpu import config as j_cfg
import neuralbody_tpu_torch.datasets  # noqa: F401  (registers plugins)
import neuralbody_tpu_torch.evaluators  # noqa: F401
import neuralbody_tpu_torch.models  # noqa: F401
import neuralbody_tpu_torch.renderer  # noqa: F401
import neuralbody_tpu_torch.train  # noqa: F401
import neuralbody_tpu_torch.visualizers  # noqa: F401
from neuralbody_tpu_torch import config as t_cfg
from neuralbody_tpu_torch.renderer.renderer import RenderSettings
from neuralbody_tpu_torch.renderer.tpose_renderer import TposeRenderSettings
from neuralbody_tpu_torch.renderer.volume_renderer import NerfRenderSettings
from neuralbody_tpu_torch.train import step as t_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs/**/*.yaml"),
                               recursive=True))
IDS = [os.path.relpath(p, REPO) for p in ALL_CONFIGS]
MODES = ["vis_novel_view", "vis_novel_pose", "vis_rotate_smpl", "vis_mesh"]
# a duck-typed dataset: the factories read only dataset.geo
DATASET = SimpleNamespace(geo=SimpleNamespace(
    out_sh=(224, 384, 96), site_caps=(8192, 6144, 3072, 1024, 256)),
    ptot_shape=(37, 96, 26))   # the T-pose family's warped grid


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return str(p)


class TestCfgNode:
    def test_attr_access(self):
        c = t_cfg.CfgNode({"a": 1, "b": {"c": 2}})
        assert c.a == 1 and c.b.c == 2
        c.b.d = 3
        assert c["b"]["d"] == 3
        with pytest.raises(AttributeError):
            c.missing

    def test_merge_recursive_and_list(self):
        c = t_cfg.CfgNode({"train": {"lr": 1e-4, "epoch": 10}, "flag": False})
        c.merge_from_other({"train": {"lr": 5e-4}})
        assert c.train.lr == 5e-4 and c.train.epoch == 10
        c.merge_from_list(["train.lr", "5e-4", "flag", "True",
                           "views", "[0, 6]", "new.deep", "1"])
        assert c.train.lr == pytest.approx(5e-4)
        assert c.flag is True and c.views == [0, 6] and c.new.deep == 1
        with pytest.raises(ValueError, match="even length"):
            c.merge_from_list(["odd"])

    def test_yaml_roundtrip(self, tmp_path):
        c = t_cfg.CfgNode({"a": 1, "b": {"c": [1, 2, 3]}})
        p = tmp_path / "c.yaml"
        p.write_text(c.dump_yaml())
        assert t_cfg.CfgNode.load_yaml(str(p)).to_dict() == c.to_dict()
        assert c.clone().to_dict() == c.to_dict()
        assert c.get_path("b.c") == [1, 2, 3] and c.get_path("b.x", 7) == 7


class TestMakeCfg:
    def test_defaults_equal_jax(self):
        assert t_cfg.default_cfg().to_dict() == j_cfg.default_cfg().to_dict()
        assert t_cfg.make_cfg().to_dict() == j_cfg.make_cfg().to_dict()

    def test_parent_merge_overlay_and_opts(self, tmp_path):
        parent = _write(tmp_path, "parent.yaml", """
            exp_name: parent_exp
            N_samples: 32
        """)
        child = _write(tmp_path, "child.yaml", f"""
            parent_cfg: {parent}
            exp_name: child_exp
            novel_view_cfg:
                renderer_module: if_clight_renderer_mmsk
                ratio: 0.5
        """)
        cfg = t_cfg.make_cfg(child)
        assert (cfg.exp_name, cfg.N_samples, cfg.renderer_module) == (
            "child_exp", 32, "if_clight_renderer")
        opts = ["vis_novel_view", "True", "ratio", "0.25"]
        cfg = t_cfg.make_cfg(child, opts=opts)
        assert cfg.renderer_module == "if_clight_renderer_mmsk"
        assert cfg.ratio == 0.25      # CLI opts beat the overlay
        assert cfg.to_dict() == j_cfg.make_cfg(child, opts=opts).to_dict()

    def test_derived_dirs_and_args(self):
        cfg = t_cfg.make_cfg(opts=["task", "if_nerf", "exp_name", "x"])
        assert cfg.trained_model_dir.endswith(os.path.join("if_nerf", "x"))
        argv = ["--type", "evaluate", "N_rand", "512"]
        cfg, args = t_cfg.make_cfg_from_args(argv)
        jcfg, jargs = j_cfg.make_cfg_from_args(argv)
        assert cfg.to_dict() == jcfg.to_dict()
        assert vars(args) == vars(jargs) and cfg.N_rand == 512


class TestRegistry:
    def test_register_resolve(self):
        @t_cfg.register("thing", "widget")
        class Widget:
            pass

        assert t_cfg.resolve("thing", "widget") is Widget
        assert t_cfg.resolve("thing", "lib.things.widget") is Widget
        assert t_cfg.resolve("thing", "lib.things.widget.py") is Widget
        assert t_cfg.build("thing", "widget").__class__ is Widget
        assert "widget" in t_cfg.registered("thing")

    @pytest.mark.parametrize("kind,name", [
        ("network", "nope"), ("model_static", "nope"),
        ("renderer", "nope"),
        ("visualizer", "nope"), ("trainer", "nope"),
        ("dataset", "nope"), ("evaluator", "nope"),
        ("thing", "nope")])
    def test_unregistered_names_raise(self, kind, name):
        with pytest.raises(KeyError):
            t_cfg.resolve(kind, name)

    def test_the_port_registers_what_it_has(self):
        want = {"network": ["latent_xyzc", "nerf", "nerf_mesh",
                            "tpose_xyzc"],
                "model_static": ["latent_xyzc", "nerf", "nerf_mesh",
                                 "tpose_xyzc"],
                "renderer": ["if_clight_renderer", "if_clight_renderer_mmsk",
                             "if_clight_renderer_msk", "if_mesh_renderer",
                             "tpose_renderer", "volume_mesh_renderer",
                             "volume_renderer"],
                "trainer": ["if_nerf_clight", "nerf", "tpose"],
                "dataset": ["monocular", "monocular_demo", "monocular_mesh",
                            "multi_view", "multi_view_demo",
                            "multi_view_mesh", "multi_view_perform",
                            "rotate_smpl", "tpose"],
                "evaluator": ["if_nerf", "if_nerf_mesh", "neural_volume"],
                "visualizer": ["if_nerf", "if_nerf_demo", "if_nerf_mesh",
                               "if_nerf_perform", "if_nerf_test"]}
        for kind, names in want.items():
            assert t_cfg.registered(kind) == names, kind
            for n in names:
                assert n in j_cfg.registered(kind), (kind, n)
        for kind in ("network", "renderer", "trainer"):
            for n in t_cfg.registered(kind):
                assert t_cfg.resolve(kind, n).__name__ == j_cfg.resolve(
                    kind, n).__name__, (kind, n)


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=IDS)
def test_every_yaml_gives_the_jax_tree(path, monkeypatch):
    monkeypatch.chdir(REPO)  # parent_cfg paths are repo-relative
    assert t_cfg.make_cfg(path).to_dict() == j_cfg.make_cfg(path).to_dict()


@pytest.mark.parametrize("mode", MODES)
def test_313_mode_overlays_give_the_jax_tree(mode, monkeypatch):
    monkeypatch.chdir(REPO)
    path = "configs/zju_mocap_exp/latent_xyzc_313.yaml"
    cfg = t_cfg.make_cfg(path, opts=[mode, "True"])
    assert cfg.to_dict() == j_cfg.make_cfg(path, opts=[mode, "True"]).to_dict()
    assert cfg.renderer_module in t_cfg.registered("renderer") or \
        mode == "vis_mesh" and cfg.renderer_module == "if_mesh_renderer"


def _fields(x):
    """A NamedTuple as a dict, nested statics included."""
    if hasattr(x, "_asdict"):
        return {k: _fields(v) for k, v in x._asdict().items()}
    return x


def _ported(cfg):
    return (cfg.network_module in t_cfg.registered("network")
            and cfg.renderer_module in t_cfg.registered("renderer"))


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=IDS)
def test_factories_build_the_jax_settings(path, monkeypatch):
    """For every YAML whose network and renderer the port registers: the
    model_static and renderer factories give the JAX package's statics and
    settings, field for field, over one duck-typed dataset; the trainer is
    the port's loss_fn. Others raise resolve's KeyError."""
    monkeypatch.chdir(REPO)
    tcfg, jcfg = t_cfg.make_cfg(path), j_cfg.make_cfg(path)
    if not _ported(tcfg):
        with pytest.raises(KeyError):
            t_cfg.resolve("network", tcfg.network_module)
            t_cfg.resolve("renderer", tcfg.renderer_module)
        return
    ts = t_cfg.build("model_static", tcfg.network_module, tcfg, DATASET)
    js = j_cfg.build("model_static", jcfg.network_module, jcfg, DATASET)
    tr = t_cfg.build("renderer", tcfg.renderer_module, tcfg, ts)
    jr = j_cfg.build("renderer", jcfg.renderer_module, jcfg, js)
    assert type(tr).__name__ == type(jr).__name__
    assert isinstance(tr, (RenderSettings, NerfRenderSettings,
                           TposeRenderSettings))
    want, got = _fields(jr), _fields(tr)
    if isinstance(tr, RenderSettings):
        # the port's own field: the sharded steps' group split
        assert got.pop("group_shard") is None
    if isinstance(tr, (RenderSettings, TposeRenderSettings)):
        assert want["model"]["encoder"].pop("use_pallas") is False
        # the port's own field: the batch-mode step's synced BatchNorm
        assert got["model"]["encoder"].pop("bn_sum") is None
    assert got == want
    if "trainer_module" in tcfg:
        assert t_cfg.build("trainer", tcfg.trainer_module, tcfg) is \
            t_step.loss_fn


@pytest.mark.parametrize("path", [
    "configs/zju_mocap_exp/latent_xyzc_313.yaml", "configs/nerf/nerf_313.yaml",
    "configs/zju_mocap_exp/xyzc_rotate_demo_313.yaml"])
def test_network_factories_give_the_jax_tree(path, monkeypatch):
    """The network factory's init_fn draws a parameter tree of the JAX
    init_fn's structure, shapes and dtypes (weights from a torch.Generator
    on the CPU, keyed like the JAX pytree)."""
    monkeypatch.chdir(REPO)
    for opts in ([], ["network_module", "nerf_mesh"]) if "nerf" in path \
            else ([],):
        tcfg, jcfg = (t_cfg.make_cfg(path, opts=opts),
                      j_cfg.make_cfg(path, opts=opts))
        t_init, t_mod = t_cfg.build("network", tcfg.network_module, tcfg)
        j_init, _ = j_cfg.build("network", jcfg.network_module, jcfg)
        tp, tbn = t_init(torch.Generator().manual_seed(0), device="cpu")
        jp, jbn = jax.eval_shape(j_init, jax.random.PRNGKey(0))
        tflat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: np.zeros(t.shape, str(t.dtype)[6:]),
                         (tp, tbn)))[0]
        jflat = jax.tree_util.tree_flatten_with_path((jp, jbn))[0]
        assert [p for p, _ in tflat] == [p for p, _ in jflat]
        for (path_, t), (_, j) in zip(tflat, jflat):
            assert (t.shape, t.dtype) == (j.shape, j.dtype), path_
        assert t_mod.__name__.startswith("neuralbody_tpu_torch.models.")
