"""The port's VoxelGrid, skeleton plots and the mesh visualizer's voxel
debug view (mirrors tests/test_voxel_vis.py), each against the JAX
package's on the same inputs: host numpy, so every array and every file
is held bit for bit / byte for byte."""
import filecmp
import os

import numpy as np
import pytest
import torch

from neuralbody_tpu.utils import vis_skeleton as j_skel
from neuralbody_tpu.utils.voxel_grid import VoxelGrid as JGrid
from neuralbody_tpu_torch.utils import vis_skeleton as t_skel
from neuralbody_tpu_torch.utils.voxel_grid import VoxelGrid

torch.set_num_threads(1)


@pytest.fixture
def block_grid():
    data = np.zeros((8, 8, 8), bool)
    data[2:6, 2:6, 2:6] = True
    return VoxelGrid(data, loc=(1.0, 2.0, 3.0), scale=2.0)


def _random_grid(seed, n=10):
    rng = np.random.RandomState(seed)
    return rng.rand(n, n, n) > 0.6


class TestVoxelGrid:
    def test_to_mesh_exposed_faces(self, block_grid):
        verts, quads = block_grid.to_mesh()
        assert quads.shape == (6 * 16, 4)
        assert verts.shape == (5 * 5 * 5 - 3 * 3 * 3, 3)
        assert quads.min() >= 0 and quads.max() < len(verts)
        lo = np.array([1.0, 2.0, 3.0]) - 0.5
        hi = np.array([1.0, 2.0, 3.0]) + 0.5
        assert np.all(verts >= lo - 1e-6) and np.all(verts <= hi + 1e-6)
        assert set(range(len(verts))) == set(np.unique(quads))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_to_mesh_equals_the_jax_packages(self, seed):
        data = _random_grid(seed)
        v, q = VoxelGrid(data, loc=(0.5, -1.0, 2.0), scale=1.5).to_mesh()
        jv, jq = JGrid(data, loc=(0.5, -1.0, 2.0), scale=1.5).to_mesh()
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(q, jq)

    def test_contains_and_down_sample_equal_the_jax_packages(self):
        data = _random_grid(3, n=8)
        pts = np.random.RandomState(4).uniform(-1.5, 1.5, (200, 3))
        t, j = VoxelGrid(data, scale=2.0), JGrid(data, scale=2.0)
        np.testing.assert_array_equal(t.contains(pts), j.contains(pts))
        np.testing.assert_array_equal(t.down_sample(2).data,
                                      j.down_sample(2).data)
        with pytest.raises(ValueError):
            t.down_sample(3)

    def test_contains_round_trip(self, block_grid):
        inside = block_grid.contains(np.array([[1.0, 2.0, 3.0]]))
        outside = block_grid.contains(np.array([[1.9, 2.9, 3.9],
                                                [-5.0, 0.0, 0.0]]))
        assert inside.tolist() == [True]
        assert outside.tolist() == [False, False]

    def test_from_mesh_duck_typed(self):
        """from_mesh drives the trimesh voxelization protocol; a stand-in
        (trimesh is not installed) checks the index math."""

        class FakeVox:
            def __init__(self, points):
                self.points = points

            def fill(self):
                return self

        class FakeMesh:
            bounds = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])

            def copy(self):
                return self

            def apply_translation(self, t):
                self._t = t

            def apply_scale(self, s):
                self._s = s

            def voxelized(self, pitch):
                return FakeVox(np.array([[0.0, 0.0, 0.0],
                                         [0.2, -0.3, 0.1]]))

        vg = VoxelGrid.from_mesh(FakeMesh(), resolution=8)
        jg = JGrid.from_mesh(FakeMesh(), resolution=8)
        assert vg.resolution == 8 and vg.data[4, 4, 4]
        np.testing.assert_array_equal(vg.data, jg.data)
        np.testing.assert_array_equal(vg.loc, jg.loc)
        assert vg.scale == jg.scale


class TestSkeletonPlots:
    def test_plot_skel_3d_and_2d(self, tmp_path):
        matplotlib = pytest.importorskip("matplotlib")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        pts = np.random.RandomState(0).randn(24, 3) * 0.3
        ax = t_skel.plot_skel_3d(pts)
        ax.figure.savefig(tmp_path / "skel3d.png")
        plt.close("all")
        ax2 = t_skel.plot_skel_2d(pts[:, :2] * 100 + 128)
        ax2.figure.savefig(tmp_path / "skel2d.png")
        plt.close("all")
        assert (tmp_path / "skel3d.png").exists()
        assert (tmp_path / "skel2d.png").exists()

    def test_draw_on_image_equals_the_jax_packages(self):
        rng = np.random.RandomState(1)
        kpts = np.concatenate([rng.rand(24, 2) * 63, rng.rand(24, 1)], 1)
        corners = np.array([[x, y] for x in (5, 50) for y in (5, 50)])
        corners = np.concatenate([corners, corners + 5])
        outs = []
        for mod in (t_skel, j_skel):
            img = np.zeros((64, 64, 3), np.uint8)
            outs.append(mod.draw_bbox_3d(mod.draw_skeleton(img, kpts),
                                         corners))
        assert outs[0].shape == (64, 64, 3) and outs[0].sum() > 0
        np.testing.assert_array_equal(*outs)
        assert t_skel.SMPL_KINTREE == j_skel.SMPL_KINTREE


class TestMeshVisualizerVoxelDebug:
    def test_voxel_debug_ply_equals_the_jax_packages(self, tmp_path):
        import neuralbody_tpu.visualizers  # noqa: F401
        import neuralbody_tpu_torch.visualizers  # noqa: F401
        from neuralbody_tpu.config import build as j_build
        from neuralbody_tpu.config import make_cfg as j_make_cfg
        from neuralbody_tpu_torch.config import build, make_cfg

        cube = np.zeros((40, 40, 40), np.float32)
        cube[15:25, 15:25, 15:25] = 1.0  # above mesh_th after pad strip
        output = {"cube": cube,
                  "vertices": np.zeros((3, 3), np.float32),
                  "triangles": np.array([[0, 1, 2]], np.int32)}
        for name, mk, bd in (("t", make_cfg, build),
                             ("j", j_make_cfg, j_build)):
            cfg = mk(opts=["task", "if_nerf", "exp_name", "t"])
            cfg.result_dir = str(tmp_path / name)
            cfg.mesh_th = 0.5
            cfg.vis_voxel_debug = True
            bd("visualizer", "if_nerf_mesh", cfg).visualize(
                output, {}, {"frame_index": 7})
        for f in ("0007.ply", "0007_voxel.ply"):
            assert filecmp.cmp(tmp_path / "t" / "mesh" / f,
                               tmp_path / "j" / "mesh" / f, shallow=False)
        text = (tmp_path / "t" / "mesh" / "0007_voxel.ply").read_bytes()
        assert b"element face 1200" in text
        assert sorted(os.listdir(tmp_path / "t" / "mesh")) == [
            "0007.ply", "0007_voxel.ply"]
