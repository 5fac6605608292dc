"""Parity of the port's mesh path with the JAX package (mirrors
tests/test_mesh.py): the iso-surface (csrc/iso_surface.cpp, the same C++
as native/iso_surface.cpp, built by utils/cuda_build into build/), the
PLY reader and writer, and renderer/mesh.extract_mesh over
render_density_grid (latent_xyzc) and render_nerf_density_grid (the NeRF
baseline), on the CPU at a small size with weights transplanted from the
JAX package's init.

Tolerances:
  * marching_cubes: bit for bit against the JAX binding (the same source),
    the sources byte for byte.
  * the PLY files: byte for byte, and read back exactly.
  * the density cube: 1e-4 of its scale (f32 sums in another order); the
    JAX cube through the port's marching_cubes gives the JAX mesh exactly.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models import nerf as j_nerf
from neuralbody_tpu.models.sparse_conv_net import EncoderStatic as JEnc
from neuralbody_tpu.renderer import volume_renderer as j_vr
from neuralbody_tpu.renderer.mesh import extract_mesh as j_extract
from neuralbody_tpu.renderer.renderer import RenderSettings as JSettings
from neuralbody_tpu.utils import mcubes as j_mcubes
from neuralbody_tpu.utils import mesh_io as j_io
from neuralbody_tpu.utils.synthetic import make_batch
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import nerf as t_nerf
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic as TEnc
from neuralbody_tpu_torch.renderer import volume_renderer as t_vr
from neuralbody_tpu_torch.renderer.mesh import extract_mesh as t_extract
from neuralbody_tpu_torch.renderer.renderer import RenderSettings as TSettings
from neuralbody_tpu_torch.utils import mcubes as t_mcubes
from neuralbody_tpu_torch.utils import mesh_io as t_io
from neuralbody_tpu_torch.utils.transplant import params_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE_TOL = 1e-4


def _grids(rng):
    n = 32
    c, r = (n - 1) / 2.0, 10.0
    g = np.mgrid[:n, :n, :n].astype(np.float32)
    sphere = r - np.sqrt(((g - c) ** 2).sum(0))
    box = np.zeros((16, 16, 16), np.float32)
    box[4:12, 4:12, 4:12] = 10.0
    noise = rng.rand(12, 9, 14).astype(np.float32)
    return {"sphere": (sphere, 0.0), "box": (box, 5.0),
            "noise": (noise, 0.5), "empty": (np.zeros((8, 8, 8)), 0.5)}


def test_iso_surface_source_is_the_jax_packages():
    assert filecmp.cmp(t_mcubes.SOURCE,
                       os.path.join(REPO, "native", "iso_surface.cpp"),
                       shallow=False)


@pytest.mark.parametrize("name", ["sphere", "box", "noise", "empty"])
def test_marching_cubes_bit_equal(rng, name):
    grid, iso = _grids(rng)[name]
    v, t = t_mcubes.marching_cubes(grid, iso)
    jv, jt = j_mcubes.marching_cubes(grid, iso)
    assert v.dtype == np.float32 and t.dtype == np.int32
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_sphere_surface():
    """tests/test_mesh.py's sphere: on the sphere within a voxel,
    watertight."""
    n = 32
    c, r = (n - 1) / 2.0, 10.0
    g = np.mgrid[:n, :n, :n].astype(np.float32)
    verts, tris = t_mcubes.marching_cubes(r - np.sqrt(((g - c) ** 2).sum(0)),
                                          0.0)
    assert len(verts) > 100 and len(tris) > 100
    radii = np.linalg.norm(verts - c, axis=1)
    assert abs(radii.mean() - r) < 0.2 and radii.std() < 0.2
    assert tris.min() >= 0 and tris.max() < len(verts)
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_marching_cubes_refuses_a_flat_grid():
    with pytest.raises(ValueError, match="3-D"):
        t_mcubes.marching_cubes(np.zeros((4, 4), np.float32), 0.5)


def test_ply_roundtrip_across_packages(tmp_path, rng):
    v = rng.randn(10, 3).astype(np.float32)
    f = rng.randint(0, 10, (5, 3)).astype(np.int32)
    t_path, j_path = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    t_io.save_ply(t_path, v, f)
    j_io.save_ply(j_path, v, f)
    assert filecmp.cmp(t_path, j_path, shallow=False)
    for path in (t_path, j_path):
        v2, f2 = t_io.load_ply(path)
        np.testing.assert_array_equal(v, v2)
        np.testing.assert_array_equal(f, f2)
    # vertices only, and an ascii file as common tools write it
    t_io.save_ply(t_path, v)
    v2, f2 = t_io.load_ply(t_path)
    np.testing.assert_array_equal(v, v2)
    assert f2 is None
    ascii_path = tmp_path / "a.ply"
    ascii_path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for load in (t_io.load_ply, j_io.load_ply):
        va, fa = load(str(ascii_path))
        np.testing.assert_array_equal(fa, [[0, 1, 2]])
    np.testing.assert_array_equal(t_io.load_ply(str(ascii_path))[0],
                                  j_io.load_ply(str(ascii_path))[0])


def _cfgs(mesh_th, voxel, chunk):
    out = []
    for make in (j_make_cfg, t_make_cfg):
        cfg = make()
        cfg.mesh_th = mesh_th
        cfg.voxel_size = [voxel] * 3
        cfg.tpu.mesh_pt_chunk = chunk
        out.append(cfg)
    return out


def _assert_meshes(j_out, t_out):
    scale = max(1.0, float(np.abs(j_out["cube"]).max()))
    assert t_out["cube"].shape == j_out["cube"].shape
    np.testing.assert_allclose(t_out["cube"], j_out["cube"], rtol=0,
                               atol=CUBE_TOL * scale)
    assert len(t_out["vertices"]) > 0 and len(t_out["triangles"]) > 0
    # the JAX cube through the port's iso-surface gives the JAX mesh
    v, t = t_mcubes.marching_cubes(j_out["cube"], j_out["iso"])
    np.testing.assert_array_equal(v, j_out["grid_vertices"])
    np.testing.assert_array_equal(t, j_out["triangles"])


@pytest.mark.parametrize("chunk", [24 ** 3, 24 ** 3 // 4])
def test_extract_mesh_latent_xyzc(chunk):
    """tests/test_mesh.py's pipeline: a synthetic body's density on a
    24^3 grid over its bounds (in one chunk and in four) -> the world
    mesh, from weights transplanted from the JAX package's init."""
    batch_np, static = make_batch(n_rays=16, n_verts=400, voxel_size=0.02,
                                  seed=7)
    jp, js = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4, nv=400)
    jp = jax.tree.map(np.asarray, jp)
    tp, _ = params_from_jax(jp, jax.tree.map(np.asarray, js))
    j_set = JSettings(model=j_lx.ModelStatic(encoder=JEnc(
        out_sh=static["out_sh"], site_caps=static["site_caps"])),
        voxel_size=(0.02,) * 3, n_samples=8)
    t_set = TSettings(model=t_lx.ModelStatic(encoder=TEnc(
        out_sh=static["out_sh"], site_caps=static["site_caps"])),
        voxel_size=(0.02,) * 3, n_samples=8)

    grid_shape = (24, 24, 24)
    bounds = np.asarray(batch_np["bounds"][0])
    lin = [np.linspace(bounds[0, a], bounds[1, a], grid_shape[a])
           for a in range(3)]
    pts = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    mesh_np = dict(batch_np, pts=pts[None].astype(np.float32))
    meta = {"inside": np.ones(grid_shape, bool), "grid_min_xyz": bounds[0]}

    # an iso strictly inside the density range, so a surface exists
    from neuralbody_tpu.renderer.renderer import render_density_grid
    alpha = np.asarray(render_density_grid(
        jp, jax.tree.map(jnp.asarray, mesh_np), j_set, pt_chunk=len(pts)))
    iso = float((alpha.min() + alpha.max()) / 2)
    j_cfg, t_cfg = _cfgs(iso, 0.02, chunk)
    j_out = j_extract(jp, jax.tree.map(jnp.asarray, mesh_np), meta, j_set,
                      j_cfg)
    t_out = t_extract(tp, mesh_np, meta, t_set, t_cfg, device="cpu")
    assert t_out["cube"].shape == tuple(s + 20 for s in grid_shape)
    _assert_meshes(dict(j_out, iso=iso), t_out)
    np.testing.assert_allclose(
        t_out["vertices"], (t_out["grid_vertices"] - 10.0) * 0.02
        + bounds[0].astype(np.float32), rtol=1e-6, atol=1e-6)


def test_extract_mesh_nerf():
    """The NeRF mesh baseline: the coarse trunk's density on a dense grid,
    picked by the settings' type."""
    jst, tst = j_nerf.NerfStatic(depth=2, width=32), t_nerf.NerfStatic(
        depth=2, width=32)
    jp, js = j_nerf.init(jax.random.PRNGKey(0), jst, jst)
    jp = jax.tree.map(np.asarray, jp)
    tp, _ = params_from_jax(jp, jax.tree.map(np.asarray, js))
    grid_shape = (16, 16, 16)
    lin = [np.linspace(-0.5, 0.5, s) for s in grid_shape]
    pts = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(
        1, -1, 3).astype(np.float32)
    j_set = j_vr.NerfRenderSettings(model=jst, model_fine=jst)
    t_set = t_vr.NerfRenderSettings(model=tst, model_fine=tst)
    alpha = np.asarray(j_vr.render_nerf_density_grid(
        jp, {"pts": jnp.asarray(pts)}, j_set, pt_chunk=1024))
    iso = float((alpha.min() + alpha.max()) / 2)
    j_cfg, t_cfg = _cfgs(iso, 0.0625, 1024)
    meta = {"inside": np.ones(grid_shape, bool),
            "grid_min_xyz": np.array([-0.5, -0.5, -0.5], np.float32)}
    j_out = j_extract(jp, {"pts": jnp.asarray(pts)}, meta, j_set, j_cfg)
    t_out = t_extract(tp, {"pts": pts}, meta, t_set, t_cfg, device="cpu")
    _assert_meshes(dict(j_out, iso=iso), t_out)


def test_extract_mesh_scatters_inside_points_only():
    """Points past the inside count (the dataset's padding) never reach
    the cube, and a point count that is no multiple of the chunk raises,
    as the port's density grids do (ROADMAP.md, "differs on purpose")."""
    st = t_nerf.NerfStatic(depth=2, width=32)
    tp, _ = t_nerf.init(torch.Generator().manual_seed(0), st, st,
                        device="cpu")
    settings = t_vr.NerfRenderSettings(model=st, model_fine=st)
    inside = np.zeros((8, 8, 8), bool)
    inside[2:6, 2:6, 2:6] = True
    pts = np.zeros((1, 128, 3), np.float32)
    pts[0, :64] = np.argwhere(inside) / 8.0 - 0.5
    _, cfg = _cfgs(0.0, 0.125, 64)
    meta = {"inside": inside, "grid_min_xyz": np.zeros(3, np.float32)}
    out = t_extract(tp, {"pts": pts}, meta, settings, cfg, device="cpu")
    cube = out["cube"][10:-10, 10:-10, 10:-10]
    assert (cube[~inside] == 0).all() and (cube[inside] != 0).any()
    cfg.tpu.mesh_pt_chunk = 48
    with pytest.raises(ValueError, match="multiple"):
        t_extract(tp, {"pts": pts}, meta, settings, cfg, device="cpu")


def test_load_ply_refuses_a_file_without_a_header(tmp_path):
    """A file that ends before end_header raises (the JAX reader reads
    such a file for ever)."""
    path = tmp_path / "bad.ply"
    path.write_bytes(b"ply\nformat binary_little_endian 1.0\n")
    with pytest.raises(ValueError, match="end_header"):
        t_io.load_ply(str(path))


def test_render_mesh_tool_equals_the_repositorys(tmp_path):
    """tools/render_mesh's rasterizer, the port's against the repository's
    on an extracted sphere (bit for bit), and its CLI over a ply dir."""
    import importlib.util

    import cv2

    from neuralbody_tpu_torch.tools import render_mesh
    spec = importlib.util.spec_from_file_location(
        "root_render_mesh", os.path.join(REPO, "tools", "render_mesh.py"))
    root_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_tool)
    n = 16
    g = np.mgrid[:n, :n, :n].astype(np.float32)
    verts, tris = t_mcubes.marching_cubes(
        5.0 - np.sqrt(((g - 7.5) ** 2).sum(0)), 0.0)
    for az in (0.0, 1.3):
        img = render_mesh.rasterize(verts, tris, size=48, azimuth=az)
        np.testing.assert_array_equal(
            img, root_tool.rasterize(verts, tris, size=48, azimuth=az))
        assert img.max() > 0
    (tmp_path / "mesh").mkdir()
    t_io.save_ply(str(tmp_path / "mesh" / "0000.ply"), verts, tris)
    render_mesh.main(["--mesh_dir", str(tmp_path / "mesh"), "--out_dir",
                      str(tmp_path / "out"), "--num_views", "2",
                      "--size", "32"])
    assert sorted(os.listdir(tmp_path / "out")) == ["0000_000.png",
                                                    "0000_001.png"]
    assert cv2.imread(str(tmp_path / "out" / "0000_000.png")).max() > 0
