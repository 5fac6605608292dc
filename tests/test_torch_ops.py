"""Parity of the PyTorch port's host code and point-wise ops with the JAX
package, on the CPU at a small size (~500 vertices, 2 cm voxels, 64 rays
x 8 samples).

Host code (rulebook, planner, synthetic batch) must give EQUAL arrays.
Device ops in f32 match at atol/rtol 1e-5 (sums in another order).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.ops import compositing as j_comp
from neuralbody_tpu.ops import embedder as j_emb
from neuralbody_tpu.ops import hat_interp as j_hat
from neuralbody_tpu.ops import sparse_conv as j_sc
from neuralbody_tpu.ops.pallas_hat import hat_contract_fused
from neuralbody_tpu.renderer import renderer as j_rend
from neuralbody_tpu.utils import synthetic as j_syn
from neuralbody_tpu_torch.ops import compositing as t_comp
from neuralbody_tpu_torch.ops import embedder as t_emb
from neuralbody_tpu_torch.ops import hat_interp as t_hat
from neuralbody_tpu_torch.ops import hat_kernel
from neuralbody_tpu_torch.ops import sparse_conv as t_sc
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.utils import synthetic as t_syn
from neuralbody_tpu_torch.utils.platform import resolve_device, to_device

torch.set_num_threads(1)

VOX = 0.02
N_RAYS = 64
N_SAMPLES = 8
TOL = dict(atol=1e-5, rtol=1e-5)


def assert_trees_equal(a, b, path=""):
    """Same keys, dtypes and values, all the way down."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def frame():
    xyz = j_syn.ellipsoid_vertices(500, seed=3)
    coord, out_sh, _ = j_syn.voxelize(xyz, VOX)
    caps = j_sc.compute_site_caps([coord], out_sh)
    return coord, out_sh, caps


@pytest.fixture(scope="module")
def base_batch():
    batch, static = j_syn.make_batch(n_rays=N_RAYS, n_verts=500,
                                     voxel_size=VOX, seed=3)
    return batch, static


# -- (a) host rulebook and planner ------------------------------------------

@pytest.mark.parametrize("fixed_fix_caps", [False, True])
def test_build_frame_geometry_equal(frame, fixed_fix_caps):
    coord, out_sh, caps = frame
    fix = (j_sc.compute_fix_caps([coord], out_sh, caps)
           if fixed_fix_caps else None)
    if fixed_fix_caps:
        assert t_sc.compute_fix_caps([coord], out_sh, caps) == fix
    assert_trees_equal(j_sc.build_frame_geometry(coord, out_sh, caps, fix),
                       t_sc.build_frame_geometry(coord, out_sh, caps, fix))


def test_rulebook_helpers_equal(frame):
    coord, out_sh, caps = frame
    assert t_sc.compute_site_caps([coord], out_sh) == caps
    assert t_sc.measure_site_counts(coord, out_sh) == \
        j_sc.measure_site_counts(coord, out_sh)
    sites, inv = t_sc.dedup_sites(coord, out_sh)
    js, jinv = j_sc.dedup_sites(coord, out_sh)
    np.testing.assert_array_equal(sites, js)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(t_sc.downsample_sites(sites, out_sh),
                                  j_sc.downsample_sites(js, out_sh))


@pytest.mark.parametrize("quantize_z", [False, True])
@pytest.mark.parametrize("static_caps", [False, True])
def test_prepare_hat_batch_equal(base_batch, quantize_z, static_caps):
    batch, static = base_batch
    kw = dict(group_size=32, rng=None, quantize_z=quantize_z)
    jb, jhs = j_hat.prepare_hat_batch(dict(batch), static["out_sh"],
                                      static["site_caps"], (VOX,) * 3,
                                      N_SAMPLES, **kw)
    if static_caps:
        # given static sizes: the JAX package may take its native planner
        kw.update(rows_caps=jhs["rows_caps"], seg_caps=jhs["seg_caps"],
                  n_groups=jhs["n_groups"] + 2)
        jb, jhs = j_hat.prepare_hat_batch(dict(batch), static["out_sh"],
                                          static["site_caps"], (VOX,) * 3,
                                          N_SAMPLES, **kw)
    tb, ths = t_hat.prepare_hat_batch(dict(batch), static["out_sh"],
                                      static["site_caps"], (VOX,) * 3,
                                      N_SAMPLES, **kw)
    assert ths == jhs
    assert_trees_equal(jb, tb)
    if quantize_z:
        np.testing.assert_array_equal(
            t_hat.decode_z_np(tb["z_frac"][0], tb["near"][0], tb["far"][0]),
            j_hat.decode_z_np(jb["z_frac"][0], jb["near"][0], jb["far"][0]))
    np.testing.assert_array_equal(
        t_hat.sorted_pts_np(tb, 0, N_SAMPLES)[0],
        j_hat.sorted_pts_np(jb, 0, N_SAMPLES)[0])


@pytest.mark.parametrize("kw", [dict(hat=True, hat_perturb=False),
                                dict(hat=True, batch_size=2, num_views=2,
                                     img_hw=(32, 32))])
def test_make_batch_equal(kw):
    args = dict(n_rays=N_RAYS, n_verts=500, voxel_size=VOX, seed=3,
                n_samples=N_SAMPLES, **kw)
    jb, js = j_syn.make_batch(**args)
    tb, ts = t_syn.make_batch(**args)
    assert js == ts
    assert_trees_equal(jb, tb)


def test_expand_segments_np_equal(base_batch):
    batch, static = base_batch
    tb, hs = t_hat.prepare_hat_batch(dict(batch), static["out_sh"],
                                     static["site_caps"], (VOX,) * 3,
                                     N_SAMPLES, group_size=32)
    for li, l in enumerate((1, 2, 3, 4)):
        args = (tb[f"hat_seg_a{l}"][0], tb[f"hat_seg_cum{l}"][0],
                hs["rows_caps"][li], static["site_caps"][l])
        np.testing.assert_array_equal(t_hat.expand_segments_np(*args),
                                      j_hat.expand_segments_np(*args))


# -- (b) point-wise ops and the de-sort -------------------------------------

@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding(num_freqs):
    x = np.random.RandomState(0).uniform(-2, 2, (50, 3)).astype(np.float32)
    ref = np.asarray(j_emb.positional_encoding(jnp.asarray(x), num_freqs))
    out = t_emb.positional_encoding(torch.from_numpy(x), num_freqs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs(white_bkgd):
    rng = np.random.RandomState(1)
    raw = rng.randn(32, 16, 4).astype(np.float32) * 3
    raw[:4, :, 3] = -5.0  # empty rays: the NaN-safe disparity
    z = np.sort(rng.uniform(1, 4, (32, 16)), axis=1).astype(np.float32)
    d = rng.randn(32, 3).astype(np.float32)
    ref = j_comp.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                             jnp.asarray(d), white_bkgd=white_bkgd)
    out = t_comp.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                             torch.from_numpy(d), white_bkgd=white_bkgd)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_expand_segments_matches_jax(base_batch):
    batch, static = base_batch
    tb, hs = t_hat.prepare_hat_batch(dict(batch), static["out_sh"],
                                     static["site_caps"], (VOX,) * 3,
                                     N_SAMPLES, group_size=32)
    for li, l in enumerate((1, 2, 3, 4)):
        a = tb[f"hat_seg_a{l}"][0].astype(np.int32)
        c = tb[f"hat_seg_cum{l}"][0].astype(np.int32)
        cap, sent = hs["rows_caps"][li], static["site_caps"][l]
        ref = np.asarray(j_hat.expand_segments(jnp.asarray(a),
                                               jnp.asarray(c), cap, sent))
        out = t_hat.expand_segments(torch.from_numpy(a), torch.from_numpy(c),
                                    cap, sent)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)


def test_inverse_perm_first_occurrence():
    """The case of tests/test_hat_interp.py:test_inverse_perm_first_
    occurrence, on the planner's own hat_sort."""
    batch, _ = j_syn.make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX,
                                seed=3, hat=True, n_samples=N_SAMPLES,
                                hat_perturb=False)
    srt = np.asarray(batch["hat_sort"][0]).astype(np.int64)
    n = N_RAYS * N_SAMPLES
    ref = np.empty(n, np.int64)
    ref[srt[::-1]] = np.arange(len(srt) - 1, -1, -1)
    out = t_hat.inverse_perm(torch.from_numpy(srt.astype(np.int32)), n)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_inverse_perm_matches_jax():
    rng = np.random.RandomState(2)
    n = 300
    perm = np.concatenate([rng.permutation(n),
                           rng.randint(0, n, 84)]).astype(np.int32)
    rng.shuffle(perm)
    ref = np.asarray(j_hat.inverse_perm(jnp.asarray(perm), n))
    np.testing.assert_array_equal(
        t_hat.inverse_perm(torch.from_numpy(perm), n).numpy(), ref)


def test_decode_z_bit_exact():
    """The device decode multiplies by f32(1/65535) exactly as the host
    planner does: a one-ulp difference could move a point out of its
    group's rows."""
    rng = np.random.RandomState(3)
    q = rng.randint(0, 65536, (64, 8)).astype(np.uint16)
    near = rng.uniform(1, 3, 64).astype(np.float32)
    far = near + rng.uniform(0.5, 3, 64).astype(np.float32)
    t = to_device({"q": q, "near": near, "far": far}, "cpu")
    assert t["q"].dtype == torch.int32
    np.testing.assert_array_equal(
        t_hat.decode_z(t["q"], t["near"], t["far"]).numpy(),
        t_hat.decode_z_np(q, near, far))


# -- (d) one level of the hat contraction -----------------------------------

def _level_inputs(rng, ngrp, P, capR, C, capS):
    feats = rng.randn(capS, C).astype(np.float32)
    sites = rng.randint(0, 6, (capS, 3)).astype(np.int32)
    sites[-2:] = 2 ** 30                       # padded site rows
    rows = rng.randint(0, capS, (ngrp, capR)).astype(np.int32)
    rows[:, -3:] = capS                        # sentinel rows
    pos = rng.uniform(0, 6, (ngrp, P, 3)).astype(np.float32)
    return feats, sites, rows, pos


def test_hat_level_plain_f32_matches_jax():
    feats, sites, rows, pos = _level_inputs(np.random.RandomState(4),
                                            5, 16, 48, 24, 40)
    ref = np.asarray(j_hat.hat_interp_level(
        jnp.asarray(feats), jnp.asarray(sites), jnp.asarray(rows),
        jnp.asarray(pos)))
    out = hat_kernel.hat_interp_level_plain(
        *map(torch.from_numpy, (feats, sites, rows, pos)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_hat_level_plain_bf16_matches_pallas_interpret():
    """At tests/test_pallas_hat.py's shapes: the Pallas kernel in
    interpret mode on the rows the plain version gathers, 1e-5."""
    NGRP, P, CAPR, C = 4, 16, 32, 8
    capS = 24
    rng = np.random.RandomState(0)
    feats, sites, rows, pos = _level_inputs(rng, NGRP, P, CAPR, C, capS)
    f_bf = torch.from_numpy(feats).bfloat16()
    t_args = (torch.from_numpy(sites), torch.from_numpy(rows),
              torch.from_numpy(pos))
    out = hat_kernel.hat_interp_level_plain(f_bf, *t_args)

    fpad = np.concatenate([f_bf.float().numpy(), np.zeros((1, C),
                                                          np.float32)])
    spad = np.concatenate([sites.astype(np.float32),
                           np.full((1, 3), 1e9, np.float32)])
    rf = jnp.asarray(fpad[rows]).astype(jnp.bfloat16)
    rc = jnp.asarray(spad[rows])
    ref = jax.jit(lambda *a: hat_contract_fused(*a, interpret=True))(
        rf, rc, jnp.asarray(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # rows at a far-away coordinate contribute exactly 0: zeroing the
    # features of the padded site rows (coordinate 2**30, as the sentinel
    # row's 1e9) changes nothing
    f0 = f_bf.clone()
    f0[-2:] = 0
    np.testing.assert_array_equal(
        hat_kernel.hat_interp_level_plain(f0, *t_args).numpy(), out.numpy())


def test_hat_level_wrapper_writes_column_slice():
    feats, sites, rows, pos = map(torch.from_numpy, _level_inputs(
        np.random.RandomState(5), 3, 8, 16, 16, 20))
    buf = torch.full((3, 8, 40), -7.0)
    before = hat_kernel.LAUNCHES
    res = hat_kernel.hat_interp_level(feats, sites, rows, pos,
                                      out=buf[..., 8:24])
    assert hat_kernel.LAUNCHES == before   # the CPU runs the plain version
    ref = hat_kernel.hat_interp_level_plain(feats, sites, rows, pos)
    np.testing.assert_array_equal(buf[..., 8:24].numpy(), ref.numpy())
    np.testing.assert_array_equal(res.numpy(), ref.numpy())
    assert (buf[..., :8] == -7).all() and (buf[..., 24:] == -7).all()


def test_sort_rows_gives_each_level_its_run():
    """ops/hat_kernel.sort_rows, the backward's one sort of every level's
    row ids: level l's entries are one run of the sorted keys, its ids
    (clamped to [-1, capS]) plus key_base in order, each entry's flat index
    plus order_base, equal ids in flat-index order (a stable sort)."""
    from neuralbody_tpu_torch.ops.hat_kernel import sort_rows
    g = torch.Generator().manual_seed(0)
    levels = [(torch.randint(0, 41, (5, 7), generator=g, dtype=torch.int32),
               40),
              (torch.randint(0, 11, (5, 3), generator=g, dtype=torch.int32),
               10)]
    levels[1][0][0, 0] = 99              # past the sentinel: clamped
    out = sort_rows(levels)
    start = 0
    for (rows, capS), (keys, order, key_base, order_base) in zip(levels,
                                                                 out):
        flat = rows.reshape(-1).clamp(-1, capS)
        assert order_base == start and keys.numel() == flat.numel()
        idx = order - order_base
        assert torch.equal(keys - key_base, flat[idx])
        assert sorted(idx.tolist()) == list(range(flat.numel()))
        pairs = list(zip((keys - key_base).tolist(), idx.tolist()))
        assert pairs == sorted(pairs)
        start += flat.numel()
    assert out[1][2] == out[0][2] + 40 + 2


# -- hull masks --------------------------------------------------------------

def _hull_inputs(rng, V=2, HW=(24, 32)):
    wpts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    K = np.array([[20.0, 0, HW[1] / 2], [0, 20.0, HW[0] / 2], [0, 0, 1]],
                 np.float32)
    RT = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    RT[:, 2, 3] = 4.0
    RT[-1, 0, 3] = 0.3
    msks = (rng.uniform(size=(V,) + HW) > 0.3).astype(np.float32)
    return wpts, np.tile(K, (V, 1, 1)), RT, msks


def test_hull_inside_mask():
    wpts, Ks, RT, msks = _hull_inputs(np.random.RandomState(6))
    ref = np.asarray(j_rend.hull_inside_mask(
        *map(jnp.asarray, (wpts, Ks, RT, msks)), (24, 32)))
    out = t_rend.hull_inside_mask(
        *map(torch.from_numpy, (wpts, Ks, RT, msks)), (24, 32))
    assert 0 < ref.sum() < len(ref)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_snapshot_hull_mask():
    rng = np.random.RandomState(7)
    wpts, Ks, RT, msks = _hull_inputs(rng, V=1)
    c, s = np.cos(0.2), np.sin(0.2)
    frame = {"R": np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32),
             "Th": np.array([[0.1, 0.0, 0.2]], np.float32)}
    R0 = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    Th0 = np.array([0.0, 0.1, 0.0], np.float32)
    args = (wpts, R0, Th0, Ks[0], RT[0], msks[0])
    ref = np.asarray(j_rend.snapshot_hull_mask(
        jnp.asarray(wpts), jax.tree.map(jnp.asarray, frame),
        *map(jnp.asarray, args[1:]), (24, 32)))
    out = t_rend.snapshot_hull_mask(
        torch.from_numpy(wpts), to_device(frame, "cpu"),
        *map(torch.from_numpy, args[1:]), (24, 32))
    assert 0 < ref.sum() < len(ref)
    np.testing.assert_array_equal(out.numpy(), ref)


# -- (f) no silent CPU, (g) no JAX -------------------------------------------

def test_default_device_is_the_card():
    """Entry points default to CUDA; with no card present that raises
    rather than falling back to the CPU."""
    from neuralbody_tpu_torch.train.step import eval_step
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_step({}, {}, None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Every module of the port imports, and neither jax, flax (which
    imports jax) nor the JAX package is loaded afterwards."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import pkgutil, importlib, sys\n"
        "import neuralbody_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'neuralbody_tpu')]\n"
        "assert len(mods) >= 91, mods\n"
        "new = {p.__name__ + '.' + m for m in "
        "('ops.conv_kernel', 'ops.grid_sample', 'ops.ray_ops', "
        "'ops.dense_kernel', 'ops.sample_pdf', 'models.nerf', "
        "'renderer.volume_renderer', 'renderer.dispatch', "
        "'config', 'config.node', 'config.registry', 'config.defaults', "
        "'config.config', 'datasets', 'datasets.samplers', "
        "'datasets.ray_utils', 'datasets.frame_data', "
        "'datasets.zju_mocap', 'datasets.snapshot', 'datasets.loader', "
        "'ops.hat_planner_native', 'train.wrappers', 'train.fresh', "
        "'tools.graph_noise', 'tools.trace_loss', 'parallel.geom', "
        "'parallel.transfer', 'evaluators', 'evaluators.metrics', "
        "'evaluators.if_nerf', 'train.recorder', 'train.checkpoint', "
        "'train.trainer', 'utils.profiling', 'utils.fake_zju', "
        "'train_net', 'run', 'datasets.render_path', "
        "'datasets.demo_datasets', 'datasets.mesh_dataset', "
        "'renderer.mesh', 'utils.mesh_io', 'utils.mcubes', "
        "'utils.voxel_grid', 'utils.vis_skeleton', 'visualizers', "
        "'visualizers.visualizers', 'tools.convergence_run', "
        "'tools.novel_pose_eval', 'tools.dataset_tools', "
        "'tools.render_mesh', 'utils.smpl', 'utils.surface', "
        "'ops.blend', 'models.tpose_xyzc', 'renderer.tpose_renderer', "
        "'datasets.tpose_dataset', 'tools.prepare_warping', "
        "'tools.extract_vertices', 'tools.hat_bwd_cost', "
        "'parallel.bootstrap', 'parallel.mesh', 'parallel.train', "
        "'parallel.collectives', 'ops.device_plan')}\n"
        "assert new <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
