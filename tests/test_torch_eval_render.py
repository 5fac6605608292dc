"""Parity of the PyTorch port's plan-free render (rays-only batches: the
site-interpolation and the dense branch of render_rays, and
render_density_grid) and of the modules under it with the JAX package, on
the CPU at a small size (~500 vertices, 2 cm voxels, 64 rays x 8 samples),
with weights from neuralbody_tpu's init through params_from_jax and inputs
from numpy seeds.

Tolerances:
  * scatters: equal (ints, and one feature row per voxel).
  * site_trilinear_sample, grid_sample_3d, the interpolated features and
    the raw field: atol/rtol 1e-5 (sums in another order).
  * stratified depths, perturb off: 1e-6 (linspace and the blend in another
    order of f32 operations). Perturb on draws other numbers than
    jax.random, so it is held to its own properties: inside its bins,
    reproducible from the generator's seed.
  * the composited maps, f32: 1e-4 relative with an absolute floor of 1e-6
    (tests/test_torch_render.py's).
  * the composited maps with bf16 storage in the encoder: the site features
    match JAX to bf16 rounding flips (tests/test_torch_encoder.py: 5e-2 of
    their largest magnitude after 14 layers); the maps, on rays made opaque
    by a raised alpha bias, at 2e-2 of each map's scale.
  * the loss and each gradient leaf of a training render on a rays-only
    batch: 1e-4 of the leaf's largest magnitude, floor 1e-9
    (tests/test_torch_train.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models import sparse_conv_net as j_net
from neuralbody_tpu.ops import grid_sample as j_gs
from neuralbody_tpu.ops import ray_ops as j_ray
from neuralbody_tpu.ops import sparse_conv as j_sc
from neuralbody_tpu.renderer import renderer as j_rend
from neuralbody_tpu.train import step as j_step
from neuralbody_tpu.utils import synthetic as j_syn
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import sparse_conv_net as t_net
from neuralbody_tpu_torch.ops import conv_kernel
from neuralbody_tpu_torch.ops import grid_sample as t_gs
from neuralbody_tpu_torch.ops import ray_ops as t_ray
from neuralbody_tpu_torch.ops import sparse_conv as t_sc
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils import synthetic as t_syn
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.transplant import params_from_jax

torch.set_num_threads(1)

VOX = 0.02
NV = 500
N_RAYS = 64
N_SAMPLES = 8
HW = (32, 32)
TOL = dict(atol=1e-5, rtol=1e-5)
MAP_TOL = dict(atol=1e-6, rtol=1e-4)
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-9
MAPS = {"rgb_map", "disp_map", "acc_map", "depth_map"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def weights():
    params, stats = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4,
                              nv=NV)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _raise_alpha(params, by=3.0):
    return dict(params, alpha_fc=dict(
        params["alpha_fc"], b=params["alpha_fc"]["b"] + np.float32(by)))


# -- (a) the scatters and the two samplers ------------------------------------

def _level(rng, lvl_sh=(8, 16, 8), cap=64, n=40, C=8):
    """Unique sites of one level, padded to cap with 2**30 coords and zero
    feature rows."""
    sites = np.unique(np.stack(
        [rng.randint(0, s, n) for s in lvl_sh], axis=1).astype(np.int32),
        axis=0)
    S = len(sites)
    feats = np.zeros((cap, C), np.float32)
    feats[:S] = rng.randn(S, C)
    pad = np.full((cap, 3), 2 ** 30, np.int32)
    pad[:S] = sites
    return feats, pad, lvl_sh, cap


def test_scatter_dense(rng):
    feats, sites, lsh, _ = _level(rng)
    ref = j_sc.scatter_dense(jnp.asarray(feats), jnp.asarray(sites), lsh)
    out = t_sc.scatter_dense(torch.from_numpy(feats),
                             torch.from_numpy(sites), lsh)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # a coord just past the edge is dropped too
    sites[1] = (0, lsh[1], 0)
    ref = j_sc.scatter_dense(jnp.asarray(feats), jnp.asarray(sites), lsh)
    out = t_sc.scatter_dense(torch.from_numpy(feats),
                             torch.from_numpy(sites), lsh)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # and so is a negative one, which JAX would wrap to the far edge (no
    # geometry table holds one)
    sites[0] = (-1, 0, 0)
    neg = t_sc.scatter_dense(torch.from_numpy(feats),
                             torch.from_numpy(sites), lsh)
    assert (neg[-1, 0, 0] == 0).all() and neg.abs().sum() < out.abs().sum()


def test_scatter_dense_gradient_reaches_the_site_rows(rng):
    feats, sites, lsh, _ = _level(rng)
    x = torch.from_numpy(feats).requires_grad_()
    g, = torch.autograd.grad(
        t_sc.scatter_dense(x, torch.from_numpy(sites), lsh).sum(), x)
    inside = (sites < 2 ** 30).all(-1)
    np.testing.assert_array_equal(g.numpy(),
                                  np.repeat(inside[:, None], 8, 1) * 1.0)


def test_scatter_index_volume(rng):
    _, sites, lsh, cap = _level(rng)
    ref = j_sc.scatter_index_volume(jnp.asarray(sites), lsh, cap)
    out = t_sc.scatter_index_volume(torch.from_numpy(sites), lsh, cap)
    assert out.dtype == torch.int32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("far", [False, True])
def test_site_trilinear_sample(rng, far):
    feats, sites, lsh, cap = _level(rng)
    out_sh = tuple(2 * s for s in lsh)
    ivol = np.array(j_sc.scatter_index_volume(jnp.asarray(sites), lsh, cap))
    # continuous full-res coords, out-of-range ones included
    dhw = rng.uniform(-3, 35, (300, 3)).astype(np.float32)
    if far:
        # JAX saturates the int cast and clamps the gather; the port clips
        dhw[:4] = np.array([1e12, -1e12, 3e9, -3e9])[:, None]
        dhw[4] = (-1e-3, 2.0, 2.0)
    ref = j_sc.site_trilinear_sample(
        jnp.asarray(feats), jnp.asarray(ivol), jnp.asarray(dhw), out_sh, cap)
    out = t_sc.site_trilinear_sample(
        torch.from_numpy(feats), torch.from_numpy(ivol),
        torch.from_numpy(dhw), out_sh, cap)
    assert float(np.abs(np.asarray(ref)).max()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_site_trilinear_sample_gradient(rng):
    feats, sites, lsh, cap = _level(rng)
    out_sh = tuple(2 * s for s in lsh)
    ivol = np.array(j_sc.scatter_index_volume(jnp.asarray(sites), lsh, cap))
    dhw = rng.uniform(-1, 17, (200, 3)).astype(np.float32)
    gy = rng.randn(200, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_sc.site_trilinear_sample(
        f, jnp.asarray(ivol), jnp.asarray(dhw), out_sh, cap),
        jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_()
    y = t_sc.site_trilinear_sample(x, torch.from_numpy(ivol),
                                   torch.from_numpy(dhw), out_sh, cap)
    g, = torch.autograd.grad(y, x, torch.from_numpy(gy))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(gy))[0]),
                               **TOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d(rng, padding_mode):
    vol = rng.randn(6, 10, 8, 5).astype(np.float32)
    coords = rng.uniform(-1.4, 1.4, (400, 3)).astype(np.float32)
    coords[:3] = (1e12, -1e12, 0.0)
    coords[3] = (-1.0, 1.0, -1.0)            # exactly on the corners
    ref = j_gs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords),
                              padding_mode)
    out = t_gs.grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(coords),
                              padding_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_grid_sample_3d_is_torch_grid_sample(rng):
    """The semantics the reference took from
    F.grid_sample(padding_mode='zeros', align_corners=True)."""
    vol = rng.randn(6, 10, 8, 5).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    out = t_gs.grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(coords))
    ref = torch.nn.functional.grid_sample(
        torch.from_numpy(vol).permute(3, 0, 1, 2)[None],
        torch.from_numpy(coords)[None, None, None], mode="bilinear",
        padding_mode="zeros", align_corners=True)[0, :, 0, 0].T
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_multiscale_grid_sample(rng):
    vols = [rng.randn(8 // s, 8 // s, 8 // s, c).astype(np.float32)
            for s, c in ((1, 3), (2, 5))]
    coords = rng.uniform(-1.1, 1.1, (100, 3)).astype(np.float32)
    ref = j_gs.multiscale_grid_sample(list(map(jnp.asarray, vols)),
                                      jnp.asarray(coords))
    out = t_gs.multiscale_grid_sample(list(map(torch.from_numpy, vols)),
                                      torch.from_numpy(coords))
    assert tuple(out.shape) == (100, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_site_sample_equals_grid_sample_of_the_dense_volume(rng):
    """The two branches of the port's render read the same numbers."""
    feats, sites, lsh, cap = _level(rng)
    out_sh = tuple(2 * s for s in lsh)
    tf, ts = torch.from_numpy(feats), torch.from_numpy(sites)
    dhw = torch.from_numpy(rng.uniform(-3, 35, (300, 3)).astype(np.float32))
    a = t_sc.site_trilinear_sample(
        tf, t_sc.scatter_index_volume(ts, lsh, cap), dhw, out_sh, cap)
    gc = dhw / torch.tensor(out_sh, dtype=torch.float32) * 2.0 - 1.0
    b = t_gs.grid_sample_3d(t_sc.scatter_dense(tf, ts, lsh), gc[:, [2, 1, 0]])
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# -- (b) depth sampling -------------------------------------------------------

@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals_unperturbed(rng, lindisp):
    near = rng.uniform(0.5, 2.0, (2, 33)).astype(np.float32)
    far = near + rng.uniform(0.5, 3.0, (2, 33)).astype(np.float32)
    ref = j_ray.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16,
                                  lindisp=lindisp)
    for kw in (dict(), dict(perturb=True)):   # perturb needs a generator
        out = t_ray.stratified_z_vals(torch.from_numpy(near),
                                      torch.from_numpy(far), 16,
                                      lindisp=lindisp, **kw)
        assert tuple(out.shape) == (2, 33, 16)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals_perturbed(rng, lindisp):
    near = torch.from_numpy(rng.uniform(0.5, 2.0, (40,)).astype(np.float32))
    far = near + 2.0

    def draw(seed):
        return t_ray.stratified_z_vals(
            near, far, 16, generator=torch.Generator().manual_seed(seed),
            perturb=True, lindisp=lindisp)

    z, base = draw(0), t_ray.stratified_z_vals(near, far, 16, lindisp=lindisp)
    mids = 0.5 * (base[:, 1:] + base[:, :-1])
    lower = torch.cat([base[:, :1], mids], dim=-1)
    upper = torch.cat([mids, base[:, -1:]], dim=-1)
    assert ((z >= lower) & (z <= upper)).all()
    assert (z[:, 1:] >= z[:, :-1]).all()
    assert not torch.equal(z, base)
    assert torch.equal(z, draw(0)) and not torch.equal(z, draw(1))
    # uniform inside the bins: the mean fraction is a half
    frac = ((z - lower) / (upper - lower)).mean().item()
    assert abs(frac - 0.5) < 0.05


def test_sample_along_rays(rng):
    ro = rng.randn(20, 3).astype(np.float32)
    rd = rng.randn(20, 3).astype(np.float32)
    near = rng.uniform(0.5, 2.0, (20,)).astype(np.float32)
    far = near + 1.5
    jp, jz = j_ray.sample_along_rays(*map(jnp.asarray, (ro, rd, near, far)), 8)
    tp, tz = t_ray.sample_along_rays(*map(torch.from_numpy,
                                          (ro, rd, near, far)), 8)
    assert tuple(tp.shape) == (20, 8, 3)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


# -- (c) the encoder's dense and index volumes --------------------------------

def _statics(static, dtype="float32"):
    enc = dict(out_sh=static["out_sh"], site_caps=static["site_caps"],
               compute_dtype=dtype)
    return (j_lx.ModelStatic(encoder=j_net.EncoderStatic(**enc)),
            t_lx.ModelStatic(encoder=t_net.EncoderStatic(**enc)))


@pytest.fixture(scope="module")
def scene2():
    batch, static = j_syn.make_batch(n_rays=N_RAYS, n_verts=NV,
                                     voxel_size=VOX, seed=3, batch_size=2)
    return batch, static


def test_index_volumes_both_routes(scene2):
    """The host-built ivol{l} tables pass through; geoms without them get
    the device scatter, which builds the same volumes."""
    batch, static = scene2
    jm, tm = _statics(static)
    geom = to_device(batch["geom"], "cpu")
    host = t_net.index_volumes(geom, tm.encoder)
    bare = {k: v for k, v in geom.items() if not k.startswith("ivol")}
    dev = t_net.index_volumes(bare, tm.encoder)
    jbare = {k: jnp.asarray(v) for k, v in batch["geom"].items()
             if not k.startswith("ivol")}
    ref = j_net.index_volumes(jbare, jm.encoder)
    assert len(host) == len(dev) == 4
    for lvl, (h, d, r) in enumerate(zip(host, dev, ref), 1):
        assert h is geom[f"ivol{lvl}"]
        assert tuple(d.shape) == (2,) + tm.encoder.level_sh(lvl)
        np.testing.assert_array_equal(d.numpy(), h.numpy())
        np.testing.assert_array_equal(d.numpy(), np.asarray(r))


def test_encode_dense_volumes(weights, scene2):
    """encode_sparse_voxels(densify=True), sparse_conv_net.apply and
    densify against the JAX package's dense volumes."""
    batch, static = scene2
    jm, tm = _statics(static)
    ref, _ = j_lx.encode_sparse_voxels(
        weights[0], jax.tree.map(jnp.asarray, batch["geom"]), jm)
    p, _ = params_from_jax(*weights)
    geom = to_device(batch["geom"], "cpu")
    vols, stats = t_lx.encode_sparse_voxels(p, geom, tm)
    sites, _ = t_lx.encode_sparse_voxels(p, geom, tm, densify=False)
    assert set(stats) == set(p["xyzc_net"])
    for lvl, (v, r, s) in enumerate(zip(vols, ref, sites), 1):
        assert tuple(v.shape) == r.shape == (
            (2,) + tm.encoder.level_sh(lvl) + (s.shape[-1],))
        np.testing.assert_allclose(v.numpy(), np.asarray(r), **TOL)
    again = t_net.densify(sites, geom, tm.encoder)
    assert all(torch.equal(a, b) for a, b in zip(again, vols))


def _frames(batch, b=0):
    frame = {k: batch[k][b] for k in ("R", "Th", "bounds", "latent_index")}
    return jax.tree.map(jnp.asarray, frame), to_device(frame, "cpu")


@pytest.mark.parametrize("site", [True, False])
def test_features_and_raw_match(weights, scene2, rng, site):
    """interpolate_site_features / interpolate_features and
    calculate_density_color against the JAX functions, on points in and
    around the volume."""
    batch, static = scene2
    jm, tm = _statics(static)
    jgeom = jax.tree.map(jnp.asarray, batch["geom"])
    tgeom = to_device(batch["geom"], "cpu")
    p, _ = params_from_jax(*weights)
    jvols, _ = j_lx.encode_sparse_voxels(weights[0], jgeom, jm,
                                         densify=not site)
    tvols, _ = t_lx.encode_sparse_voxels(p, tgeom, tm, densify=not site)
    jframe, tframe = _frames(batch)
    lo, hi = batch["bounds"][0]
    ppts = rng.uniform(lo - 0.1, hi + 0.1, (500, 3)).astype(np.float32)
    wpts = ppts @ batch["R"][0].T + batch["Th"][0]
    vdir = rng.randn(500, 3).astype(np.float32)
    vdir /= np.linalg.norm(vdir, axis=1, keepdims=True)
    jv, tv = [x[0] for x in jvols], [x[0] for x in tvols]
    if site:
        jiv = [v[0] for v in j_net.index_volumes(jgeom, jm.encoder)]
        tiv = [v[0] for v in t_net.index_volumes(tgeom, tm.encoder)]
        jdhw = j_lx.get_dhw_vox(jnp.asarray(ppts), jframe["bounds"],
                                (VOX,) * 3)
        tdhw = t_lx.get_dhw_vox(torch.from_numpy(ppts), tframe["bounds"],
                                (VOX,) * 3)
        jfeat = j_lx.interpolate_site_features(jv, jiv, jdhw, jm)
        tfeat = t_lx.interpolate_site_features(tv, tiv, tdhw, tm)
    else:
        jiv = tiv = None
        jgc = j_lx.get_grid_coords(jnp.asarray(ppts), jframe["bounds"],
                                   (VOX,) * 3, jm.out_sh)
        tgc = t_lx.get_grid_coords(torch.from_numpy(ppts), tframe["bounds"],
                                   (VOX,) * 3, tm.out_sh)
        np.testing.assert_allclose(tgc.numpy(), np.asarray(jgc), **TOL)
        jfeat = j_lx.interpolate_features(jgc, jv)
        tfeat = t_lx.interpolate_features(tgc, tv)
    assert tuple(tfeat.shape) == jfeat.shape == (500, 352)
    assert float(jnp.abs(jfeat).max()) > 0
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), **TOL)
    jraw = j_lx.calculate_density_color(
        weights[0], jnp.asarray(wpts), jnp.asarray(vdir), jv, jframe, jm,
        (VOX,) * 3, index_vols=jiv)
    traw = t_lx.calculate_density_color(
        p, torch.from_numpy(wpts), torch.from_numpy(vdir), tv, tframe, tm,
        (VOX,) * 3, index_vols=tiv)
    np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), **TOL)


# -- (d) the rays-only render -------------------------------------------------

def _scene(batch_size=1, num_views=0, snapshot=False, n_rays=N_RAYS):
    batch, static = j_syn.make_batch(n_rays=n_rays, n_verts=NV,
                                     voxel_size=VOX, seed=3,
                                     batch_size=batch_size)
    if num_views:
        rng = np.random.RandomState(5)
        K = np.array([[20.0, 0, HW[1] / 2], [0, 20.0, HW[0] / 2],
                      [0, 0, 1]], np.float32)
        RT = np.tile(np.eye(4, dtype=np.float32), (num_views, 1, 1))
        RT[:, 2, 3] = 4.0
        batch["Ks"] = np.tile(K, (batch_size, num_views, 1, 1))
        batch["RT"] = np.tile(RT, (batch_size, 1, 1, 1))
        batch["msks"] = (rng.uniform(size=(batch_size, num_views) + HW)
                         > 0.2).astype(np.float32)
        if snapshot:
            batch["K"] = np.tile(K, (batch_size, 1, 1))
            batch["R0_snap"] = np.tile(np.eye(3, dtype=np.float32),
                                       (batch_size, 1, 1))
            batch["Th0_snap"] = np.tile(
                np.array([0.02, 0.0, 0.1], np.float32), (batch_size, 1))
    if batch_size > 1:
        batch["Th"][1] += np.float32(0.01)
        batch["latent_index"][1] = 2
    return batch, static


def _settings(static, dtype="float32", **kw):
    kw = dict(dict(voxel_size=(VOX,) * 3, n_samples=N_SAMPLES,
                   chunk_rays=N_RAYS, img_hw=HW), **kw)
    jm, tm = _statics(static, dtype)
    return (j_rend.RenderSettings(model=jm, **kw),
            t_rend.RenderSettings(model=tm, **kw))


def _compare_maps(ret, ref, tol=MAP_TOL):
    assert set(ret) == set(ref) == MAPS
    for k in ref:
        assert tuple(ret[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(_np(ret[k]), np.asarray(ref[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("chunk", [N_RAYS, N_RAYS // 4])
@pytest.mark.parametrize("num_views", [0, 2])
@pytest.mark.parametrize("site", [True, False])
def test_eval_step_matches_jax(weights, site, num_views, chunk):
    batch, static = _scene(num_views=num_views)
    js, ts = _settings(static, site_interp=site, hull_views=num_views,
                       chunk_rays=chunk)
    ref = j_step.eval_step(weights[0], jax.tree.map(jnp.asarray, batch), js)
    before = conv_kernel.CONV_LAUNCHES
    ret = t_step.eval_step(params_from_jax(*weights)[0], batch, ts,
                           device="cpu")
    assert conv_kernel.CONV_LAUNCHES == before   # the CPU launches nothing
    _compare_maps(ret, ref)


@pytest.mark.parametrize("case", [
    dict(batch_size=2, site_interp=True),
    dict(batch_size=2, site_interp=False, num_views=2),
    dict(num_views=1, snapshot=True, site_interp=True),
    dict(num_views=1, snapshot=True, site_interp=False),
    dict(site_interp=True, white_bkgd=True),
])
def test_eval_step_variants_match_jax(weights, case):
    """Several frames per batch, the monocular (snapshot) hull and a white
    background."""
    case = dict(case)
    scene_kw = {k: case.pop(k) for k in ("batch_size", "num_views",
                                         "snapshot") if k in case}
    batch, static = _scene(**scene_kw)
    if scene_kw.get("snapshot"):
        case.update(hull_views=1, hull_mode="snapshot")
    elif scene_kw.get("num_views"):
        case.update(hull_views=scene_kw["num_views"])
    js, ts = _settings(static, chunk_rays=N_RAYS // 2, **case)
    ref = j_step.eval_step(weights[0], jax.tree.map(jnp.asarray, batch), js)
    ret = t_step.eval_step(params_from_jax(*weights)[0], batch, ts,
                           device="cpu")
    _compare_maps(ret, ref)


@pytest.mark.parametrize("site", [True, False])
def test_eval_step_raised_alpha_bias(weights, site):
    """Both packages' alpha_fc bias raised alike: the rays are no longer
    empty and the composite itself is held to the JAX render."""
    params = _raise_alpha(weights[0])
    batch, static = _scene()
    js, ts = _settings(static, site_interp=site)
    ref = j_step.eval_step(params, jax.tree.map(jnp.asarray, batch), js)
    assert float(np.mean(ref["acc_map"])) > 0.3
    ret = t_step.eval_step(params_from_jax(params, weights[1])[0], batch, ts,
                           device="cpu")
    _compare_maps(ret, ref)


@pytest.mark.parametrize("site", [True, False])
def test_eval_step_bf16_storage(weights, site):
    """compute_dtype bfloat16: bf16 activation storage in the encoder (the
    decode MLP stays f32 off the card in both packages)."""
    params = _raise_alpha(weights[0])
    batch, static = _scene()
    js, ts = _settings(static, "bfloat16", site_interp=site)
    ref = j_step.eval_step(params, jax.tree.map(jnp.asarray, batch), js)
    ret = t_step.eval_step(params_from_jax(params, weights[1])[0], batch, ts,
                           device="cpu")
    for k in ("rgb_map", "acc_map", "depth_map"):
        r = np.asarray(ref[k])
        assert np.abs(_np(ret[k]) - r).max() <= 2e-2 * max(1.0,
                                                           np.abs(r).max()), k


def test_site_and_dense_renders_agree(weights):
    params = params_from_jax(_raise_alpha(weights[0]), weights[1])[0]
    batch, static = _scene(num_views=2)
    _, ts = _settings(static, hull_views=2, chunk_rays=N_RAYS // 2)
    a = t_step.eval_step(params, batch, ts, device="cpu")
    b = t_step.eval_step(params, batch, ts._replace(site_interp=False),
                         device="cpu")
    for k in MAPS:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), err_msg=k,
                                   **MAP_TOL)


def test_site_render_equals_hat_render(weights):
    """The same rays through the plan-free branch and through the host
    planner's hat path (unperturbed depths in both)."""
    params = params_from_jax(_raise_alpha(weights[0]), weights[1])[0]
    kw = dict(n_rays=N_RAYS, n_verts=NV, voxel_size=VOX, seed=3)
    base, static = t_syn.make_batch(**kw)
    hat, hstatic = t_syn.make_batch(hat=True, n_samples=N_SAMPLES,
                                    hat_perturb=False,
                                    hat_static=dict(group_size=32), **kw)
    _, ts = _settings(static)
    a = t_step.eval_step(params, base, ts, device="cpu")
    b = t_step.eval_step(
        params, hat, ts._replace(hat_rows_caps=hstatic["hat"]["rows_caps"]),
        device="cpu")
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_ray_count_must_be_a_multiple_of_the_chunk(weights):
    batch, static = _scene()
    _, ts = _settings(static, chunk_rays=N_RAYS - 16)
    with pytest.raises(ValueError, match="multiple of chunk_rays 48"):
        t_step.eval_step(params_from_jax(*weights)[0], batch, ts,
                         device="cpu")
    # a chunk larger than the batch is the batch
    ret = t_step.eval_step(params_from_jax(*weights)[0], batch,
                           ts._replace(chunk_rays=4 * N_RAYS), device="cpu")
    assert tuple(ret["rgb_map"].shape) == (1, N_RAYS, 3)


@pytest.mark.parametrize("kw", [dict(num_views=3, img_hw=(32, 48)),
                                dict(batch_size=2)])
def test_make_batch_rays_only_equal(kw):
    args = dict(n_rays=N_RAYS, n_verts=NV, voxel_size=VOX, seed=3, **kw)
    jb, js = j_syn.make_batch(**args)
    tb, ts = t_syn.make_batch(**args)
    assert js == ts and "hat_sort" not in tb

    def check(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                check(a[k], b[k])
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    check(jb, tb)


# -- (e) render_density_grid --------------------------------------------------

def test_render_density_grid(weights, scene2, rng):
    batch, static = scene2
    js, ts = _settings(static)
    lo, hi = batch["bounds"][0]
    ppts = rng.uniform(lo - 0.05, hi + 0.05, (2, 256, 3)).astype(np.float32)
    pts = np.einsum("bpi,bji->bpj", ppts, batch["R"]) + batch["Th"]
    b = dict(batch, pts=pts.astype(np.float32))
    ref = j_rend.render_density_grid(
        weights[0], jax.tree.map(jnp.asarray, b), js, pt_chunk=64)
    p, _ = params_from_jax(*weights)
    tb = to_device(b, "cpu")
    with torch.no_grad():
        out = t_rend.render_density_grid(p, tb, ts, pt_chunk=64)
        one = t_rend.render_density_grid(p, tb, ts, pt_chunk=256)
    assert tuple(out.shape) == ref.shape == (2, 256)
    assert float(np.abs(np.asarray(ref)).max()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(one.numpy(), out.numpy(), **TOL)
    with pytest.raises(ValueError, match="multiple of pt_chunk"):
        t_rend.render_density_grid(p, tb, ts, pt_chunk=100)


# -- (f) training through the plan-free branch --------------------------------

_J_VG = jax.jit(jax.value_and_grad(j_step.loss_fn, has_aux=True),
                static_argnames=("settings",))


def _flat(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", x) for i, v in enumerate(tree)
                for p, x in _flat(v)]
    return [("", tree)]


@pytest.mark.parametrize("site", [True, False])
def test_rays_only_loss_and_grads_match_jax(weights, site):
    """loss_fn(train=True) on a rays-only batch, the way the JAX package
    trains with interp_mode="site": autograd of the plain interpolation.
    perturb is off in both (with no key the JAX render perturbs from a
    zero key; its numbers are not the generator's)."""
    params = _raise_alpha(weights[0])
    batch, static = _scene()
    js, ts = _settings(static, site_interp=site, chunk_rays=N_RAYS // 2,
                       perturb=False)
    (jloss, _), jgrads = _J_VG(params, jax.tree.map(jnp.asarray, batch),
                               settings=js, key=None)
    p, _ = params_from_jax(params, weights[1])
    loss, (ret, new_bn, stats), grads = t_step.loss_and_grads(
        p, to_device(batch, "cpu"), ts)
    assert set(ret) == MAPS and set(new_bn) == set(p["xyzc_net"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jl, tl = _flat(jgrads), _flat(grads)
    assert [a for a, _ in jl] == [a for a, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        err = np.abs(_np(t) - _np(j)).max()
        assert err <= GRAD_TOL * np.abs(_np(j)).max() + GRAD_FLOOR, (path, err)


def test_training_render_perturbs_from_the_generator(weights):
    params = params_from_jax(_raise_alpha(weights[0]), weights[1])[0]
    batch, static = _scene()
    _, ts = _settings(static)
    tb = to_device(batch, "cpu")

    def render(train, seed=None, **kw):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return t_rend.render_rays(params, tb, ts._replace(**kw),
                                      train=train, generator=gen)[0]["rgb_map"]

    base = render(False)
    assert torch.equal(render(False, seed=0), base)   # eval never perturbs
    assert torch.equal(render(True), base)            # no generator: none
    assert torch.equal(render(True, seed=0, perturb=False), base)
    a = render(True, seed=0)
    assert not torch.equal(a, base)
    assert torch.equal(a, render(True, seed=0))
    assert not torch.equal(a, render(True, seed=1))
