"""The port's SMPL layer (neuralbody_tpu_torch/utils/smpl.py) and its copy
of the closest-surface search (utils/surface.py) against the JAX package's
on the same inputs, on the CPU.

Tolerances: the SMPL functions at 1e-5 (f32, the same operations in
another library: rounding of the einsums and matrix chains); the
synthetic model's arrays, load_model's and the surface search's results
exactly (the same numpy code).
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.utils import smpl as j_smpl
from neuralbody_tpu.utils import surface as j_surface
from neuralbody_tpu_torch.utils import smpl as t_smpl
from neuralbody_tpu_torch.utils import surface as t_surface

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NJ = 8
MODEL = t_smpl.make_synthetic_model(n_verts=200, n_joints=NJ, seed=1)


@pytest.mark.parametrize("kw", [dict(n_verts=200, n_joints=8, seed=1),
                                dict(n_verts=120, seed=3, faces=True)])
def test_synthetic_model_is_the_jax_packages(kw):
    ours, theirs = t_smpl.make_synthetic_model(**kw), \
        j_smpl.make_synthetic_model(**kw)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype, k


def test_rodrigues(rng):
    rvecs = (rng.randn(6, 3) * 0.7).astype(np.float32)
    rvecs[0] = 0.0
    np.testing.assert_allclose(
        t_smpl.rodrigues(torch.from_numpy(rvecs)).numpy(),
        np.asarray(j_smpl.rodrigues(jnp.asarray(rvecs))), **TOL)


def test_rigid_transform(rng):
    poses = (rng.randn(NJ, 3) * 0.4).astype(np.float32)
    joints = MODEL["J_regressor"] @ MODEL["v_template"]
    pj, A = t_smpl.rigid_transform(t_smpl.rodrigues(torch.from_numpy(poses)),
                                   joints, MODEL["parents"])
    jpj, jA = j_smpl.rigid_transform(j_smpl.rodrigues(jnp.asarray(poses)),
                                     jnp.asarray(joints), MODEL["parents"])
    np.testing.assert_allclose(pj.numpy(), np.asarray(jpj), **TOL)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), **TOL)


@pytest.mark.parametrize("new_params", [False, True])
def test_lbs(rng, new_params):
    poses = (rng.randn(NJ * 3) * 0.4).astype(np.float32)
    shapes = rng.randn(10).astype(np.float32)
    v, j = t_smpl.lbs(MODEL, torch.from_numpy(poses),
                      torch.from_numpy(shapes), new_params=new_params)
    jv, jj = j_smpl.lbs(MODEL, jnp.asarray(poses), jnp.asarray(shapes),
                        new_params=new_params)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), **TOL)


def test_smpl_forward_in_world(rng):
    poses = (rng.randn(NJ * 3) * 0.3).astype(np.float32)
    shapes = rng.randn(10).astype(np.float32)
    Rh = np.array([0.1, -0.4, 0.3], np.float32)
    Th = np.array([0.5, 1.0, 3.0], np.float32)
    v, j = t_smpl.smpl_forward(MODEL, poses, shapes, Rh=Rh, Th=Th)
    jv, jj = j_smpl.smpl_forward(MODEL, jnp.asarray(poses),
                                 jnp.asarray(shapes), Rh=jnp.asarray(Rh),
                                 Th=jnp.asarray(Th))
    assert v.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), **TOL)


def test_rest_pose_is_the_template():
    v, _ = t_smpl.lbs(MODEL, torch.zeros(NJ * 3), torch.zeros(10))
    np.testing.assert_allclose(v.numpy(), MODEL["v_template"], atol=1e-5)


def test_load_model_reads_a_pickle_as_the_jax_package_does(tmp_path, rng):
    """A pickle in the SMPL layout (numpy arrays, posedirs [V, 3, P],
    shapedirs with more than 10 components, a scipy sparse J_regressor,
    the kintree table), written by the test."""
    from scipy import sparse
    V, J, P = 30, 5, 36
    data = {
        "v_template": rng.randn(V, 3),
        "shapedirs": rng.randn(V, 3, 12),
        "posedirs": rng.randn(V, 3, P),
        "J_regressor": sparse.csc_matrix(rng.rand(J, V)),
        "weights": rng.rand(V, J),
        "kintree_table": np.stack([np.array([-1, 0, 0, 1, 2]),
                                   np.arange(J)]),
        "f": rng.randint(0, V, (20, 3)).astype(np.uint32),
    }
    path = tmp_path / "model.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    ours, theirs = t_smpl.load_model(str(path)), j_smpl.load_model(str(path))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype, k
    assert ours["posedirs"].shape == (P, V * 3)
    assert ours["shapedirs"].shape == (V, 3, 10)


def test_surface_is_the_jax_packages(rng):
    model = t_smpl.make_synthetic_model(n_verts=300, faces=True, seed=2)
    query = rng.uniform(-1.0, 1.0, (500, 3)).astype(np.float32)
    ours = t_surface.closest_point_on_mesh(model["v_template"],
                                           model["faces"], query)
    theirs = j_surface.closest_point_on_mesh(model["v_template"],
                                             model["faces"], query)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_surface.barycentric_blend_weights(
            model["v_template"], model["faces"], model["weights"], query),
        j_surface.barycentric_blend_weights(
            model["v_template"], model["faces"], model["weights"], query))


def test_load_model_reads_arrays_of_a_module_it_lacks(tmp_path, rng):
    """The SMPL pickles hold chumpy arrays; load_model reads them without
    chumpy: a class whose module does not import unpickles to a stand-in
    whose state's 'x' is the array (a chumpy Ch pickles its value so)."""
    import sys
    import types
    mod = types.ModuleType("absent_array_lib")

    class Ch:
        def __init__(self, x):
            self.x = x

        def __getstate__(self):
            return {"x": self.x, "dterms": {}}
    Ch.__module__, Ch.__qualname__ = mod.__name__, "Ch"
    mod.Ch = Ch
    sys.modules[mod.__name__] = mod
    V, J = 20, 4
    arrays = {"v_template": rng.randn(V, 3), "shapedirs": rng.randn(V, 3, 10),
              "posedirs": rng.randn(V, 3, 27), "weights": rng.rand(V, J)}
    data = {k: Ch(v) for k, v in arrays.items()}
    data.update(J_regressor=rng.rand(J, V),
                kintree_table=np.stack([np.array([-1, 0, 1, 1]),
                                        np.arange(J)]),
                f=rng.randint(0, V, (10, 3)))
    path = tmp_path / "model.pkl"
    try:
        with open(path, "wb") as f:
            pickle.dump(data, f)
    finally:
        del sys.modules[mod.__name__]
    model = t_smpl.load_model(str(path))
    for k, v in arrays.items():
        want = v.astype(np.float32)
        if k == "posedirs":
            want = want.reshape(-1, want.shape[-1]).T
        np.testing.assert_array_equal(model[k], want, err_msg=k)
