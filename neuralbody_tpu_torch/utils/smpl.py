"""SMPL body model: shape and pose blend shapes plus LBS skinning
(counterpart of neuralbody_tpu/utils/smpl.py), on torch tensors.

Pure functions over a model dict: `load_model` reads the standard SMPL
pickle (SMPL_NEUTRAL.pkl and its kin) with numpy alone, without chumpy;
`make_synthetic_model` makes a small stand-in of the same structure for
tests and fixtures. The functions take tensors (or numpy arrays, which
they convert) and compute in the dtype and on the device of the pose they
are given. Used by the vertex-extraction and warping tools and by the
T-pose variant's canonical-space machinery.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


class _Stub:
    """What the pickle of an object of an absent module (a chumpy array)
    unpickles to: its state, kept for `_arr`."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    """Reads an SMPL pickle without chumpy: a class of a module that does
    not import becomes _Stub, whose state holds the array."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


def _arr(x):
    """A chumpy array (its state's 'x'), a scipy sparse matrix or an array
    -> a dense float32 numpy array."""
    if isinstance(x, _Stub):
        state = getattr(x, "state", None)
        x = state.get("x") if isinstance(state, dict) else state
    if hasattr(x, "toarray"):
        x = x.toarray()
    return np.array(x, dtype=np.float64).astype(np.float32)


def load_model(path):
    """SMPL pickle -> dict of numpy arrays (v_template, shapedirs, posedirs,
    J_regressor, weights, parents, faces)."""
    with open(path, "rb") as f:
        data = _Unpickler(f, encoding="latin1").load()
    posedirs = _arr(data["posedirs"])                     # [V, 3, 207]
    return {
        "v_template": _arr(data["v_template"]),           # [V, 3]
        "shapedirs": _arr(data["shapedirs"])[..., :10],   # [V, 3, 10]
        "posedirs": posedirs.reshape(-1, posedirs.shape[-1]).T,  # [207, V*3]
        "J_regressor": _arr(data["J_regressor"]),         # [J, V]
        "weights": _arr(data["weights"]),                 # [V, J]
        "parents": np.array(data["kintree_table"][0]).astype(np.int32),
        "faces": np.array(data["f"]).astype(np.int32),
    }


def make_synthetic_model(n_verts=400, n_joints=24, seed=0, faces=False):
    """Small structurally valid SMPL-like model for tests (numpy; the JAX
    package's arrays for the same arguments).

    faces=True triangulates the ellipsoid surface (its convex hull) so the
    closest-face barycentric blend weights (utils/surface.py, used by
    tools/prepare_warping.py) are exercised; the default is the faceless
    point cloud."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n_verts, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v *= np.array([0.3, 0.9, 0.15], np.float32)
    parents = np.zeros(n_joints, np.int32)
    for j in range(1, n_joints):
        parents[j] = rng.randint(0, j)
    J_regressor = rng.rand(n_joints, n_verts).astype(np.float32)
    J_regressor /= J_regressor.sum(1, keepdims=True)
    weights = rng.rand(n_verts, n_joints).astype(np.float32) ** 4
    weights /= weights.sum(1, keepdims=True)
    n_pose_basis = 9 * (n_joints - 1)
    return {
        "v_template": v,
        "shapedirs": 0.01 * rng.randn(n_verts, 3, 10).astype(np.float32),
        "posedirs": 0.01 * rng.randn(
            n_pose_basis, n_verts * 3).astype(np.float32),
        "J_regressor": J_regressor,
        "weights": weights,
        "parents": parents,
        "faces": (_hull_faces(v) if faces else np.zeros((0, 3), np.int32)),
    }


def _hull_faces(v):
    from scipy.spatial import ConvexHull
    return ConvexHull(np.asarray(v, np.float64)).simplices.astype(np.int32)


def _as_tensor(x):
    """A tensor as it is; anything else as an f32 tensor on the CPU (the
    JAX package computes in f32 whatever numpy dtype it is given)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32))


def _t(x, like):
    """x as a tensor of `like`'s dtype and device."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=like.dtype, device=like.device)


def rodrigues(rvecs):
    """Axis-angle [J, 3] -> rotation matrices [J, 3, 3]."""
    rvecs = _as_tensor(rvecs)
    angle = torch.linalg.norm(rvecs + 1e-8, dim=-1, keepdim=True)
    axis = rvecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([
        zeros, -rz, ry,
        rz, zeros, -rx,
        -ry, rx, zeros,
    ], dim=-1).reshape(*rvecs.shape[:-1], 3, 3)
    ident = torch.eye(3, dtype=rvecs.dtype, device=rvecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def rigid_transform(rot_mats, joints, parents):
    """Forward kinematics: the posed joints [J, 3] and the skinning
    matrices A [J, 4, 4] (ref: lbs.py batch_rigid_transform).
    rot_mats [J, 3, 3], joints [J, 3], parents [J] ints (host)."""
    rot_mats = _as_tensor(rot_mats)
    joints = _t(joints, rot_mats)
    parents = [int(p) for p in np.asarray(parents)]
    J = joints.shape[0]
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[parents[1:]]
    tf = torch.zeros((J, 4, 4), dtype=joints.dtype, device=joints.device)
    tf[:, :3, :3] = rot_mats
    tf[:, :3, 3] = rel
    tf[:, 3, 3] = 1.0

    chain = [tf[0]]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ tf[j])
    transforms = torch.stack(chain)

    posed_joints = transforms[:, :3, 3]
    # remove the rest-pose joint location from the translation
    joints_h = torch.cat([joints, joints.new_zeros((J, 1))], dim=1)
    corr = torch.einsum("jab,jb->ja", transforms, joints_h)
    A = transforms.clone()
    A[:, :3, 3] = transforms[:, :3, 3] - corr[:, :3]
    return posed_joints, A


def lbs(model, poses, shapes, new_params=False):
    """SMPL forward: axis-angle poses [J*3], shapes [10] -> vertices [V, 3]
    in the SMPL (canonical root) frame, and the posed joints [J, 3]
    (ref: lbs.py:140-235; new_params turns the pose blend shapes on,
    ref lbs.py:210-213)."""
    poses = _as_tensor(poses)
    shapes = _t(shapes, poses)
    poses = poses.reshape(-1, 3)
    v_shaped = _t(model["v_template"], poses) + torch.einsum(
        "vdk,k->vd", _t(model["shapedirs"], poses), shapes)
    joints = _t(model["J_regressor"], poses) @ v_shaped

    rot_mats = rodrigues(poses)
    if new_params:
        ident = torch.eye(3, dtype=poses.dtype, device=poses.device)
        pose_feature = (rot_mats[1:] - ident).reshape(-1)
        pose_offsets = (pose_feature @ _t(model["posedirs"], poses)
                        ).reshape(-1, 3)
        v_posed = v_shaped + pose_offsets
    else:
        v_posed = v_shaped

    posed_joints, A = rigid_transform(rot_mats, joints, model["parents"])

    T = torch.einsum("vj,jab->vab", _t(model["weights"], poses), A)
    v_h = torch.cat([v_posed, v_posed.new_ones((v_posed.shape[0], 1))],
                    dim=1)
    verts = torch.einsum("vab,vb->va", T, v_h)[:, :3]
    return verts, posed_joints


def smpl_forward(model, poses, shapes, Rh=None, Th=None, new_params=False):
    """World-space vertices: the global rotation Rh (axis-angle) and the
    translation Th applied after LBS (ref: body_model.py forward)."""
    poses = _as_tensor(poses)
    verts, joints = lbs(model, poses, shapes, new_params=new_params)
    if Rh is not None:
        R = rodrigues(_t(Rh, poses).reshape(1, 3))[0]
        verts = verts @ R.T
        joints = joints @ R.T
    if Th is not None:
        Th = _t(Th, poses).reshape(1, 3)
        verts = verts + Th
        joints = joints + Th
    return verts, joints

