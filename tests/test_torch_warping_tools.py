"""The port's SMPL tools (neuralbody_tpu_torch/tools/{prepare_warping,
extract_vertices,dataset_tools}.py) against the repository's root tools
(which run the JAX package's SMPL layer) on the same inputs, on the CPU.

Tolerances: files of host data (params, annots) equal; vertices and warped
grids at 1e-5 (f32 SMPL in another library, test_torch_smpl.py).
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralbody_tpu.utils import smpl as j_smpl
from neuralbody_tpu_torch.tools import dataset_tools, extract_vertices
from neuralbody_tpu_torch.tools import prepare_warping

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}
TOL = dict(rtol=1e-5, atol=1e-5)


def root_tool(name, *args):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", name),
                        *args], capture_output=True, text=True, cwd=REPO,
                       env=ENV, timeout=300)
    assert r.returncode == 0, r.stderr


def write_model(path, n_verts=100, n_joints=24, seed=2):
    """make_synthetic_model written as an SMPL pickle; returns the model."""
    model = j_smpl.make_synthetic_model(n_verts=n_verts, n_joints=n_joints,
                                        seed=seed)
    pkl = {
        "v_template": model["v_template"],
        "shapedirs": model["shapedirs"],
        "posedirs": model["posedirs"].T.reshape(n_verts, 3, -1),
        "J_regressor": model["J_regressor"],
        "weights": model["weights"],
        "kintree_table": np.stack(
            [model["parents"], np.arange(n_joints)]).astype(np.int64),
        "f": model["faces"],
    }
    with open(path, "wb") as f:
        pickle.dump(pkl, f)
    return model


def root_warping():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import prepare_warping as root
    finally:
        sys.path.pop(0)
    return root


@pytest.mark.parametrize("faces", [False, True])
def test_warp_grid_for_frame(faces):
    model = j_smpl.make_synthetic_model(n_verts=200, n_joints=8, seed=1,
                                        faces=faces)
    w = model["weights"] ** 8
    model["weights"] = (w / w.sum(1, keepdims=True)).astype(np.float32)
    poses = (np.random.RandomState(3).randn(8 * 3) * 0.2).astype(np.float32)
    ours = prepare_warping.warp_grid_for_frame(model, poses, (0.06,) * 3)
    theirs = root_warping().warp_grid_for_frame(model, poses, (0.06,) * 3)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **TOL)
    # a posed body: the warp is not the identity
    assert np.abs(ours[0].reshape(-1, 3)[0] - ours[1][0]).max() > 1e-3


def test_prepare_warping_main(tmp_path):
    write_model(str(tmp_path / "m.pkl"), n_joints=6)
    rng = np.random.RandomState(5)
    for d in ("jax", "torch"):
        os.makedirs(tmp_path / d / "params")
    for i in range(2):
        p = {"poses": rng.randn(1, 18) * 0.2, "shapes": np.zeros((1, 10)),
             "Rh": np.zeros((1, 3)), "Th": np.zeros((1, 3))}
        for d in ("jax", "torch"):
            np.save(str(tmp_path / d / "params" / f"{i}.npy"), p)
    root_tool("prepare_warping.py", "--data_root", str(tmp_path / "jax"),
              "--model_path", str(tmp_path / "m.pkl"), "--ptot_vsize", "0.1")
    prepare_warping.main(["--data_root", str(tmp_path / "torch"),
                          "--model_path", str(tmp_path / "m.pkl"),
                          "--ptot_vsize", "0.1", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "jax/tvertices.npy"),
                                  np.load(tmp_path / "torch/tvertices.npy"))
    for i in range(2):
        a, b = (np.load(tmp_path / d / f"warping/{i}.npz")
                for d in ("jax", "torch"))
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)


def test_extract_vertices(tmp_path):
    write_model(str(tmp_path / "m.pkl"), n_joints=6)
    rng = np.random.RandomState(0)
    for d in ("jax", "torch"):
        os.makedirs(tmp_path / d / "params")
    for i in range(2):
        p = {"poses": rng.randn(1, 18) * 0.2, "shapes": rng.randn(1, 10) * 0.3,
             "Rh": rng.randn(1, 3) * 0.2, "Th": rng.randn(1, 3)}
        for d in ("jax", "torch"):
            np.save(str(tmp_path / d / "params" / f"{i}.npy"), p)
    for new_params in ([], ["--new_params"]):
        root_tool("extract_vertices.py", "--data_root", str(tmp_path / "jax"),
                  "--model_path", str(tmp_path / "m.pkl"), *new_params)
        extract_vertices.main(["--data_root", str(tmp_path / "torch"),
                               "--model_path", str(tmp_path / "m.pkl"),
                               "--device", "cpu", *new_params])
        for i in range(2):
            a, b = (np.load(tmp_path / d / f"vertices/{i}.npy")
                    for d in ("jax", "torch"))
            assert b.dtype == a.dtype == np.float32
            np.testing.assert_allclose(b, a, **TOL)


def test_easymocap(tmp_path):
    write_model(str(tmp_path / "m.pkl"))
    rng = np.random.RandomState(1)
    for d in ("jax", "torch"):
        os.makedirs(tmp_path / d / "output-smpl-3d" / "smpl")
    for i in range(2):
        ann = {"annots": [{"poses": (rng.randn(1, 69) * 0.2).tolist(),
                           "Rh": rng.randn(1, 3).tolist(),
                           "Th": rng.randn(1, 3).tolist(),
                           "shapes": (rng.randn(1, 10) * 0.3).tolist()}]}
        for d in ("jax", "torch"):
            with open(tmp_path / d / "output-smpl-3d" / "smpl"
                      / f"{i:06d}.json", "w") as f:
                json.dump(ann, f)
    root_tool("dataset_tools.py", "easymocap", "--input_dir",
              str(tmp_path / "jax"), "--model_path", str(tmp_path / "m.pkl"))
    dataset_tools.main(["easymocap", "--input_dir", str(tmp_path / "torch"),
                        "--model_path", str(tmp_path / "m.pkl"),
                        "--device", "cpu"])
    for i in range(2):
        a, b = (np.load(tmp_path / d / f"params/{i}.npy",
                        allow_pickle=True).item() for d in ("jax", "torch"))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
        a, b = (np.load(tmp_path / d / f"vertices/{i}.npy")
                for d in ("jax", "torch"))
        np.testing.assert_allclose(b, a, **TOL)


def test_annots(tmp_path):
    import cv2
    for d in ("jax", "torch"):
        root = tmp_path / d
        root.mkdir()
        names = ["01", "02"]
        fi = cv2.FileStorage(str(root / "intri.yml"), cv2.FILE_STORAGE_WRITE)
        fe = cv2.FileStorage(str(root / "extri.yml"), cv2.FILE_STORAGE_WRITE)
        for c, name in enumerate(names):
            fi.write(f"K_{name}", np.eye(3) * (c + 1))
            fi.write(f"dist_{name}", np.full((1, 5), 0.01 * c))
            fe.write(f"Rot_{name}", np.eye(3))
            fe.write(f"T_{name}", np.array([[0.1 * c], [0.0], [2.0]]))
            os.makedirs(root / "images" / name)
            for f in range(3 - c):
                (root / "images" / name / f"{f:06d}.jpg").write_bytes(b"")
        fi.release()
        fe.release()
    root_tool("dataset_tools.py", "annots", "--input_dir",
              str(tmp_path / "jax"))
    dataset_tools.main(["annots", "--input_dir", str(tmp_path / "torch")])
    a, b = (np.load(tmp_path / d / "annots.npy", allow_pickle=True).item()
            for d in ("jax", "torch"))
    assert a["ims"] == b["ims"] and len(b["ims"]) == 2
    for k in a["cams"]:
        for x, y in zip(a["cams"][k], b["cams"][k]):
            np.testing.assert_array_equal(y, x)


def test_snapshot_without_h5py_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        dataset_tools.main(["snapshot", "--input_dir", str(tmp_path)])


def test_synthetic_warping_is_posed(tmp_path):
    """write_synthetic_warping's frames: a warp that is not the identity,
    bounds around the posed body, the template as tvertices."""
    model = prepare_warping.write_synthetic_warping(
        str(tmp_path), 2, n_verts=300, ptot_vsize=0.08, device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "tvertices.npy"),
                                  model["v_template"])
    for i in range(2):
        z = np.load(tmp_path / f"warping/{i}.npz")
        ptot, pb = z["ptot_pts"], z["pbounds"]
        axes = [np.arange(pb[0, a], pb[1, a] + 0.08, 0.08) for a in range(3)]
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
        assert ptot.shape == grid.shape and np.isfinite(ptot).all()
        assert np.abs(ptot - grid).max() > 0.01
