"""Dataset tools of the port (counterpart of the repository's
tools/dataset_tools.py): camera annotation, EasyMocap conversion,
occupancy voxelization (run.py's light_stage runner uses it) and
People-Snapshot processing, the SMPL layer being utils/smpl.py:

    python -m neuralbody_tpu_torch.tools.dataset_tools annots \
        --input_dir my_capture
    python -m neuralbody_tpu_torch.tools.dataset_tools easymocap \
        --input_dir my_313 --model_path SMPL_NEUTRAL.pkl [--device cpu]
    python -m neuralbody_tpu_torch.tools.dataset_tools occupancy \
        --ply points.ply --out occ.npz [--res 256]
    python -m neuralbody_tpu_torch.tools.dataset_tools snapshot \
        --input_dir female-3-casual --model_path SMPL_FEMALE.pkl

The SMPL commands run the layer on the card unless --device says
otherwise. snapshot reads its HDF5 files with h5py, imported when the
command runs; without it the command raises.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np


def read_cams_yml(cam_names, intri="intri.yml", extri="extri.yml"):
    """intri/extri.yml -> the cams dict of annots.npy (T in mm)."""
    import cv2
    fi = cv2.FileStorage(intri, cv2.FILE_STORAGE_READ)
    fe = cv2.FileStorage(extri, cv2.FILE_STORAGE_READ)
    cams = {"K": [], "D": [], "R": [], "T": []}
    for name in cam_names:
        cams["K"].append(fi.getNode(f"K_{name}").mat())
        cams["D"].append(fi.getNode(f"dist_{name}").mat().T)
        cams["R"].append(fe.getNode(f"Rot_{name}").mat())
        cams["T"].append(fe.getNode(f"T_{name}").mat() * 1000)
    return cams


def cmd_annots(args):
    """images/<cam>/*.jpg + intri/extri.yml under input_dir -> annots.npy
    (ref tools/custom/get_annots.py). Paths are relative to input_dir."""
    root = args.input_dir
    cam_dirs = sorted(os.listdir(osp.join(root, "images")))
    cams = read_cams_yml(cam_dirs, osp.join(root, "intri.yml"),
                         osp.join(root, "extri.yml"))
    all_ims = []
    for d in cam_dirs:
        ims = sorted(osp.relpath(p, root) for p in glob.glob(
            osp.join(root, "images", d, "*.jpg")))
        all_ims.append(np.array(ims))
    n = min(len(i) for i in all_ims)
    ims = np.stack([i[:n] for i in all_ims], axis=1)
    annot = {"cams": cams,
             "ims": [{"ims": row.tolist()} for row in ims]}
    np.save(osp.join(root, "annots.npy"), annot)
    print(f"annots.npy: {len(cam_dirs)} cams, {n} frames")


def _posed_vertices(model, poses, shapes, Rh, Th, device):
    """smpl_forward on `device` -> world-space vertices, numpy f32."""
    import torch

    from ..utils import smpl
    from ..utils.platform import resolve_device
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    verts, _ = smpl.smpl_forward(model, t(poses), t(shapes), Rh=t(Rh),
                                 Th=t(Th))
    return verts.cpu().numpy().astype(np.float32)


def cmd_easymocap(args):
    """EasyMocap's output-smpl-3d json -> params/ and vertices/ (ref
    zju_smpl/easymocap_to_neuralbody.py)."""
    from ..utils import smpl

    model = smpl.load_model(args.model_path)
    param_in = osp.join(args.input_dir, "output-smpl-3d", "smpl")
    param_out = osp.join(args.input_dir, "params")
    vert_out = osp.join(args.input_dir, "vertices")
    os.makedirs(param_out, exist_ok=True)
    os.makedirs(vert_out, exist_ok=True)

    for fn in sorted(os.listdir(param_in)):
        idx = int(osp.splitext(fn)[0])
        with open(osp.join(param_in, fn)) as f:
            ann = json.load(f)["annots"][0]
        poses = np.array(ann["poses"]).reshape(-1)
        Rh = np.array(ann["Rh"]).reshape(3)
        Th = np.array(ann["Th"]).reshape(3)
        shapes = np.array(ann["shapes"]).reshape(-1)[:10]
        np.save(osp.join(param_out, f"{idx}.npy"),
                {"poses": poses[None], "Rh": Rh[None], "Th": Th[None],
                 "shapes": shapes[None]})
        # EasyMocap's poses leave out the global rotation (that is Rh)
        full = np.zeros(model["parents"].shape[0] * 3)
        full[3:3 + len(poses)] = poses[:len(full) - 3]
        np.save(osp.join(vert_out, f"{idx}.npy"), _posed_vertices(
            model, full, shapes, Rh, Th, args.device))
        print(f"frame {idx}")


def cmd_occupancy(args):
    """Point cloud -> packed res^3 occupancy npz (ref: ply_to_occupancy.py)."""
    from scipy.spatial import cKDTree

    from ..utils.mesh_io import load_ply

    pts, _ = load_ply(args.ply)
    res = args.res
    mn, mx = pts.min(0), pts.max(0)
    center = (mn + mx) / 2
    scale = (mx - mn).max() * 1.05
    grid_lin = (np.arange(res) + 0.5) / res - 0.5
    gx, gy, gz = np.meshgrid(grid_lin, grid_lin, grid_lin, indexing="ij")
    q = np.stack([gx, gy, gz], -1).reshape(-1, 3) * scale + center
    tree = cKDTree(pts)
    # only the distances under the threshold decide a voxel: the bound
    # prunes the search (the JAX tool's unbounded query gives the same
    # occupancy, about ten times slower)
    d, _ = tree.query(q, k=1, distance_upper_bound=scale / res)
    occ = (d < scale / res).reshape(res, res, res).astype(np.uint8)
    np.savez_compressed(
        args.out,
        compressed_occupancies=np.packbits(occ.reshape(-1)),
        bounds=np.stack([mn, mx]).astype(np.float32))
    print(f"occupancy: {occ.sum()} voxels occupied -> {args.out}")


def cmd_snapshot(args):
    """People-Snapshot: video + masks hdf5 + consensus poses -> the
    framework's layout (ref: tools/process_snapshot.py:58-147, chumpy's
    SMPL replaced by utils/smpl.py)."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError(
            "dataset_tools snapshot reads People-Snapshot's HDF5 files and "
            "needs the h5py package, which is not installed") from None
    import cv2

    root = args.input_dir
    for d in ("image", "mask", "vertices"):
        os.makedirs(osp.join(root, d), exist_ok=True)

    # frames from the video
    videos = glob.glob(osp.join(root, "*.mp4"))
    if videos:
        cap = cv2.VideoCapture(videos[0])
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.imwrite(osp.join(root, "image", f"{i}.jpg"), frame)
            i += 1
        cap.release()

    # masks from the hdf5 (eroded by 4, ref process_snapshot.py)
    mask_files = glob.glob(osp.join(root, "masks*.hdf5"))
    if mask_files:
        with h5py.File(mask_files[0], "r") as f:
            masks = f["masks"][:]
        kernel = np.ones((4, 4), np.uint8)
        for i, m in enumerate(masks):
            m = cv2.erode(m.astype(np.uint8), kernel)
            cv2.imwrite(osp.join(root, "mask", f"{i}.png"), m)

    # pose, translation and vertices from reconstructed_poses.hdf5
    pose_files = glob.glob(osp.join(root, "reconstructed_poses.hdf5"))
    if pose_files and args.model_path:
        from ..utils import smpl
        model = smpl.load_model(args.model_path)
        with h5py.File(pose_files[0], "r") as f:
            poses = f["pose"][:]
            trans = f["trans"][:]
            betas = f["betas"][:]
        np.save(osp.join(root, "params.npy"),
                {"pose": poses, "trans": trans, "shapes": betas})
        for i in range(len(poses)):
            full = poses[i].copy()
            Rh = full[:3].copy()
            full[:3] = 0
            np.save(osp.join(root, "vertices", f"{i}.npy"), _posed_vertices(
                model, full, betas[:10], Rh, trans[i], args.device))
    print("snapshot processing done")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("annots")
    a.add_argument("--input_dir", required=True)
    a.set_defaults(fn=cmd_annots)
    e = sub.add_parser("easymocap")
    e.add_argument("--input_dir", required=True)
    e.add_argument("--model_path", required=True)
    e.add_argument("--device", default=None,
                   help="the SMPL layer's device (default: the card)")
    e.set_defaults(fn=cmd_easymocap)
    occ = sub.add_parser("occupancy")
    occ.add_argument("--ply", required=True)
    occ.add_argument("--res", type=int, default=256)
    occ.add_argument("--out", required=True)
    occ.set_defaults(fn=cmd_occupancy)
    s = sub.add_parser("snapshot")
    s.add_argument("--input_dir", required=True)
    s.add_argument("--model_path", default=None)
    s.add_argument("--device", default=None,
                   help="the SMPL layer's device (default: the card)")
    s.set_defaults(fn=cmd_snapshot)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
