"""Per-frame posed SMPL vertices from params files (the port's
counterpart of the repository's tools/extract_vertices.py; ref
zju_smpl/extract_vertices.py:1-41): for each params/{i}.npy (poses,
shapes, Rh, Th), run the SMPL layer (utils/smpl.py) and write
vertices/{i}.npy in the world frame. The ZJU convention applies Rh and Th
outside the model.

    python -m neuralbody_tpu_torch.tools.extract_vertices \
        --data_root data/zju_mocap/CoreView_313 \
        --model_path data/smplx/smpl/SMPL_NEUTRAL.pkl [--new_params] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils import smpl
from ..utils.platform import resolve_device


def frame_vertices(model, params, new_params=False, device="cpu"):
    """World-space vertices [V, 3] (numpy f32) of one params dict."""
    device = resolve_device(device)

    def t(x, n=None):
        x = np.asarray(x, np.float32).reshape(-1)
        return torch.as_tensor(x[:n] if n else x, device=device)
    verts, _ = smpl.smpl_forward(
        model, t(params["poses"]), t(params["shapes"], 10),
        Rh=t(params["Rh"]), Th=t(params["Th"]), new_params=new_params)
    return verts.cpu().numpy().astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--params_dir", default="params")
    ap.add_argument("--out_dir", default="vertices")
    ap.add_argument("--new_params", action="store_true",
                    help="apply the pose blend shapes (ref lbs.py:210-213)")
    ap.add_argument("--device", default=None,
                    help="the SMPL layer's device (default: the card)")
    args = ap.parse_args(argv)

    model = smpl.load_model(args.model_path)
    params_dir = os.path.join(args.data_root, args.params_dir)
    out_dir = os.path.join(args.data_root, args.out_dir)
    os.makedirs(out_dir, exist_ok=True)

    for fn in sorted(os.listdir(params_dir),
                     key=lambda s: int(s.split(".")[0])):
        i = fn.split(".")[0]
        params = np.load(os.path.join(params_dir, fn),
                         allow_pickle=True).item()
        np.save(os.path.join(out_dir, f"{i}.npy"), frame_vertices(
            model, params, args.new_params, args.device))
        print(f"frame {i}: vertices saved")


if __name__ == "__main__":
    main()
