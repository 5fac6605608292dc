"""Datasets (ZJU-MoCap multi-view, People-Snapshot monocular, the T-pose
variant's) and the batch loader with its spawned workers, the demo
datasets (orbit, novel pose, rotated SMPL, monocular) and the mesh
datasets (counterpart of neuralbody_tpu/datasets/; numpy, host only)."""
from . import (zju_mocap, snapshot, demo_datasets,  # noqa: F401
               mesh_dataset, tpose_dataset)  # (registers plugins)
from .loader import make_data_loader, make_dataset, collate

__all__ = ["make_data_loader", "make_dataset", "collate"]
