"""Datasets (ZJU-MoCap multi-view, People-Snapshot monocular) and the
batch loader with its spawned workers (counterpart of
neuralbody_tpu/datasets/; numpy, host only)."""
from . import zju_mocap, snapshot  # noqa: F401  (registers plugins)
from .loader import make_data_loader, make_dataset, collate

__all__ = ["make_data_loader", "make_dataset", "collate"]
