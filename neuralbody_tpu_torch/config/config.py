"""Configuration assembly.

Implements the reference's four-layer merge with mode overlays
(ref: lib/config/config.py:145-173):

    defaults -> parent_cfg -> experiment yaml -> CLI opts
    -> [vis_* mode overlay re-merge] -> CLI opts again

but with registry-name plugin resolution instead of file-path imp.load_source.
"""
from __future__ import annotations

import argparse
import os

from .defaults import default_cfg
from .node import CfgNode

_MODE_OVERLAYS = [
    ("vis_novel_pose", "novel_pose_cfg"),
    ("vis_novel_view", "novel_view_cfg"),
    ("vis_rotate_smpl", "rotate_smpl_cfg"),
    ("vis_mesh", "mesh_cfg"),
]


def make_cfg(cfg_file: str | None = None, opts=(), base: CfgNode | None = None) -> CfgNode:
    cfg = base.clone() if base is not None else default_cfg()

    if cfg_file:
        current = CfgNode.load_yaml(cfg_file)
        if "parent_cfg" in current:
            parent_path = current["parent_cfg"]
            if not os.path.isabs(parent_path):
                # resolve relative to repo root first, then to the yaml's dir
                cand = os.path.join(os.path.dirname(cfg_file), parent_path)
                if not os.path.exists(parent_path) and os.path.exists(cand):
                    parent_path = cand
            cfg.merge_from_other(CfgNode.load_yaml(parent_path))
        cfg.merge_from_other(current)

    cfg.merge_from_list(opts)

    # mode overlays: a vis_* flag swaps dataset/renderer/visualizer modules
    for flag, overlay in _MODE_OVERLAYS:
        if cfg.get(flag, False) and overlay in cfg:
            cfg.merge_from_other(cfg[overlay])

    # CLI opts win over overlays (ref: config.py:169)
    cfg.merge_from_list(opts)

    _derive(cfg)
    return cfg


def _derive(cfg: CfgNode) -> None:
    cfg.trained_model_dir = os.path.join("data/trained_model", cfg.task, cfg.exp_name)
    cfg.record_dir = os.path.join("data/record", cfg.task, cfg.exp_name)
    cfg.result_dir = os.path.join("data/result", cfg.task, cfg.exp_name)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="neuralbody_tpu")
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--type", type=str, default="")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def make_cfg_from_args(argv=None) -> tuple[CfgNode, argparse.Namespace]:
    args = parse_args(argv)
    base = None
    if args.type:
        # ref quirk (config.py:186-187): --type sets task='run' BEFORE the
        # yaml merge, so any yaml-specified task overrides it — run.py must
        # read checkpoints from the experiment's own task directory
        base = default_cfg()
        base.task = "run"
    cfg = make_cfg(args.cfg_file, args.opts or [], base=base)
    return cfg, args
