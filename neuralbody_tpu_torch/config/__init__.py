"""Configuration: CfgNode, the default tree, make_cfg and the plugin
registry (counterpart of neuralbody_tpu/config/; the YAMLs under configs/
load unchanged, cfg.tpu.* included)."""
from .node import CfgNode
from .defaults import default_cfg
from .config import make_cfg, make_cfg_from_args, parse_args
from .registry import register, resolve, build, registered

__all__ = [
    "CfgNode", "default_cfg", "make_cfg", "make_cfg_from_args", "parse_args",
    "register", "resolve", "build", "registered",
]
