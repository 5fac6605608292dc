"""Attribute-style nested configuration node.

A clean-room, minimal replacement for the vendored yacs CfgNode the reference
uses (ref: lib/config/yacs.py). Only the features the framework needs:
nested dict with attribute access, recursive merge, dotted-path override
lists, YAML (de)serialization, and deep copies.
"""
from __future__ import annotations

import copy
from typing import Any, Iterable

import yaml


class CfgNode(dict):
    """A dict subclass whose items are also readable/writable as attributes."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = self._convert(v)

    @staticmethod
    def _convert(v: Any) -> Any:
        if isinstance(v, dict) and not isinstance(v, CfgNode):
            return CfgNode(v)
        return v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._convert(value)

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._convert(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- merging ----------------------------------------------------------
    def merge_from_other(self, other: dict) -> None:
        """Recursively merge ``other`` into self (other wins)."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], CfgNode)
                and isinstance(v, dict)
            ):
                self[k].merge_from_other(v)
            else:
                self[k] = self._convert(copy.deepcopy(v))

    def merge_from_list(self, opts: Iterable[Any]) -> None:
        """Merge from a flat [key1, val1, key2, val2, ...] list.

        Keys are dotted paths ('train.lr'); string values are parsed as YAML
        literals so '5e-4' -> float, '[0,6]' -> list, 'true' -> bool.
        Mirrors the reference CLI override semantics (lib/config/config.py:155).
        """
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must have even length: {opts}")
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    node[p] = CfgNode()
                node = node[p]
            if isinstance(val, str):
                try:
                    val = yaml.safe_load(val)
                except yaml.YAMLError:
                    pass
            if isinstance(val, str):
                # YAML 1.1 misses floats like '5e-4' (no dot before exponent)
                try:
                    val = float(val)
                except ValueError:
                    pass
            node[parts[-1]] = val

    # -- IO ---------------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    @classmethod
    def load_yaml(cls, path: str) -> "CfgNode":
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        return cls(data)

    def clone(self) -> "CfgNode":
        return CfgNode(copy.deepcopy(self.to_dict()))

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node
