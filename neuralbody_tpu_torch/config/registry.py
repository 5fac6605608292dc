"""Registry-based plugin resolution.

Replaces the reference's stringly file-path + imp.load_source plugin scheme
(ref: lib/networks/make_network.py:5-9 and the other make_* factories) with
decorated registries keyed by short names.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable

_REGISTRIES: dict[str, dict[str, Callable]] = defaultdict(dict)


def register(kind: str, name: str):
    def deco(obj):
        _REGISTRIES[kind][name] = obj
        return obj
    return deco


def resolve(kind: str, name: str):
    # accept both registry short names and reference-style dotted module paths
    # ('lib.networks.latent_xyzc' -> 'latent_xyzc')
    reg = _REGISTRIES[kind]
    if name in reg:
        return reg[name]
    # one reference config writes the module with a file suffix
    # ('lib.train.trainers.nerf.py', nerf_313.yaml:14) — strip it
    if name.endswith(".py"):
        name = name[:-3]
    short = name.rsplit(".", 1)[-1]
    if short in reg:
        return reg[short]
    raise KeyError(
        f"no {kind!r} registered under {name!r}; have {sorted(reg)}"
    )


def build(kind: str, name: str, *args, **kwargs):
    return resolve(kind, name)(*args, **kwargs)


def registered(kind: str) -> list[str]:
    return sorted(_REGISTRIES[kind])
