"""What both loops do: the port's config for the cell over the generated
sequence, the weights from the seed, and the configuration's model family
and reference module."""
from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from .. import families, sequence
from ..harness import ROOT
from ..reference.common import iter_leaves, make_weights


def family(run):
    """The configuration's model family (benchmark/families/<reference>.py);
    CellError 2 where there is none."""
    return families.find(run.config["reference"])


def reference(run):
    """The configuration's plain reference module."""
    return importlib.import_module("benchmark.reference."
                                   + run.config["reference"])


def write_sequence(run):
    """The traffic's sequence, as many frames as the configuration trains,
    written from the seed under the run's scratch directory (TMPDIR), then
    the files the family's dataset reads beyond it; returns its root."""
    s = run.traffic["sequence"]
    n_frames = int(run.config["num_train_frame"])
    root = sequence.write_sequence(
        os.path.join(run.tmp, "CoreView_bench"), run.seed, n_frames,
        s["n_cams"], s["hw"], s["n_verts"], run.device)
    family(run).write_extra(root, run.seed, n_frames, run.config,
                            run.device)
    return root


def port_cfg(run, root, extra=()):
    """make_cfg of the configuration's YAML with its overrides, over the
    sequence at `root`; checkpoints and records under the scratch
    directory."""
    from neuralbody_tpu_torch.config import make_cfg
    data = []
    for split in ("train", "test"):
        data += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.human", os.path.basename(root),
                 f"{split}_dataset.ann_file", os.path.join(root,
                                                            "annots.npy")]
    cfg = make_cfg(os.path.join(ROOT, run.config["yaml"]),
                   opts=[*run.config["opts"], *data, "seed",
                         str(run.seed % 2 ** 31), *extra])
    for k in ("trained_model_dir", "record_dir", "result_dir"):
        cfg[k] = os.path.join(run.tmp, k)
    return cfg


def weights(run):
    """The reference's parameter tree drawn from the seed on the device."""
    ref = reference(run)
    return make_weights(ref.weight_spec(**run.config["weights"]), run.seed,
                        run.device)


def load_into(program_params, tree):
    """Copy the benchmark's weights into the program's parameter tensors in
    place (same tree, same shapes)."""
    for path, w in iter_leaves(tree):
        p = program_params
        for k in path:
            p = p[k]
        if tuple(p.shape) != tuple(w.shape):
            raise ValueError(f"parameter {path}: the program holds "
                             f"{tuple(p.shape)}, the reference "
                             f"{tuple(w.shape)}")
        with torch.no_grad():
            p.copy_(w)


def leaves(tree):
    """The tensors of a tree in iter_leaves' order, with their paths."""
    return list(iter_leaves(tree))


def pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def sample(seed, n, k):
    """k distinct indices of range(n) drawn from the seed."""
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def num_workers(run):
    """The configuration's loader workers, or the machine's cores less one
    if that is fewer."""
    return min(int(run.config["num_workers"]), (os.cpu_count() or 2) - 1)
