"""Cells of BENCHMARK.json at a size a CPU test can hold: the same loops,
configurations and traffic with a small sequence, few rays and samples,
and coarse voxels."""
from __future__ import annotations

import copy
import json
import os

from benchmark import harness

TINY_OPTS = ["N_rand", "64", "N_samples", "8", "N_importance", "8",
             "voxel_size", "[0.02, 0.02, 0.02]", "nv", "400",
             "tpu.chunk_rays", "64", "training_view", "[0, 2]",
             "ep_iter", "16", "H", "64", "W", "64"]
TINY_SEQUENCE = {"n_cams": 4, "hw": 64, "n_verts": 400}


FIND_CELL = harness.find_cell


def tiny_cell(name):
    cell, conf, config, traffic = FIND_CELL(name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    frames = min(2, int(config["num_train_frame"]))
    config["opts"] = config["opts"] + TINY_OPTS + ["num_train_frame",
                                                   str(frames)]
    config["num_train_frame"] = frames
    config["voxel_size"] = [0.02, 0.02, 0.02]
    config["N_samples"], config["N_importance"] = 8, 8
    config["num_workers"] = 0
    if "nv" in config["weights"]:
        config["weights"] = {"nv": 400, "n_frames": frames}
    traffic["sequence"] = dict(TINY_SEQUENCE)
    traffic.update({k: v for k, v in {"loader_batches": 2,
                                       "compare_images": 2}.items()
                    if k in traffic})
    return cell, conf, config, traffic


def run_tiny(monkeypatch, name, seed=5, seconds=1.0, trace=0,
             device="cpu", control=0):
    """harness.main over the tiny cell (the harness's look for a card
    skipped: `device` given); returns its result."""
    monkeypatch.setattr(harness, "find_cell", lambda n, bench=None:
                        tiny_cell(n))
    return harness.main(0.0, ["--workload", name, "--seed", str(seed),
                              "--seconds", str(seconds), "--trace",
                              str(trace), "--control", str(control)],
                        device=device)


def load_bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
