"""A model family is found by the configuration's `reference` name alone:
a stub family put into the lookup drives a whole tiny run on the CPU (its
extra file written before the Trainer's dataset opens it, its geometry
read by the loader's check, its count read by the per-layer metrics), and
a name with no family ends the run at set-up with exit code 2."""
import os
import types

import numpy as np
import pytest
import torch

from benchmark import families, harness, roofline, sequence, work
from benchmark.families import latent_xyzc
from benchmark.tests.tiny import run_tiny, tiny_cell

EXTRA = "stub_extra.npy"
FLOPS = 1e12


def test_stub_family_drives_a_run(monkeypatch):
    torch.set_num_threads(2)
    from benchmark.loops import trainer
    from neuralbody_tpu_torch.datasets import zju_mocap
    events, boxes, counted = [], set(), []

    def write_extra(root, seed, n_frames, config, device):
        events.append("write_extra")
        np.save(os.path.join(root, EXTRA), np.arange(n_frames) + seed)

    def geometry(root, frames, config):
        geo = latent_xyzc.geometry(root, frames, config)
        boxes.update(id(g["box"]) for g in geo.values())
        return geo

    def train_work(run):
        counted.append(len(run.traced_info["batches"]))
        return {"conv": roofline.Work(), "hat": roofline.Work(),
                "dense": roofline.Work(), "model_flops": FLOPS}

    stub = types.SimpleNamespace(write_extra=write_extra, geometry=geometry,
                                 train_work=train_work,
                                 render_work=latent_xyzc.render_work)
    monkeypatch.setattr(families, "find", lambda name: stub)

    plain_init = zju_mocap.MultiViewDataset.__init__

    def init(self, cfg, data_cfg, split):
        path = os.path.join(data_cfg.data_root, EXTRA)
        events.append(("dataset", np.load(path).tolist()))
        plain_init(self, cfg, data_cfg, split)
    monkeypatch.setattr(zju_mocap.MultiViewDataset, "__init__", init)

    plain_near_far = trainer.near_far

    def near_far(box, ro, rd):
        events.append(("feed_check", id(box) in boxes))
        return plain_near_far(box, ro, rd)
    monkeypatch.setattr(trainer, "near_far", near_far)

    # a window of 0 s: its one dispatch is traced, however long it takes
    out = run_tiny(monkeypatch, "latent_xyzc_313.train", seed=5,
                   seconds=0.0, trace=1)
    assert out["correct"], out["checks"]
    # written first, on disk with its content when the dataset is built
    assert events[0] == "write_extra"
    built = [e for e in events if e[0] == "dataset"]
    assert built and all(e == ("dataset", [5, 6]) for e in built), events
    checked = [e for e in events if e[0] == "feed_check"]
    assert checked and all(e[1] for e in checked), events
    # the per-layer metrics read the stub's count of the traced steps
    assert counted and all(n > 0 for n in counted)
    mfu = out["metrics"]["mfu.train"]["value"]
    assert mfu == pytest.approx(100.0 * FLOPS / (
        out["device"]["window_s"] * roofline.PEAK_FLOPS["float32"]))


def _run_unknown(monkeypatch):
    def find_cell(name, bench=None):
        cell, conf, config, traffic = tiny_cell(name)
        config["reference"] = "no_such_family"
        return cell, conf, config, traffic

    def never(*args, **kw):
        raise AssertionError("the sequence was written")
    monkeypatch.setattr(harness, "find_cell", find_cell)
    monkeypatch.setattr(sequence, "write_sequence", never)
    harness.main(0.0, ["--workload", "nerf_313.train", "--seed", "5",
                       "--seconds", "1"], device="cpu")


def _count_unknown(kind):
    def go(monkeypatch):
        run = types.SimpleNamespace(config={"reference": "no_such_family"},
                                    traced_info={"batches": [],
                                                 "images": []})
        getattr(work, kind)(run)
    return go


@pytest.mark.parametrize("entry", [_run_unknown, _count_unknown("train"),
                                   _count_unknown("render")],
                         ids=["run", "work.train", "work.render"])
def test_unknown_family_refused(monkeypatch, entry):
    with pytest.raises(harness.CellError) as e:
        entry(monkeypatch)
    assert e.value.code == 2 and "no_such_family" in e.value.msg
