"""Rendering held-out views through the port's evaluation path: the test
split's loader (make_data_loader(cfg, "test"), rays-only batches of every
pixel whose ray meets the body's box), each image through
parallel/train.ShardedEval (with one process, train/step.eval_step: for
latent_xyzc the plan-free render in chunks, for the NeRF baseline coarse and
fine), its rgb read back to the host. This is what run.py evaluate and
visualize and Trainer.validate run, without the evaluator's scoring.

Closed loop, one image after another, the test loader's order repeated:
an image's time runs from the end of the one before (or the window's
start) to its rgb on the host, so the host's work on the batch counts
where the device waits for it. After the window the plain reference renders
a sample of the finished images, drawn from the seed, with the one of the
most rays among them.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference.common import precision, view_rays
from ..trace import Tracer
from .common import (family, load_into, port_cfg, reference, sample,
                     weights, write_sequence)


class Cell:
    def __init__(self, run):
        self.run = run
        self.family = family(run)
        self.ref = reference(run)
        self.images = []     # (frame, camera, rays, rgb [n, 3]) per image
        self.times = []
        self.tracer = None

    def setup(self):
        run = self.run
        from neuralbody_tpu_torch.config import build
        from neuralbody_tpu_torch.datasets.loader import make_dataset
        from neuralbody_tpu_torch.parallel.train import ShardedEval
        run.phase("import")
        self.root = write_sequence(run)
        run.phase("sequence")
        cfg = port_cfg(run, self.root, extra=["train.num_workers", "0"])
        cfg.perturb = 0      # run.py's tool-time setting
        self.cfg = cfg
        self.dataset = make_dataset(cfg, "test")
        static = build("model_static", cfg.network_module, cfg, self.dataset)
        self.settings = build("renderer", cfg.renderer_module, cfg, static)
        init_fn, _ = build("network", cfg.network_module, cfg)
        self.params, _ = init_fn(torch.Generator().manual_seed(0),
                                 device=run.device)
        self.w = weights(run)
        load_into(self.params, self.w)
        self.eval_fn = ShardedEval(self.settings, run.device)
        run.phase("dataset and weights")
        for i, (batch, meta) in enumerate(self.loader()):
            if i >= int(run.traffic["warm_images"]):
                break
            self.render(batch, meta)
        self._sync()
        run.phase("warm images")

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def loader(self):
        from neuralbody_tpu_torch.datasets.loader import make_data_loader
        return make_data_loader(self.cfg, "test", dataset=self.dataset)

    def render(self, batch, meta):
        with torch.profiler.record_function("bench.render_image"):
            ret = self.eval_fn(self.params, batch)
        n = int(np.asarray(meta["mask_at_box"]).sum())
        with torch.profiler.record_function("bench.readback"):
            rgb = ret["rgb_map"][0, :n].cpu()
        return rgb

    def window(self):
        run = self.run
        t0 = prev = time.perf_counter()
        n_trace = int(run.traffic["trace_images"]) if run.trace else 0
        done = False
        while not done:
            it = iter(self.loader())
            for batch, meta in it:
                if n_trace and self.tracer is None and (
                        prev - t0 >= run.seconds / 3):
                    self.tracer = Tracer(f"{run.tmp}/trace.json")
                    self.tracer.start()
                    t_trace, traced = prev, []
                rgb = self.render(batch, meta)
                now = time.perf_counter()
                self.times.append(now - prev)
                prev = now
                key = (int(meta["frame_index"]), int(meta["cam_ind"]))
                self.images.append((key, rgb))
                if self.tracer is not None and n_trace:
                    traced.append((key, rgb.shape[0]))
                    if len(traced) == n_trace or now - t0 >= run.seconds:
                        wall = time.perf_counter() - t_trace
                        run.traced = self.tracer.stop()
                        run.traced_info.update(images=traced, wall_s=wall)
                        n_trace = 0
                        prev = time.perf_counter()
                if prev - t0 >= run.seconds:
                    done = True
                    break
            for _ in it:      # the loader's thread ends with its pass
                pass
        wall = sum(self.times)
        run.metrics["image_ms"] = 1e3 * wall / len(self.times)
        run.metrics["image_ms_p75"] = 1e3 * float(
            np.quantile(np.array(self.times), 0.75))
        run.attempted = len(self.times)
        run.failed = sum(int(not torch.isfinite(rgb).all())
                         for _, rgb in self.images)
        run.traced_info["cell"] = self

    def after_window(self):
        pass

    def free(self):
        del self.eval_fn, self.params
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def view(self, frame, cam):
        """The rays of a held-out view, worked out from the sequence."""
        ann = np.load(f"{self.root}/annots.npy", allow_pickle=True).item()
        cams = ann["cams"]
        ratio = float(self.run.config["ratio"])
        hw = int(self.run.traffic["sequence"]["hw"])
        K = np.array(cams["K"][cam], np.float64).copy()
        K[0] *= ratio
        K[1] *= ratio
        R = np.array(cams["R"][cam])
        T = np.array(cams["T"][cam]) / 1000.0
        geo = self.geometry()[frame]
        H = W = int(hw * ratio)
        return view_rays(K, R, T, H, W, geo["box"])

    def geometry(self):
        if not hasattr(self, "geos"):
            frames = range(int(self.run.config["num_train_frame"]))
            self.geos = self.family.geometry(self.root, frames,
                                             self.run.config)
        return self.geos

    def chosen(self):
        """The images compared: a sample drawn from the seed, and the one
        of the most rays."""
        k = int(self.run.traffic["compare_images"])
        idx = set(sample(self.run.seed, len(self.images), k))
        idx.add(max(range(len(self.images)),
                    key=lambda i: self.images[i][1].shape[0]))
        return sorted(idx)

    def reference_image(self, frame, cam, tf32):
        dev = self.run.device
        ro, rd, near, far, _ = self.view(frame, cam)
        t = [torch.as_tensor(a, device=dev) for a in (ro, rd, near, far)]
        with precision(tf32):
            return self.ref.render_image(self.w, self.geometry()[frame],
                                         frame, *t, self.run.config)

    def compare(self, control):
        run = self.run
        lim = run.config["limits"]["render"]
        gap, mismatch = 0.0, 0
        for i in self.chosen():
            (frame, cam), rgb = self.images[i]
            if control:
                got = self.reference_image(frame, cam, tf32=True)
                rgb = self.expect[(frame, cam)]
            else:
                got = self.reference_image(frame, cam, tf32=False)
                self.expect = getattr(self, "expect", {})
                self.expect[(frame, cam)] = got.cpu()
            got = got.cpu()
            if got.shape != rgb.shape:
                mismatch += 1
                continue
            gap = max(gap, float((rgb - got).abs().max()))
        if control:
            print(f"control (the reference in TF32): rgb_gap {gap!r}",
                  flush=True)
            return
        run.check("rgb_gap", gap, lim["rgb_gap"])
        run.check("ray_count_mismatch", mismatch, 0)
