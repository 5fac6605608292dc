"""Training through the port's Trainer: `Trainer.train_epoch` over the
generated sequence, closed loop, as train_net runs it.

Set-up builds one Trainer (its loader pool, ConfigRun, the banked CUDA
graph where the family has one), loads the benchmark's weights into it and
drives it from the seed through its first 1 + G steps with its own epochs
(G = cfg.tpu.steps_per_dispatch): an epoch of one step, whose optimizer
moments give the first gradient, then an epoch of G steps, which is one
dispatch of the window's own G-step graph; the parameters after it give
the change. Then the window: the YAML's epochs of ep_iter steps, until the
first dispatch read back --seconds after the window's start (the Trainer
reads every dispatch back, the YAML's log_interval 1); the epoch that
holds it runs on to its end outside the window. The same Trainer object
serves all of it. After the window the plain reference follows the 1 + G
steps from the same weights on the batches the loader gave them.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference.common import (Adam, near_far, pixels_of_rays,
                                precision, target_image, view_cameras)
from ..trace import Tracer
from .common import (family, leaves, load_into, num_workers, pick, port_cfg,
                     reference, weights, write_sequence)

FULL_KEYS = ("ray_o", "ray_d", "near", "far", "rgb", "ray_mask",
             "latent_index", "z_frac", "z_vals")
TRACE_KEYS = ("ray_o", "ray_d", "near", "far", "z_frac", "z_vals")
SKIP_BELOW = 1e-3   # of the median leaf's gradient norm: left out
PIXEL_TOL = 1e-2    # a ray's reprojection off its pixel's centre, pixels
TARGET_TOL = 2e-2   # a target colour off the reference's pixel


class Recorded:
    """A loader whose batches, and the time the Trainer waited for each,
    are noted on their way to the Trainer."""

    def __init__(self, loader, note):
        self.loader, self.note = loader, note

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                batch, meta = next(it)
            except StopIteration:
                return
            self.note(batch, meta, time.perf_counter() - t)
            yield batch, meta


def record(batch, meta, keys):
    """The host copy of a batch's `keys`, with its frame."""
    geom = meta.get("geom_keys")
    frame = (geom[0] if geom is not None and geom[0] is not None
             else meta.get("frame_index"))
    rec = {k: np.array(batch[k]) for k in keys if k in batch}
    rec["frame"] = int(frame)
    return rec


class Cell:
    def __init__(self, run):
        self.run = run
        self.family = family(run)
        self.ref = reference(run)
        self.first = []       # the checked steps' batches, whole
        self.kept = {}        # traced run: batch index -> TRACE_KEYS copy
        self.keep_until = None
        self.collect = None   # where a dispatch's loss tensor [G] goes
        self.in_window = False
        self.window_steps = 0
        self.tracer = None
        self.trace_left = 0
        self.trace_done = False
        self.traced_batches = []

    # -- the port ---------------------------------------------------------
    def setup(self):
        run = self.run
        from neuralbody_tpu_torch.train.trainer import Trainer
        run.phase("import")
        self.root = write_sequence(run)
        run.phase("sequence")
        cfg = port_cfg(run, self.root, extra=[
            "train.num_workers", str(num_workers(run))])
        self.cfg, self.ep_iter = cfg, int(cfg.ep_iter)
        self.trainer = tr = Trainer(
            cfg, device=None if run.device.type == "cuda" else "cpu")
        self.w0 = weights(run)
        load_into(tr.run.params, self.w0)
        run.phase("trainer and weights")
        self.G = tr.run.G
        self.n_rand = int(cfg.N_rand) * int(cfg.train.batch_size)
        orig_loader, orig_epoch = tr.run.loader, tr.run.epoch
        tr.run.loader = lambda e: Recorded(orig_loader(e), self._note)
        tr.run.epoch = lambda e, loader=None: self._epoch(orig_epoch, e,
                                                          loader)
        # the port sizes the hat plan from the first epoch's first batches
        # (at most 8; a user's first epoch has ep_iter of them): sized here
        # by a loader of a whole epoch, before the check's epoch of one
        # step. As train_epoch does, the pool starts first: its workers
        # take the dataset before the probe fills its caches
        tr._start_pool()
        probe = orig_loader(0)
        if probe.hat_cfg is not None:
            it = iter(probe)
            next(it)
            it.close()
        run.phase("hat plan sizes")
        self.collect = check_losses = []
        cfg.ep_iter = 1
        tr.train_epoch(0)
        b1 = tr.run.opt.b1
        self.g1 = [(pick(tr.run.opt.mu, p) / (1.0 - b1)).detach().clone()
                   for p, _ in leaves(self.w0)]
        run.phase("step 1 (the pool's first batches, a 1-step graph)")
        cfg.ep_iter = self.G
        tr.train_epoch(1)
        self.p_end = [pick(tr.run.params, p).detach().clone()
                      for p, _ in leaves(self.w0)]
        self.first_losses = torch.cat(check_losses).float().cpu()
        run.phase(f"steps 2-{self.G + 1} (the window's {self.G}-step "
                  "graph)")
        cfg.ep_iter = self.ep_iter
        self.collect = None
        self.epoch = 2
        self._sync()

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def _note(self, batch, meta, wait):
        """The checked steps' batches are copied whole; in a traced run,
        inside the window and until the trace is done, the batches the
        trace may need (TRACE_KEYS); no others."""
        if self.trace_left > 0:
            self.trace_wait += wait
        i = self.batch_i
        self.batch_i += 1
        if len(self.first) < 1 + self.G:
            self.first.append(record(batch, meta, FULL_KEYS))
        elif (self.run.trace and self.in_window and not self.trace_done
              and (self.keep_until is None or i < self.keep_until)):
            self.kept[i] = record(batch, meta, TRACE_KEYS)

    def _epoch(self, orig, e, loader):
        """ConfigRun.epoch with the benchmark's notes around each dispatch:
        the Trainer has read a dispatch back when it asks for the next."""
        self.batch_i = 0
        self.kept = {}
        it = orig(e, loader=loader)
        j = 0
        try:
            while True:
                self._before_dispatch(j)
                try:
                    stats = next(it)
                except StopIteration:
                    return
                if self.collect is not None:
                    self.collect.append(stats["loss"])
                yield stats
                self._after_dispatch(j)
                j += 1
        finally:
            it.close()

    def _before_dispatch(self, j):
        run = self.run
        if (run.trace and self.in_window and self.tracer is None
                and time.perf_counter() - self.t0 >= run.seconds / 3):
            self.tracer = Tracer(f"{run.tmp}/trace.json")
            self.trace_left = int(run.traffic["trace_dispatches"])
            self.keep_until = (j + self.trace_left) * self.G
            self.trace_wait = 0.0
            self.tracer.start()
            self.trace_t0 = time.perf_counter()

    def _after_dispatch(self, j):
        if not self.in_window:
            return
        self.window_steps += self.G
        span = range(j * self.G, (j + 1) * self.G)
        if self.trace_left > 0:
            self.traced_batches += [self.kept.pop(i) for i in span
                                    if i in self.kept]
            self.trace_left -= 1
            if self.trace_left == 0:
                self._finish_trace()
        for i in [i for i in self.kept if i < span.stop]:
            del self.kept[i]
        now = time.perf_counter()
        if now - self.t0 >= self.run.seconds:
            # the window ends with this dispatch read back; the epoch runs
            # on to its end, as a user's does, outside it
            self.t_end, self.in_window, self.collect = now, False, None
            if self.trace_left > 0:
                self._finish_trace()

    def _finish_trace(self):
        """Stop the profile after the traced dispatches (or at the window's
        end, where fewer fitted) and note what it saw."""
        run = self.run
        self._sync()
        wall = time.perf_counter() - self.trace_t0
        run.traced = self.tracer.stop()
        self.trace_left, self.trace_done, self.kept = 0, True, {}
        run.traced_info.update(
            data_wait_s=self.trace_wait, wall_s=wall,
            steps=len(self.traced_batches), batches=self.traced_batches)

    def window(self):
        tr = self.trainer
        self.collect = window_losses = []
        self.in_window = True
        self.t0 = time.perf_counter()
        while self.in_window:
            with torch.profiler.record_function("bench.train_epoch"):
                tr.train_epoch(self.epoch)
            self.epoch += 1
        self._sync()
        run = self.run
        run.metrics["train_rays_per_s"] = (self.window_steps * self.n_rand
                                           / (self.t_end - self.t0))
        losses = torch.cat(window_losses).float().cpu()
        run.attempted = int(losses.numel())
        run.failed = int((~torch.isfinite(losses)).sum())
        run.traced_info["cell"] = self

    def after_window(self):
        """Host ms of one batch on one thread: the dataset's __getitem__,
        collate and the plan, as the port's loader makes them without its
        pool (make_data_loader's own thread), on a fresh epoch."""
        from neuralbody_tpu_torch.datasets.loader import make_data_loader
        prog = self.trainer.run
        dl = make_data_loader(self.cfg, "train", dataset=prog.dataset,
                              epoch=self.epoch,
                              hat_state=dict(prog.hat_state),
                              attach_geom=False, geom_cache={})
        n = int(self.run.traffic["loader_batches"])
        it = iter(dl)
        with torch.profiler.record_function("bench.loader_batch"):
            t = time.perf_counter()
            for _ in range(n):
                next(it)
            self.run.traced_info["loader_batch_s"] = (
                (time.perf_counter() - t) / n)
        it.close()
        self.run.traced_info["staging_bytes"] = (
            None if prog.staging is None else prog.staging.set_bytes)

    def free(self):
        self.trainer.close()
        self.trainer = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def geometry(self):
        if not hasattr(self, "geos"):
            frames = range(int(self.run.config["num_train_frame"]))
            self.geos = self.family.geometry(self.root, frames,
                                             self.run.config)
        return self.geos

    def _element(self, rec):
        dev = self.run.device
        t = {k: torch.as_tensor(rec[k][0], device=dev)
             for k in ("ray_o", "ray_d", "near", "far", "rgb", "ray_mask")}
        if "z_frac" in rec:
            q = torch.as_tensor(rec["z_frac"][0].astype(np.float32),
                                device=dev)
            t["z"] = (t["near"][:, None] + (t["far"] - t["near"])[:, None]
                      * (q * np.float32(1.0 / 65535.0)))
        elif "z_vals" in rec:
            t["z"] = torch.as_tensor(rec["z_vals"][0], device=dev)
        t["frame"] = rec["frame"]
        t["latent_index"] = rec["frame"]
        return t

    def feed_check(self):
        """The loader's stage, checked by itself on the checked steps'
        batches: (violations, target_gap). A violation is a ray that does
        not start at a camera's centre or does not pass through a pixel's
        centre of the image at the configuration's ratio, or that misses
        the frame's world box or meets it elsewhere than the batch says
        (near and far within 1e-4 of the box's depth span), a depth outside
        its stratum (to the u16 quantum), a target colour outside [0, 1], a
        ray that does not count, or an appearance code that is not the
        frame's. target_gap: the largest gap of a ray's target colour from
        the pixel that the ray passes through, in the frame's image of that
        camera as the reference makes it from the raw files."""
        bad, gap = 0, 0.0
        S = int(self.cfg.N_samples)
        ratio = float(self.run.config["ratio"])
        cams, ims = view_cameras(self.root, ratio)
        images = {}
        for rec in self.first:
            geo = self.geometry()[rec["frame"]]
            ro, rd = rec["ray_o"][0], rec["ray_d"][0]
            near, far, hit = near_far(geo["box"], ro, rd)
            span = rec["far"][0] - rec["near"][0]
            bad += int((~hit).sum())
            if hit.all():
                bad += int((np.abs(near - rec["near"][0]) > 1e-4 * span).sum()
                           + (np.abs(far - rec["far"][0]) > 1e-4 * span).sum())
            cam, off, u, v = pixels_of_rays(cams, ro, rd)
            key = (rec["frame"], cam)
            if key not in images:
                images[key] = target_image(self.root,
                                           ims[rec["frame"]][cam], ratio)
            img = images[key]
            iu, iv = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
            inside = ((np.abs(u - iu) <= PIXEL_TOL)
                      & (np.abs(v - iv) <= PIXEL_TOL) & (iu >= 0)
                      & (iv >= 0) & (iu < img.shape[1]) & (iv < img.shape[0]))
            bad += int(off > 1e-4) * len(u) + int((~inside).sum())
            if inside.any():
                want = img[iv[inside], iu[inside]]
                gap = max(gap, float(np.abs(rec["rgb"][0][inside]
                                            - want).max()))
            el = self._element(rec)
            if "z" in el:      # depths the loader drew (the hat path)
                z = el["z"].cpu().numpy()
                n0, f0 = rec["near"][0][:, None], rec["far"][0][:, None]
                t = np.linspace(0.0, 1.0, S, dtype=np.float32)
                zl = n0 * (1.0 - t) + f0 * t
                mids = 0.5 * (zl[:, 1:] + zl[:, :-1])
                lo = np.concatenate([zl[:, :1], mids], 1)
                hi = np.concatenate([mids, zl[:, -1:]], 1)
                tol = (f0 - n0) * 2.0 / 65535.0 + 1e-6
                bad += int(((z < lo - tol) | (z > hi + tol)).sum())
            rgb = rec["rgb"][0]
            bad += int(((rgb < 0) | (rgb > 1)).sum())
            bad += int((rec["ray_mask"][0] != 1).sum())
            if "latent_index" in rec:
                bad += int(int(rec["latent_index"][0]) != rec["frame"])
        return bad, gap

    def reference_steps(self, tf32, half=False):
        """The reference's losses of the checked steps, its first clipped
        gradient and its parameters after the last, from the benchmark's
        weights. A step's device draws (a NeRF render's perturbation and
        importance samples) come from a generator seeded as the port's
        Trainer seeds its epochs' (epoch * 100003 + cfg.seed): step 1 is
        epoch 0's, the G steps after it epoch 1's. half: the fault of a
        step that leaves half of its batch out (the mean over the rest)."""
        ref, geos = self.ref, self.geometry()
        lr = float(self.run.config["lr"])
        dev, seed = self.run.device, int(self.cfg.seed)
        gens = [torch.Generator(dev).manual_seed(e * 100003 + seed)
                for e in (0, 1)]
        paths = [p for p, _ in leaves(self.w0)]
        flat = [w.detach().clone().requires_grad_(True)
                for _, w in leaves(self.w0)]
        tree = rebuild(self.w0, dict(zip(paths, flat)))
        opt = Adam(flat, lambda t: lr)
        losses, g1 = [], None
        with precision(tf32):
            for k, rec in enumerate(self.first):
                el = dict(self._element(rec), gen=gens[min(k, 1)])
                if half:
                    el["ray_mask"] = el["ray_mask"].clone()
                    el["ray_mask"][el["ray_mask"].shape[0] // 2:] = 0.0
                loss = ref.loss(tree, [el], geos, self.run.config)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(flat, grads)]
                clipped = opt.step(grads)
                losses.append(float(loss.detach()))
                if g1 is None:
                    g1 = [g.norm().item() for g in clipped]
        change = [(p.detach() - w).norm().item()
                  for p, (_, w) in zip(flat, leaves(self.w0))]
        return np.array(losses), np.array(g1), np.array(change)

    def compare(self, control):
        run = self.run
        lim = run.config["limits"]["train"]
        if not control:
            self.expect = self.reference_steps(tf32=False)
            seen = (self.first_losses.numpy(),
                    np.array([g.norm().item() for g in self.g1]),
                    np.array([(p - w).norm().item() for p, (_, w)
                              in zip(self.p_end, leaves(self.w0))]))
            gaps = step_gaps(seen, self.expect)
            steps = gaps.pop("loss_gaps")
            print("noted, not compared: loss gaps of the steps "
                  + ", ".join(repr(g) for g in steps) + "; " + " ".join(
                      f"{k} {v!r}" for k, v in gaps.items() if k not in lim),
                  flush=True)
            for k, v in gaps.items():
                if k in lim:
                    run.check(k, v, lim[k])
            bad, gap = self.feed_check()
            run.check("feed_violations", bad, lim["feed_violations"])
            run.check("target_gap", gap, lim["target_gap"])
        else:
            for name, kw in (("control (the reference in TF32)",
                              {"tf32": True}),
                             ("fault (half of each batch left out)",
                              {"tf32": False, "half": True})):
                gaps = step_gaps(self.reference_steps(**kw), self.expect)
                del gaps["loss_gaps"]
                print(f"{name}: "
                      + " ".join(f"{k} {v!r}" for k, v in gaps.items()),
                      flush=True)


def rebuild(tree, by_path, path=()):
    """`tree`'s structure with the leaves of by_path."""
    if isinstance(tree, dict):
        return {k: rebuild(v, by_path, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rebuild(v, by_path, path + (i,)) for i, v in enumerate(tree)]
    return by_path[path]


def step_gaps(seen, expect):
    """The numbers compared, of (losses [1 + G], first gradient norms
    [leaves], change norms [leaves]) against the reference's: the relative
    gap of each step's loss (step 1's; the mean over the steps; the mean
    and the largest over the G steps of the window's graph); over the
    leaves whose reference gradient is not nought to rounding (at least
    SKIP_BELOW of the median leaf's), the gap of the norms, each over the
    larger of the reference's norm of that leaf and of the median leaf: of
    the first gradient the worst and the median leaf's, of the change
    after the last step the median and the worst leaf's. A
    configuration's limits name the ones it compares; the rest are noted
    on stderr (PERF.md says why)."""
    (lp, gp, dp), (lr, gr, dr) = seen, expect
    keep = gr >= SKIP_BELOW * np.median(gr)

    def gaps(p, r):
        # a network with no gradient at all reads inf: there is nothing
        # to compare
        scale = np.maximum(r[keep], np.median(r[keep]))
        if not keep.any() or scale.max() <= 0:
            return np.array([np.inf])
        return np.abs(p[keep] - r[keep]) / scale

    loss = np.abs(lp - lr) / np.abs(lr)
    grad, change = gaps(gp, gr), gaps(dp, dr)
    return {"loss_gap": float(loss[0]), "loss_gaps": loss.tolist(),
            "loss_gap_mean": float(loss.mean()),
            "loss_gap_graph": float(loss[1:].mean()),
            "loss_gap_graph_max": float(loss[1:].max()),
            "grad_gap": float(grad.max()),
            "grad_gap_median": float(np.median(grad)),
            "change_gap": float(np.median(change)),
            "change_gap_worst_leaf": float(change.max())}

