"""The training harness: epochs, checkpoints, records and validation around
train/fresh.ConfigRun (counterpart of neuralbody_tpu/train/trainer.py).

    trainer = Trainer(make_cfg("configs/zju_mocap_exp/latent_xyzc_313.yaml"))
    trainer.fit()           # resume, the epochs, the checkpoint cadence
    trainer.validate()      # PSNR / SSIM of the test views
    trainer.close()

ConfigRun builds the model, its weights, the optimizer and the render
settings from the config, and trains an epoch's dispatches (G =
cfg.tpu.steps_per_dispatch steps each, the tail dropped): on the card
latent_xyzc's hat batches under Adam through the banked CUDA graph, every
other family or optimizer through eager steps. The Trainer adds one loader
pool for the whole run (cfg.train.num_workers > 0; started at the first
epoch), the recorder (a dispatch's stats are read back only when the log
interval falls in it), checkpoints in the JAX package's file layout
(train/checkpoint.py), the reference's save_ep / save_latest_ep / eval_ep
cadence, a checkpoint at the next epoch boundary on SIGTERM or SIGINT, and
validate(): the test views through eval_step and the config's evaluator.
One Trainer runs on one card (or on the CPU with device="cpu").
"""
from __future__ import annotations

import signal

import numpy as np
import torch

from .. import evaluators  # noqa: F401  (registers plugins)
from ..config import build
from ..datasets.loader import WorkerPool, make_data_loader, make_dataset
from .checkpoint import load_checkpoint, save_checkpoint
from .fresh import ConfigRun
from .recorder import Recorder, Timer
from .step import eval_step


class Trainer:
    """cfg: a config.make_cfg tree; device: the card unless "cpu" is
    given. Attributes: run (the ConfigRun: params, bn_stats, opt,
    settings), recorder, evaluator."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.run = ConfigRun(cfg, device=device)
        self.device = self.run.device
        self.recorder = Recorder(cfg)
        self.evaluator = build("evaluator", cfg.evaluator_module, cfg)
        self.pool = None
        # built at the first validate() and kept for the later ones
        self.test_dataset = None

    @property
    def params(self):
        return self.run.params

    @property
    def bn_stats(self):
        return self.run.bn_stats

    @property
    def opt(self):
        return self.run.opt

    def close(self):
        """Stop the loader pool and close the recorder's writer."""
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None
            self.run.pool = None
        self.recorder.close()

    # -- checkpoint -------------------------------------------------------
    def resume(self):
        """Load cfg.trained_model_dir's latest checkpoint into the
        parameters, BN stats and optimizer state in place (when
        cfg.resume); returns the epoch to begin at."""
        rec_state, begin = load_checkpoint(
            self.cfg.trained_model_dir, self.run.params, self.run.bn_stats,
            self.run.opt, resume=self.cfg.resume)
        if rec_state:
            self.recorder.load_state_dict(rec_state)
        return begin

    def save(self, epoch, latest=False):
        save_checkpoint(self.cfg.trained_model_dir, epoch, self.run.params,
                        self.run.bn_stats, self.run.opt,
                        self.recorder.state_dict(), latest=latest)

    # -- train ------------------------------------------------------------
    def _start_pool(self):
        """The run's loader pool, started once (the JAX Trainer's _pool);
        its frames go to the cache the run's geometry bank reads."""
        nw = int(self.cfg.train.get("num_workers", 0))
        if nw > 0 and self.pool is None:
            self.pool = WorkerPool(self.run.dataset, nw)
            self.pool.geom_cache = self.run.geom_cache
            self.run.pool = self.pool

    def train_epoch(self, epoch):
        cfg, rec = self.cfg, self.recorder
        self._start_pool()
        loader = self.run.loader(epoch)
        n_iter = len(loader)
        timer = Timer()

        def timed(batches):
            for item in batches:
                rec.data_time.update(timer.tick())
                yield item

        it = 0
        for stats in self.run.epoch(epoch, loader=timed(loader)):
            g = len(stats["loss"])
            rec.step += g
            it += g
            rec.batch_time.update(timer.tick() / g)
            if it % cfg.log_interval < g:
                # the last step's stats, read back in one copy
                last = torch.stack([v[-1].float() for v in stats.values()])
                rec.update(dict(zip(stats, last.tolist())))
                lr = float(self.run.schedule(rec.step))
                print(rec.status_line(epoch, it, n_iter, lr), flush=True)
            if it % cfg.record_interval < g:
                rec.record("train")

    def fit(self):
        """Resume, then train epochs up to cfg.train.epoch with the
        reference's cadence and latest.ckpt at the end (when an epoch
        ran). SIGTERM and SIGINT ask for latest.ckpt at the next epoch
        boundary and end the run there; the previous handlers are restored
        when fit returns."""
        cfg = self.cfg
        begin = self.resume()
        stop = {"flag": False}

        def _request_stop(signum, frame):
            stop["flag"] = True

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _request_stop)
            except ValueError:
                pass   # not the main thread
        try:
            for epoch in range(begin, cfg.train.epoch):
                self.recorder.epoch = epoch
                self.train_epoch(epoch)
                if stop["flag"]:
                    self.save(epoch, latest=True)
                    print(f"preempted: checkpointed epoch {epoch}",
                          flush=True)
                    return
                if (epoch + 1) % cfg.save_ep == 0:
                    self.save(epoch)
                if (epoch + 1) % cfg.save_latest_ep == 0:
                    self.save(epoch, latest=True)
                if (epoch + 1) % cfg.eval_ep == 0 and not cfg.skip_eval:
                    self.validate()
            # the JAX Trainer saves here even when no epoch ran, which with
            # train.epoch 0 (train_net --test) writes a latest.ckpt of
            # epoch -1 over the one it resumed from
            if begin < cfg.train.epoch:
                self.save(cfg.train.epoch - 1, latest=True)
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)

    # -- eval -------------------------------------------------------------
    def validate(self):
        """Render the test views (make_data_loader(cfg, "test"): rays-only
        batches, every family through eval_step and renderer/dispatch),
        score them with the config's evaluator and record the metrics and
        the last view's pred|gt panel. The test dataset is built at the
        first call and kept. Returns the evaluator's summary."""
        if self.test_dataset is None:
            self.test_dataset = make_dataset(self.cfg, "test")
        loader = make_data_loader(self.cfg, "test",
                                  dataset=self.test_dataset)
        for batch, meta in loader:
            ret = eval_step(self.run.params, batch, self.run.settings,
                            device=self.device)
            self.evaluator.evaluate(ret, batch, meta)
        last = getattr(self.evaluator, "last_images", None)
        if last is not None:
            self.recorder.update_image_stats(
                {"pred_vs_gt": np.concatenate(last, axis=1)})
        metrics = self.evaluator.summarize()
        # an evaluator with no metrics (if_nerf_mesh) records nothing: the
        # JAX Trainer records the smoothed training scalars as "val" then
        if metrics:
            self.recorder.record("val", scalars=metrics)
        return metrics
