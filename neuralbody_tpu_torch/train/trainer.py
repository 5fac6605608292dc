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

One Trainer runs on one card (or on the CPU with device="cpu") in each
process of a group (parallel/bootstrap.py; train_net forms it): the ranks
start from rank 0's state, ConfigRun trains through the sharded step
(cfg.train.data_sharding "host": each rank its own frames), validate()
renders through parallel/train.ShardedEval on every rank, and only the
primary rank evaluates, records, prints and writes checkpoints.
"""
from __future__ import annotations

import itertools
import signal
import time

import numpy as np
import torch

from .. import evaluators  # noqa: F401  (registers plugins)
from ..config import build
from ..datasets.loader import WorkerPool, make_data_loader, make_dataset
from ..parallel import bootstrap
from ..parallel.mesh import replicate_state
from ..parallel.train import ShardedEval
from .checkpoint import load_checkpoint, save_checkpoint
from ..utils.profiling import span
from .fresh import ConfigRun
from .recorder import Recorder


class Trainer:
    """cfg: a config.make_cfg tree; device: the card unless "cpu" is
    given (in a group: this rank's card, bootstrap.local_device).
    Attributes: run (the ConfigRun: params, bn_stats, opt, settings),
    recorder, evaluator, rank, world, is_primary."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.rank, self.world = bootstrap.rank(), bootstrap.world()
        self.is_primary = self.rank == 0
        self.run = ConfigRun(cfg, device=bootstrap.run_device(device),
                             rank=self.rank, world=self.world)
        self.device = self.run.device
        if self.world > 1:
            replicate_state(self.run.params, self.run.bn_stats,
                            self.run.opt.state_dict())
        self.recorder = Recorder(cfg, self.is_primary)
        self.evaluator = build("evaluator", cfg.evaluator_module, cfg)
        self.pool = None
        # built at the first validate() and kept for the later ones
        self.test_dataset = None
        self.eval_fn = None

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
        """Write a checkpoint (the primary rank only)."""
        if not self.is_primary:
            return
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
        """Train one epoch. The recorder's data_time takes each batch's wait
        in the loader's next() (ConfigRun.data_waits), its batch_time each
        dispatch's whole wall time, from the previous dispatch's stats (or
        the epoch's start) to its own, over its steps. Spans (epoch,
        dispatch): train.iteration holds the epoch's work up to a
        dispatch's stats (ConfigRun's spans, and the loop's own time
        between them), train.readback reading the stats back,
        train.record the recorder's update, status line and record."""
        cfg, rec, run = self.cfg, self.recorder, self.run
        self._start_pool()
        loader = run.loader(epoch)
        n_iter = len(loader)
        it, t = 0, time.perf_counter()
        dispatches = run.epoch(epoch, loader=loader)
        for d in itertools.count():
            with span("train.iteration", epoch=epoch, dispatch=d):
                stats = next(dispatches, None)
            if stats is None:
                break
            g = len(stats["loss"])
            rec.step += g
            it += g
            for w in run.take_data_waits():
                rec.data_time.update(w)
            now = time.perf_counter()
            rec.batch_time.update((now - t) / g)
            t = now
            if it % cfg.log_interval < g and self.is_primary:
                with span("train.readback", epoch=epoch, dispatch=d):
                    # the last step's stats, read back in one copy
                    last = torch.stack([v[-1].float()
                                        for v in stats.values()]).tolist()
                with span("train.record", epoch=epoch, dispatch=d):
                    rec.update(dict(zip(stats, last)))
                    lr = float(run.schedule(rec.step))
                    print(rec.status_line(epoch, it, n_iter, lr),
                          flush=True)
            if it % cfg.record_interval < g:
                with span("train.record", epoch=epoch, dispatch=d):
                    rec.record("train")
        for w in run.take_data_waits():    # the epoch's end
            rec.data_time.update(w)

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
        batches, every family through eval_step and renderer/dispatch,
        the rays split over the ranks by ShardedEval), score them with the
        config's evaluator and record the metrics and the last view's
        pred|gt panel (the primary rank only). The test dataset is built at
        the first call and kept. Returns the evaluator's summary (None on
        the other ranks)."""
        if self.test_dataset is None:
            self.test_dataset = make_dataset(self.cfg, "test")
            self.eval_fn = ShardedEval(self.run.settings, self.device,
                                       self.rank, self.world)
        loader = make_data_loader(self.cfg, "test",
                                  dataset=self.test_dataset)
        for batch, meta in loader:
            ret = self.eval_fn(self.run.params, batch)
            if self.is_primary:
                self.evaluator.evaluate(ret, batch, meta)
        if not self.is_primary:
            return None
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
