"""Training metrics recorder (counterpart of
neuralbody_tpu/train/recorder.py; host only).

Equivalent of the reference Recorder (ref: lib/train/recorder.py:10-125):
windowed median/average smoothing of scalar stats, tensorboard scalars and
HWC images at a record cadence, ETA/console status lines, own state for
resume. One Trainer runs on one card, so every Recorder writes (the JAX
package's primary-host rule has no counterpart). Where tensorboardX does
not import there is no writer (`has_writer` is False) and record() writes nothing.
"""
from __future__ import annotations

import datetime
import os
import time
from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    def __init__(self, window_size=20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        v = float(value)
        self.deque.append(v)
        self.count += 1
        self.total += v

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class Recorder:
    def __init__(self, cfg):
        self.cfg = cfg
        self.step = 0
        self.epoch = 0
        self.scalars = defaultdict(SmoothedValue)
        self.images = {}
        self.batch_time = SmoothedValue()
        self.data_time = SmoothedValue()
        self._writer = None
        os.makedirs(cfg.record_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._writer = SummaryWriter(log_dir=cfg.record_dir)

    @property
    def has_writer(self):
        return self._writer is not None

    def close(self):
        if self._writer is not None:
            self._writer.close()

    def update(self, stats: dict):
        for k, v in stats.items():
            self.scalars[k].update(v)

    def update_image_stats(self, images: dict):
        """Stage HWC float images in [0, 1] for the next record() call
        (ref recorder.py:71-78 update_image_stats; the reference's
        processor hook is dead code for every shipped task — all trainer
        wrappers return image_stats={} — so we record real pred/gt eval
        panels instead)."""
        for k, v in images.items():
            self.images[k] = np.asarray(v)

    def record(self, prefix="train", scalars=None):
        """Emit staged stats. scalars: explicit {name: float} dict (e.g.
        val metrics) instead of the smoothed training scalars — mirrors
        the reference's record(prefix, step, loss_stats) override arg."""
        if self._writer is None:
            return
        if scalars is not None:
            for k, v in scalars.items():
                self._writer.add_scalar(f"{prefix}/{k}", float(v), self.step)
        else:
            for k, v in self.scalars.items():
                self._writer.add_scalar(f"{prefix}/{k}", v.median, self.step)
        for k, v in self.images.items():
            self._writer.add_image(
                f"{prefix}/{k}", np.clip(v, 0.0, 1.0), self.step,
                dataformats="HWC")
        self.images.clear()

    def state_dict(self):
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state):
        self.step = int(state.get("step", 0))
        self.epoch = int(state.get("epoch", 0))

    def status_line(self, epoch, it, n_iter, lr):
        eta_sec = self.batch_time.global_avg * (n_iter - it)
        eta = str(datetime.timedelta(seconds=int(eta_sec)))
        parts = [f"eta: {eta}", f"epoch: {epoch}", f"step: {self.step}"]
        parts += [f"{k}: {v.median:.4f}" for k, v in self.scalars.items()]
        parts += [f"lr: {lr:.6f}",
                  f"data: {self.data_time.avg:.3f}s",
                  f"batch: {self.batch_time.avg:.3f}s"]
        return "  ".join(parts)


class Timer:
    def __init__(self):
        self.t = time.time()

    def tick(self):
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt
