"""Training from a config: the part of the JAX package's train_net.py ->
Trainer (neuralbody_tpu/train/trainer.py:30-226) that the port holds so far.

    run = ConfigRun(make_cfg("configs/zju_mocap_exp/latent_xyzc_313.yaml"),
                    dataset=SyntheticDataset(), pool=WorkerPool(ds, 2))
    for stats in run.epoch(0):
        ...

ConfigRun builds everything through the registered factories: the dataset
(unless one is given), the model's statics, the render settings, the loss
(every family's is train/step.loss_fn), the network's weights from a
torch.Generator seeded with cfg.seed, and Adam with the config's schedule.
An epoch is make_data_loader's batches (for latent_xyzc each carries its
hat plan, made by the C++ planner in the loader's workers, and its frame's
geometry), stacked G = cfg.tpu.steps_per_dispatch at a time on the host and
trained in one dispatch each: train_step_scan, on the card a CUDA graph
(train/graphs.StepGraph) that copies the G batches into its own buffers.
The tail of an epoch that does not fill G is dropped, as the JAX Trainer
drops it, unless the epoch is shorter than G.

With device="cpu" every family trains (train_step_scan is train_steps'
loop there); on the card the graph takes latent_xyzc's hat batches only,
and a family without a hat plan (the NeRF baseline) raises there until its
steps are graphed (ROADMAP.md section 1, item 13). The device geometry
bank, the prefetcher and checkpoints come with later slices (items 5 and
6).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import build
from ..datasets.loader import make_data_loader, make_dataset
from ..utils.platform import resolve_device
from .optimizer import make_lr_schedule, make_optimizer
from .step import train_step_scan


def optimizer_from_cfg(params, cfg):
    """Adam over `params` with cfg.train's learning rate, scheduler and
    weight decay and cfg.grad_clip_value (the JAX package's
    train/optimizer.make_optimizer(cfg))."""
    sch = cfg.train.scheduler
    schedule = make_lr_schedule(
        cfg.train.lr, sch.type, ep_iter=cfg.ep_iter, gamma=sch.gamma,
        decay_epochs=sch.get("decay_epochs", 1000),
        milestones=tuple(sch.get("milestones", ())),
        warmup_factor=sch.get("warmup_factor", 1.0 / 3),
        warmup_iters=sch.get("warmup_iters", 5),
        warmup_method=sch.get("warmup_method", "linear"))
    return make_optimizer(params, schedule, optim=cfg.train.optim,
                          clip=float(cfg.get("grad_clip_value", 40.0)),
                          weight_decay=float(cfg.train.weight_decay))


def stack_batches(batches):
    """Batches (numpy, or tensors on one device) stacked on a leading step
    axis: one dispatch."""
    first = batches[0]
    return {k: stack_batches([b[k] for b in batches])
            if isinstance(first[k], dict) else
            (torch.stack if isinstance(first[k], torch.Tensor) else np.stack)(
                [b[k] for b in batches])
            for k in first}


class ConfigRun:
    """The training state a config builds, and its epochs.

    cfg: a make_cfg tree; dataset: the training dataset (default
    make_dataset(cfg, "train")); pool: a started datasets/loader.WorkerPool
    over that dataset, or None for the loader's thread; device: the card
    unless "cpu" is given. Attributes: settings, params, bn_stats, opt,
    hat_state (the plan's static sizes, derived by the first epoch's first
    batches), G.
    """

    def __init__(self, cfg, dataset=None, pool=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = (make_dataset(cfg, "train") if dataset is None
                        else dataset)
        self.pool = pool
        static = build("model_static", cfg.network_module, cfg, self.dataset)
        self.settings = build("renderer", cfg.renderer_module, cfg, static)
        # every registered trainer's loss is train/step.loss_fn, which the
        # steps call; resolving the name refuses a family not ported
        build("trainer", cfg.trainer_module, cfg)
        init_fn, _ = build("network", cfg.network_module, cfg)
        seed = int(cfg.get("seed", 0))
        self.params, self.bn_stats = init_fn(
            torch.Generator().manual_seed(seed), device=self.device)
        self.opt = optimizer_from_cfg(self.params, cfg)
        # the render's own draws (a NeRF family's perturbation and
        # importance samples, the raw-noise term)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.G = max(1, int(cfg.tpu.steps_per_dispatch))
        self.hat_state = {}

    def loader(self, epoch):
        """make_data_loader's training batches of `epoch`."""
        return make_data_loader(self.cfg, "train", dataset=self.dataset,
                                epoch=epoch, hat_state=self.hat_state,
                                pool=self.pool)

    def dispatch(self, batches):
        """Train on a list of numpy batches, one step each, in one dispatch.
        Returns the steps' stats, stacked."""
        stacked = stack_batches(batches)
        settings = self.settings
        if "hat_sort" in stacked:
            # the static expansion widths of the hat plan's row segments,
            # derived by the loader's first batches
            settings = settings._replace(
                hat_rows_caps=tuple(self.hat_state["rows_caps"]))
        self.bn_stats, stats = train_step_scan(
            self.params, self.bn_stats, self.opt, stacked, settings,
            device=self.device, generator=self.generator)
        return stats

    def epoch(self, epoch, loader=None):
        """Train one epoch: yields each dispatch's stats. `loader` (default
        self.loader(epoch)) yields (batch, meta) pairs."""
        pending, full = [], False
        for batch, _ in (self.loader(epoch) if loader is None else loader):
            pending.append(batch)
            if len(pending) == self.G:
                yield self.dispatch(pending)
                pending, full = [], True
        if pending and not full:
            yield self.dispatch(pending)
