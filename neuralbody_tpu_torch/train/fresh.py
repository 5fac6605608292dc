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
hat plan, made by the C++ planner in the loader's workers), G =
cfg.tpu.steps_per_dispatch at a time trained in one dispatch each. As the
JAX Trainer does on one host, by default (bank=True) the loader leaves each
frame's geometry in its geom_cache (attach_geom=False), a device
GeomBank (parallel/geom.py) holds every frame once, and a DevicePrefetcher
of depth PREFETCH_DEPTH stages each group on a background thread
(parallel/transfer.StagingRing: pinned buffers, a side stream) for
train_step_scan_banked, on the card a CUDA graph (train/graphs.StepGraph)
that selects each step's frames from the bank. With bank=False (the JAX
Trainer's use_geom_bank off) each batch carries its geometry and a group
is stacked on the host and copied by train_step_scan. The tail of an epoch
that does not fill G is dropped, as the JAX Trainer drops it, unless the
epoch is shorter than G.

Every family trains, on the card as on the CPU: train/step.py sends
latent_xyzc's hat batches under Adam through the CUDA graph, and a batch
without a hat plan (the NeRF baseline) or another optimizer through the
eager loop (ROADMAP.md section 1, item 13 graphs those later). Each epoch
reseeds the render's generator the JAX Trainer's way (epoch * 100003 +
cfg.seed), so a run resumed at an epoch boundary makes the same draws.
train/trainer.Trainer adds checkpoints, the recorder, validation and fit
on top.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import build, make_cfg
from ..datasets.loader import make_data_loader, make_dataset
from ..parallel.geom import GeomBank, bank_capacity
from ..parallel.transfer import DevicePrefetcher, StagingRing
from ..utils.platform import resolve_device
from .optimizer import make_optimizer
from .step import train_step_scan, train_step_scan_banked

CONFIG_313 = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "configs", "zju_mocap_exp", "latent_xyzc_313.yaml")
PREFETCH_DEPTH = 2   # dispatch groups in the prefetcher (the JAX Trainer's)


def synthetic_cfg(dataset, mode, G, n_batches, n_samples=64,
                  path=CONFIG_313):
    """make_cfg of a latent_xyzc YAML (default the 313 config) sized to a
    utils/synthetic.SyntheticDataset: its rays, voxels and vertices, with
    n_samples samples a ray, compute dtype `mode`, G steps a dispatch and
    n_batches an epoch."""
    return make_cfg(path, opts=[
        "tpu.compute_dtype", mode, "tpu.steps_per_dispatch", str(G),
        "ep_iter", str(n_batches), "N_rand", str(dataset.n_rand),
        "N_samples", str(n_samples),
        "voxel_size", str(list(dataset.voxel_size)),
        "nv", str(dataset.n_verts)])


def with_geom(batch, meta, cache):
    """A batch of a loader with attach_geom=False, its frames' geometry
    attached from the loader's geom_cache as attach_geom=True gives it."""
    frames = [cache[k] for k in meta["geom_keys"]]
    return dict(batch, geom={n: np.stack([f[n] for f in frames])
                             for n in frames[0]})


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
    unless "cpu" is given; bank: train on a device geometry bank through
    the prefetcher (default) or stack each group's geometry on the host;
    staging: the StagingRing of the banked path (default PREFETCH_DEPTH + 1
    sets). Attributes: settings, params, bn_stats, opt and schedule
    (train/optimizer.make_optimizer(cfg)), generator, hat_state (the
    plan's static sizes, derived by the first epoch's first batches), G,
    geom_cache (the loader's frames), bank (a GeomBank, or None) and
    staging.
    """

    def __init__(self, cfg, dataset=None, pool=None, device=None, bank=True,
                 staging=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = (make_dataset(cfg, "train") if dataset is None
                        else dataset)
        self.pool = pool
        self.geom_cache = {} if pool is None else pool.geom_cache
        self.bank = self.staging = None
        if bank:
            self.bank = GeomBank(self.geom_cache,
                                 bank_capacity(self.dataset), self.device)
            self.staging = staging or StagingRing(self.device,
                                                  PREFETCH_DEPTH + 1)
        static = build("model_static", cfg.network_module, cfg, self.dataset)
        self.settings = build("renderer", cfg.renderer_module, cfg, static)
        # every registered trainer's loss is train/step.loss_fn, which the
        # steps call; resolving the name refuses a family not ported
        build("trainer", cfg.trainer_module, cfg)
        init_fn, _ = build("network", cfg.network_module, cfg)
        seed = int(cfg.get("seed", 0))
        self.params, self.bn_stats = init_fn(
            torch.Generator().manual_seed(seed), device=self.device)
        self.opt, self.schedule = make_optimizer(cfg, self.params)
        # the render's own draws (a NeRF family's perturbation and
        # importance samples, the raw-noise term), reseeded every epoch
        self.seed = seed
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.G = max(1, int(cfg.tpu.steps_per_dispatch))
        self.hat_state = {}

    def loader(self, epoch):
        """make_data_loader's training batches of `epoch` (without their
        geometry on the banked path: it stays in geom_cache)."""
        return make_data_loader(self.cfg, "train", dataset=self.dataset,
                                epoch=epoch, hat_state=self.hat_state,
                                pool=self.pool,
                                attach_geom=self.bank is None,
                                geom_cache=self.geom_cache)

    def _settings(self, batches):
        if "hat_sort" not in batches:
            return self.settings
        # the static expansion widths of the hat plan's row segments,
        # derived by the loader's first batches
        return self.settings._replace(
            hat_rows_caps=tuple(self.hat_state["rows_caps"]))

    def dispatch(self, batches):
        """Train on a list of numpy batches that carry their geometry, one
        step each, in one dispatch (stacked on the host). Returns the
        steps' stats, stacked."""
        stacked = stack_batches(batches)
        self.bn_stats, stats = train_step_scan(
            self.params, self.bn_stats, self.opt, stacked,
            self._settings(stacked), device=self.device,
            generator=self.generator)
        return stats

    def stage(self, item):
        """The prefetcher's work for one group (batches, their geom_keys):
        the bank's rows (new frames installed on the staging stream), the
        group stacked into a staging set and copied to the device. A family
        whose batches carry no geometry (the NeRF baseline) is staged
        without rows, as the JAX Trainer stages it."""
        group, keys = item
        if keys[0] is None:
            return self.staging.stage(group)
        return self.staging.stage(
            group, before=lambda: {"geom_rows": self.bank.rows(keys)})

    def dispatch_staged(self, staged):
        """Train on a staged group (stage()) in one dispatch, banked where
        it carries geom_rows."""
        settings = self._settings(staged)
        if "geom_rows" in staged:
            self.bn_stats, stats = train_step_scan_banked(
                self.params, self.bn_stats, self.opt, staged, self.bank,
                settings, device=self.device, generator=self.generator)
        else:
            self.bn_stats, stats = train_step_scan(
                self.params, self.bn_stats, self.opt, staged, settings,
                device=self.device, generator=self.generator)
        return stats

    def epoch(self, epoch, loader=None):
        """Train one epoch: yields each dispatch's stats. `loader` (default
        self.loader(epoch)) yields (batch, meta) pairs. On the banked path
        a group goes to the prefetcher when it is full, and every group
        staged by then is dispatched after each batch, as the JAX Trainer
        does (neuralbody_tpu/train/trainer.py:210-226)."""
        loader = self.loader(epoch) if loader is None else loader
        # the JAX Trainer's key of the epoch (trainer.py:119-120); the same
        # Generator object, so that a graph that registered it stays valid
        self.generator.manual_seed(epoch * 100003 + self.seed)
        pending, keys, full = [], [], False
        if self.bank is None:
            for batch, _ in loader:
                pending.append(batch)
                if len(pending) == self.G:
                    yield self.dispatch(pending)
                    pending, full = [], True
            if pending and not full:
                yield self.dispatch(pending)
            return
        prefetch = DevicePrefetcher(self.stage, depth=PREFETCH_DEPTH)
        try:
            for batch, meta in loader:
                pending.append(batch)
                keys.append(meta.get("geom_keys"))
                if len(pending) == self.G:
                    prefetch.submit((pending, keys))
                    pending, keys, full = [], [], True
                for staged in prefetch.ready():
                    yield self.dispatch_staged(staged)
            if pending and not full:
                prefetch.submit((pending, keys))
            for staged in prefetch.drain():
                yield self.dispatch_staged(staged)
        finally:
            # a stage() waiting for a set that an abandoned epoch holds
            # raises, the thread ends, and every set is free again
            self.staging.close()
            prefetch.close()
            self.staging.reopen()
