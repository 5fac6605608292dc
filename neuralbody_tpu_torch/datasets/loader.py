"""Batch assembly: static-shape collation and a parallel prefetching loader
(counterpart of neuralbody_tpu/datasets/loader.py; numpy, host only).

The device only ever sees fixed shapes: train batches carry exactly N_rand
rays; eval batches pad the variable hit-ray count up to a power-of-two
multiple of chunk_rays with ray_mask=0. Host-only fields (image-space hit
mask, indices) travel in a separate meta dict that never reaches the card.

Parallelism: train batches are produced by persistent spawn-based worker
processes. Every batch is a pure function of (dataset, epoch, batch index)
(the global numpy RNG is reseeded per batch), so the stream is identical
for any worker count and equals the JAX package's loader bit for bit. The
heavy frame-geometry tables are shipped once per (worker, frame) and cached
parent-side, not re-pickled per batch. Where the JAX package differs:
a worker or producer thread that raises makes the parent raise (the JAX
pool waits for ever), the children are kept off the card by
CUDA_VISIBLE_DEVICES="", and plan_device=True (the device planner) raises
NotImplementedError.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import NamedTuple

import numpy as np

from ..config import build, register, resolve
from . import samplers

DEVICE_KEYS = ("geom", "rgb", "ray_o", "ray_d", "near", "far", "ray_mask",
               "R", "Th", "bounds", "latent_index", "Ks", "RT", "msks", "pts",
               "R0_snap", "Th0_snap", "K",
               "tbounds", "pbounds", "ptot_pts")


def pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _stack(vals):
    """np.stack with a copy-free fast path for batch_size 1 (the reference
    recipe): a [None] view instead of a fresh allocation."""
    if len(vals) == 1:
        return np.asarray(vals[0])[None]
    return np.stack(vals)


def collate(samples, chunk_rays):
    """Stack samples into a (device_batch, meta) pair with padded rays.

    Mesh batches carry no rays (dense grid 'pts', pre-padded by the
    dataset to pt_chunk multiples); everything else pads the variable ray
    count up to a chunk_rays multiple with ray_mask=0 entries."""
    has_rays = "rgb" in samples[0]
    if has_rays:
        n_rays = max(s["rgb"].shape[0] for s in samples)
        # pad to a POWER-OF-TWO multiple of chunk_rays: eval images have
        # frame-varying hit-ray counts, and each distinct padded size is a
        # separate XLA compile of the sharded eval step (parallel/train.py);
        # bucketing bounds compiles at ~log2 per sequence
        units = max(1, -(-n_rays // chunk_rays))
        units = 1 << (units - 1).bit_length()
        n_rays = units * chunk_rays

    device, meta = {}, {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == "geom":
            device["geom"] = {
                k: _stack([v[k] for v in vals]) for k in vals[0]
            }
        elif has_rays and key in ("rgb", "ray_o", "ray_d", "near", "far"):
            device[key] = _stack([pad_to(np.asarray(v), n_rays) for v in vals])
        elif key in DEVICE_KEYS:
            device[key] = _stack([np.asarray(v) for v in vals])
        else:
            meta[key] = vals if len(vals) > 1 else vals[0]

    if has_rays:
        device["ray_mask"] = _stack([
            pad_to(np.ones(s["rgb"].shape[0], np.float32), n_rays)
            for s in samples
        ])
    device["Th"] = device["Th"].reshape(len(samples), 1, 3)
    return device, meta


class HatSpec(NamedTuple):
    """Picklable hat-planner parameters (crosses the worker boundary)."""
    out_sh: tuple
    site_caps: tuple
    voxel_size: tuple
    n_samples: int
    group_size: int
    tile: tuple
    rows_caps: tuple   # static total-row caps (None while deriving)
    seg_caps: tuple    # static segment-count caps (None while deriving)
    n_groups: int      # static group count (None while deriving)
    perturb: bool
    # ship z as u16 slab fractions (halves the largest payload leaf;
    # ops/hat_interp.prepare_hat_batch quantize_z)
    quantize_z: bool = True


def _batch_seed(epoch, batch_idx, seed0=0):
    """Every batch is a pure function of (epoch, batch index): the stream
    is identical for any worker count and across hosts (the reference gets
    per-worker streams instead, via worker_init_fn reseeding)."""
    return (epoch * 1000003 + batch_idx * 7919 + seed0) % (2 ** 31 - 1)


def apply_hat_spec(device, spec: HatSpec, seed):
    from ..ops.hat_interp import prepare_hat_batch
    rng = np.random.RandomState(seed) if spec.perturb else None
    device, hs = prepare_hat_batch(
        device, spec.out_sh, spec.site_caps, spec.voxel_size,
        spec.n_samples, group_size=spec.group_size, tile=spec.tile,
        rows_caps=spec.rows_caps, seg_caps=spec.seg_caps,
        n_groups=spec.n_groups, rng=rng, quantize_z=spec.quantize_z)
    return device, hs


def produce_batch(dataset, indices, bi, batch_size, chunk_rays, spec,
                  epoch, seed0):
    """Build batch `bi` deterministically (reseeds the global numpy RNG)."""
    np.random.seed(_batch_seed(epoch, bi, seed0))
    batch_idx = indices[bi * batch_size:(bi + 1) * batch_size]
    samples = [dataset[j] for j in batch_idx]
    device, meta = collate(samples, chunk_rays)
    if spec is not None and spec.rows_caps is not None:
        device, _ = apply_hat_spec(device, spec,
                                   _batch_seed(epoch, bi, seed0 + 1))
    return device, meta


def _geom_keys(meta):
    keys = meta.get("geom_key")
    if keys is None:
        return None
    if not isinstance(keys, list):
        keys = [keys]
    return [int(k) for k in keys]


def _worker_main(dataset, wid, num_workers, task_q, result_q):
    """Loader worker loop: produce every (first_bi + wid + k*W)-th batch.

    Geometry tables are shipped at most once per (worker, frame); later
    batches reference them by geom_key (parent-side cache). An exception
    goes back to the parent as (epoch, "error", wid, traceback, None)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # never touch the card
    shipped = set()
    epoch = None
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            (epoch, indices, batch_size, chunk_rays, spec, seed0,
             first_bi, n_batches) = task
            for bi in range(first_bi + wid, n_batches, num_workers):
                device, meta = produce_batch(
                    dataset, indices, bi, batch_size, chunk_rays, spec,
                    epoch, seed0)
                payload = None
                keys = _geom_keys(meta)
                if keys is not None:
                    geom = device.pop("geom")
                    payload = {
                        k: {n: v[i] for n, v in geom.items()}
                        for i, k in enumerate(keys) if k not in shipped
                    }
                    shipped.update(keys)
                    meta["_geom_keys"] = keys
                result_q.put((epoch, bi, device, meta, payload))
            result_q.put((epoch, None, None, None, None))
    except BaseException:  # noqa: BLE001 — re-raised in the parent
        import traceback
        result_q.put((epoch, "error", wid, traceback.format_exc(), None))


class WorkerPool:
    """Persistent spawn-based loader workers (live across epochs).

    Spawn (not fork): the parent owns a CUDA context that must not be
    duplicated into children. CUDA_VISIBLE_DEVICES="" is set in the
    environment while the children start (and restored after), so a worker
    sees no card and can never create a CUDA context. A worker that raises
    sends its traceback back and the parent raises it; a worker that dies
    without a word is found by the parent's timed wait.
    """

    POLL_S = 5.0   # the parent's wait between liveness checks of the workers

    def __init__(self, dataset, num_workers):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.num_workers = num_workers
        self.geom_cache = {}
        self._failed = False
        self._tasks = [ctx.Queue() for _ in range(num_workers)]
        self._results = ctx.Queue(maxsize=2 * num_workers + 2)
        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            self._procs = [
                ctx.Process(target=_worker_main,
                            args=(dataset, w, num_workers,
                                  self._tasks[w], self._results),
                            daemon=True)
                for w in range(num_workers)
            ]
            for p in self._procs:
                p.start()
        finally:
            if prev is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev

    def _get(self):
        """The next result; raises when a worker failed or died."""
        while True:
            try:
                res = self._results.get(timeout=self.POLL_S)
            except queue.Empty:
                dead = [(w, p.exitcode) for w, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    self._failed = True
                    raise RuntimeError(
                        f"loader workers died (worker, exit code): {dead}")
                continue
            if res[1] == "error":
                self._failed = True
                raise RuntimeError(f"loader worker {res[2]} failed:\n"
                                   f"{res[3]}")
            return res

    def _attach_geom(self, device, meta, payload, attach=True):
        if payload:
            self.geom_cache.update(payload)
        keys = meta.pop("_geom_keys", None)
        if keys is not None:
            if attach:
                geoms = [self.geom_cache[k] for k in keys]
                device["geom"] = {
                    n: np.stack([g[n] for g in geoms]) for n in geoms[0]
                }
            else:
                # device-geom mode: consumer assembles the stacked geom on
                # DEVICE from a per-frame cache (geometry is frame-static;
                # re-transferring ~15 MB/batch over the host->TPU link was
                # the production pipeline's bottleneck)
                meta["geom_keys"] = keys
        return device, meta

    def run_epoch(self, epoch, indices, batch_size, chunk_rays, spec,
                  seed0, first_bi, n_batches, attach_geom=True):
        task = (epoch, list(indices), batch_size, chunk_rays, spec, seed0,
                first_bi, n_batches)
        for q in self._tasks:
            q.put(task)
        buf, done, next_bi = {}, 0, first_bi
        while done < self.num_workers or buf:
            if next_bi in buf:
                device, meta, payload = buf.pop(next_bi)
                next_bi += 1
                yield self._attach_geom(device, meta, payload, attach_geom)
                continue
            _, bi, device, meta, payload = self._get()
            if bi is None:
                done += 1
            else:
                buf[bi] = (device, meta, payload)
        # drain any leftovers (shouldn't happen; defensive)
        while next_bi in buf:
            device, meta, payload = buf.pop(next_bi)
            next_bi += 1
            yield self._attach_geom(device, meta, payload, attach_geom)

    def shutdown(self):
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            # a worker blocked on a full result queue (the parent stopped
            # reading after an error) never reads its None
            p.join(timeout=0 if self._failed else 10)
            if p.is_alive():
                p.terminate()
                p.join()


class DataLoader:
    """Iterates (device_batch, meta); parallel workers or thread prefetch.

    hat_cfg (dict of HatSpec fields minus the static caps) enables the
    host-side hat-interpolation planner; hat_state persists the derived
    static sizes (rows_caps, n_groups) across batches/epochs so the device
    compiles once.
    """

    def __init__(self, dataset, indices, chunk_rays, batch_size=1,
                 prefetch=2, hat_cfg=None, hat_state=None, epoch=0,
                 seed0=0, pool=None, attach_geom=True, geom_cache=None,
                 plan_device=False, static_margin=1.0):
        self.dataset = dataset
        self.indices = list(indices)
        self.chunk_rays = chunk_rays
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.hat_cfg = hat_cfg
        # plan_device: batch 0 still derives the static plan caps via the
        # host planner (hat_state), but EMITTED batches carry only rays —
        # the plan is built on device (ops/device_plan.py; the host->TPU
        # payload is the fresh-path bottleneck, tools/probes/fresh_gap.py)
        if plan_device:
            raise NotImplementedError(
                "plan_device=True (the hat plan built on the device, "
                "cfg.tpu.hat_plan_device) is not ported yet: ROADMAP.md "
                "section 1, item 11")
        self.plan_device = plan_device
        self.static_margin = float(static_margin)
        self.hat_state = hat_state if hat_state is not None else {}
        self.epoch = epoch
        self.seed0 = seed0
        self.pool = pool
        # attach_geom=False: batches carry meta["geom_keys"] instead of
        # stacked geometry; the numpy tables live in .geom_cache and the
        # consumer stacks them ON DEVICE (see parallel/geom.py)
        self.attach_geom = attach_geom
        self.geom_cache = (pool.geom_cache if pool is not None
                           else ({} if geom_cache is None else geom_cache))

    def __len__(self):
        return len(self.indices) // self.batch_size

    def _spec(self):
        if self.hat_cfg is None:
            return None
        st = self.hat_state
        return HatSpec(rows_caps=st.get("rows_caps"),
                       seg_caps=st.get("seg_caps"),
                       n_groups=st.get("n_groups"), **self.hat_cfg)

    def _derive_hat_static(self, probe_batches=8):
        """Size the hat planner's static shapes from the MAX over several
        probe batches, then emit batch 0 replanned at the final sizes.

        The statics directly scale device compute: every padded group
        costs a full group_size of decode-MLP work and every padded row a
        hat-matmul slot (the traced fresh step ran 49 ms/batch vs the
        26 ms tight-plan benchmark — mostly this padding). A multi-batch
        max is far more stable than one batch (typ. spread ±3% across
        frames/views), so margins shrink from x1.3-1.5 on one batch to
        x1.08/x1.15 on the max. Overflow on a later batch still raises
        with the raise-the-caps message (plan_hat_groups)."""
        n_probe = min(probe_batches, len(self))
        maxima = None
        raw = meta = None
        for bi in range(n_probe):
            np.random.seed(_batch_seed(self.epoch, bi, self.seed0))
            batch_idx = self.indices[bi * self.batch_size:
                                     (bi + 1) * self.batch_size]
            b_raw, b_meta = collate([self.dataset[j] for j in batch_idx],
                                    self.chunk_rays)
            if bi == 0:
                raw, meta = b_raw, b_meta
            _, hs = apply_hat_spec(
                dict(b_raw), self._spec(),
                _batch_seed(self.epoch, bi, self.seed0 + 1))
            cur = (hs["n_groups"],) + tuple(hs["rows_caps"]) + tuple(
                hs["seg_caps"])
            maxima = cur if maxima is None else tuple(
                max(a, b) for a, b in zip(maxima, cur))
        ng, rows, segs = maxima[0], maxima[1:5], maxima[5:]
        m = self.static_margin   # cfg.tpu.hat_static_margin escape hatch
        self.hat_state["rows_caps"] = tuple(
            -(-int(c * 1.15 * m) // 32) * 32 for c in rows)
        self.hat_state["seg_caps"] = tuple(
            -(-int(c * 1.25 * m) // 8) * 8 for c in segs)
        self.hat_state["n_groups"] = -(-int(ng * 1.08 * m) // 8) * 8
        if self.plan_device:
            return raw, meta
        device, _ = apply_hat_spec(
            raw, self._spec(), _batch_seed(self.epoch, 0, self.seed0 + 1))
        return device, meta

    def _strip_geom(self, device, meta):
        """attach_geom=False: move geometry out of the batch into the
        parent-side cache, leaving meta['geom_keys'] references."""
        if self.attach_geom:
            return device, meta
        keys = _geom_keys(meta)
        if keys is None:
            return device, meta
        geom = device.pop("geom")
        for i, k in enumerate(keys):
            if k not in self.geom_cache:
                self.geom_cache[k] = {n: v[i] for n, v in geom.items()}
        meta["geom_keys"] = keys
        return device, meta

    def _thread_iter(self, first_bi, spec):
        def produce(q):
            try:
                for bi in range(first_bi, len(self)):
                    q.put(self._strip_geom(*produce_batch(
                        self.dataset, self.indices, bi, self.batch_size,
                        self.chunk_rays, spec, self.epoch, self.seed0)))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)
            finally:
                q.put(None)

        q = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __iter__(self):
        first_bi = 0
        if self.hat_cfg is not None and "rows_caps" not in self.hat_state:
            device, meta = self._derive_hat_static()
            yield self._strip_geom(device, meta)
            first_bi = 1
        if first_bi >= len(self):
            return
        spec = None if self.plan_device else self._spec()
        if self.pool is not None:
            for device, meta in self.pool.run_epoch(
                    self.epoch, self.indices, self.batch_size,
                    self.chunk_rays, spec, self.seed0, first_bi, len(self),
                    attach_geom=self.attach_geom):
                yield device, meta
        else:
            yield from self._thread_iter(first_bi, spec)


def make_dataset(cfg, split):
    name = (cfg.train_dataset_module if split == "train"
            else cfg.test_dataset_module)
    data_cfg = cfg.train_dataset if split == "train" else cfg.test_dataset
    return build("dataset", name, cfg, data_cfg, split)


def make_data_loader(cfg, split, dataset=None, epoch=0, num_hosts=1,
                     host_id=0, hat_state=None, pool=None,
                     local_devices=1, attach_geom=True, geom_cache=None):
    """Factory mirroring the reference loader assembly
    (ref: lib/datasets/make_dataset.py:70-96).

    Multi-host: by default every host produces the identical batch sequence
    (rays are sharded over the global mesh) — guaranteed by per-batch
    RNG seeding, see _batch_seed. With cfg.train.data_sharding == "host",
    each host loads its own frame shard instead (the reference's
    DistributedSampler DDP weak scaling, ref lib/datasets/samplers.py:75-132):
    the global batch is num_hosts x batch_size, sharded on the batch axis.
    """
    if dataset is None:
        dataset = make_dataset(cfg, split)

    hat_cfg = None
    host_mode = (num_hosts > 1
                 and cfg.train.get("data_sharding", "") == "host")
    if split == "train":
        # host mode: shard frames FIRST, then cap to ep_iter per host —
        # the reference's DistributedSampler + IterationBasedBatchSampler
        # order (each rank runs the full ep_iter on its own shard)
        idx = samplers.epoch_indices(
            len(dataset), epoch, shuffle=cfg.train.shuffle,
            num_hosts=num_hosts if host_mode else 1,
            host_id=host_id if host_mode else 0,
            ep_iter=cfg.ep_iter * cfg.train.batch_size
            if cfg.ep_iter > 0 else -1)
        chunk = cfg.N_rand
        # host mode feeds each DEVICE its own frames (the reference's
        # one-frame-per-GPU DDP recipe): local batch = devices x batch_size
        bs = cfg.train.batch_size * (local_devices if host_mode else 1)
        if cfg.train.batch_sampler == "image_size":
            # multi-scale training (ref make_dataset.py:57 + ImageSize-
            # BatchSampler): per-batch bucketed (h, w) rides along as
            # (index, h, w) tuples; train device shapes stay static
            # (N_rand rays) regardless of image size
            meta = cfg.train.sampler_meta
            batches = samplers.image_size_batches(
                idx, bs, tuple(meta.min_hw), tuple(meta.max_hw),
                epoch=epoch, strategy=meta.strategy,
                n_buckets=int(meta.get("n_buckets", 4)), drop_last=True)
            idx = [(i, h, w) for chunk_idx, (h, w) in batches
                   for i in chunk_idx]
        # hat planning is a latent_xyzc-only interpolation path; other
        # families (nerf, tpose) sample z on device
        if (cfg.tpu.interp_mode == "hat" and hasattr(dataset, "geo")
                and cfg.network_module == "latent_xyzc"):
            geo = dataset.geo
            hat_cfg = dict(
                out_sh=geo.out_sh, site_caps=tuple(geo.site_caps),
                voxel_size=tuple(cfg.voxel_size), n_samples=cfg.N_samples,
                group_size=int(cfg.tpu.hat_group_size),
                tile=tuple(cfg.tpu.hat_tile), perturb=bool(cfg.perturb),
                quantize_z=bool(cfg.tpu.get("hat_quantize_z", True)))
    else:
        if cfg.test.sampler == "FrameSampler":
            idx = samplers.frame_sampler_indices(
                len(dataset), getattr(dataset, "num_cams", 1),
                cfg.test.frame_sampler_interval)
        else:
            idx = samplers.sequential_indices(len(dataset))
        chunk = cfg.tpu.chunk_rays
        bs = cfg.test.batch_size

    # per-host data sharding must also decorrelate the batch RNG streams;
    # cfg.seed folds into every batch seed (reproducibility-by-config)
    seed0 = (host_id * 900001 if host_mode else 0) + int(cfg.get("seed", 0))
    return DataLoader(dataset, idx, chunk, batch_size=bs, hat_cfg=hat_cfg,
                      hat_state=hat_state, epoch=epoch, seed0=seed0,
                      pool=pool, attach_geom=attach_geom,
                      geom_cache=geom_cache,
                      plan_device=(hat_cfg is not None
                                   and len(hat_cfg["tile"]) == 2
                                   and bool(cfg.tpu.get("hat_plan_device",
                                                        False))),
                      static_margin=float(
                          cfg.tpu.get("hat_static_margin", 1.0)))
