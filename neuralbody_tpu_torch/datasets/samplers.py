"""Index samplers.
(Counterpart of neuralbody_tpu/datasets/samplers.py: an own copy, numpy.)

Equivalents of the reference samplers (ref: lib/datasets/samplers.py):
FrameSampler (every k-th frame at test), iteration-based epoch capping, and
host sharding with epoch-seeded shuffle replacing torch DistributedSampler
(rank shard + padding so all hosts take equal steps, samplers.py:75-132).
"""
from __future__ import annotations

import numpy as np


def sequential_indices(n):
    return list(range(n))


def shuffled_indices(n, epoch, seed=0):
    rng = np.random.RandomState(seed + epoch)
    idx = np.arange(n)
    rng.shuffle(idx)
    return idx.tolist()


def frame_sampler_indices(n_items, num_cams, interval=30):
    """All views of every `interval`-th frame (ref: samplers.py:134-148)."""
    ni = n_items // num_cams
    inds = np.arange(ni * num_cams).reshape(ni, num_cams)
    return inds[::interval].ravel().tolist()


def host_shard(indices, num_hosts, host_id, pad=True):
    """Shard an index list across hosts, padding so lengths match
    (ref DistributedSampler pads by wrapping, samplers.py:117-118)."""
    if num_hosts <= 1:
        return list(indices)
    indices = list(indices)
    per_host = -(-len(indices) // num_hosts)
    if pad:
        total = per_host * num_hosts
        indices = (indices * (total // max(len(indices), 1) + 1))[:total]
    return indices[host_id::num_hosts]


def image_size_batches(indices, batch_size, min_hw, max_hw, epoch=0,
                       seed=0, strategy="range", divisor=32,
                       n_buckets=4, drop_last=False):
    """Multi-scale batch sampler (ref ImageSizeBatchSampler,
    samplers.py:10-47): yields (batch_indices, (H, W)) with a per-batch
    random image size rounded up to `divisor`.

    TPU adaptation: the reference draws any size in [min, max] (a new CUDA
    shape is free); arbitrary sizes would force one XLA compile per batch,
    so sizes are drawn from `n_buckets` evenly spaced divisor-aligned
    buckets per axis — at most n_buckets^2 compiles. strategy='origin'
    yields (-1, -1), meaning "keep the native size" (ref :23-24).
    """
    rng = np.random.RandomState(seed + epoch)
    hs = np.unique(np.linspace(min_hw[0], max_hw[0], n_buckets).astype(int)
                   // divisor * divisor + divisor)
    ws = np.unique(np.linspace(min_hw[1], max_hw[1], n_buckets).astype(int)
                   // divisor * divisor + divisor)

    def draw():
        if strategy == "origin":
            return (-1, -1)
        return int(rng.choice(hs)), int(rng.choice(ws))

    indices = list(indices)
    out = []
    for i in range(0, len(indices), batch_size):
        chunk = indices[i:i + batch_size]
        if len(chunk) < batch_size and drop_last:
            break
        out.append((chunk, draw()))
    return out


def epoch_indices(n_items, epoch, shuffle=True, num_hosts=1, host_id=0,
                  ep_iter=-1, seed=0):
    """Final per-host index sequence for one epoch."""
    idx = shuffled_indices(n_items, epoch, seed) if shuffle \
        else sequential_indices(n_items)
    idx = host_shard(idx, num_hosts, host_id)
    if ep_iter > 0:
        # cap/cycle to ep_iter batches per epoch (ref IterationBasedBatchSampler)
        reps = -(-ep_iter // max(len(idx), 1))
        idx = (idx * reps)[:ep_iter]
    return idx
