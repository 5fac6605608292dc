"""Device-resident frame geometry (counterpart of
neuralbody_tpu/parallel/geom.py).

A frame's geometry (the sparse-conv rulebook and index volumes: 62 int32
tables, ~16 MB a frame at the reference working point) is static per frame.
With DataLoader(attach_geom=False) the batches carry meta["geom_keys"]
instead and the numpy tables stay in the loader's geom_cache. GeomBank
copies each frame to the device once, as one row of int32 words of one
preallocated [capacity, W] tensor, and a step selects its frames by row
inside the dispatch (take): one index_select of whole rows, where the JAX
bank takes 62 leaves by index.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.platform import resolve_device

ALIGN = 32   # words: a leaf starts on a 128-byte boundary of its row


def bank_capacity(dataset):
    """Rows for a dataset's frames, the JAX Trainer's rule
    (neuralbody_tpu/train/trainer.py:135-139): dataset.num_geoms, else two
    more than its samples over its cameras."""
    return getattr(dataset, "num_geoms", None) or (
        2 + -(-len(dataset) // max(getattr(dataset, "num_cams", 1), 1)))


class GeomBank:
    """Fixed-capacity device bank of per-frame geometry tables.

    host_cache: {frame key: {leaf name: int32 array}} (the loader's
    geom_cache; frames are read from it when first asked for); capacity:
    the number of distinct frames it holds (bank_capacity); device: the card
    unless "cpu" is given. The layout ((name, word offset, shape) per leaf)
    and the storage, int32 [capacity, width], are made from the first frame
    installed and never change: a new frame fills a free row and the
    storage's address stays. `installs` counts the frames copied in.
    """

    def __init__(self, host_cache, capacity, device=None):
        self.host = host_cache
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.layout = None
        self.width = 0
        self.storage = None
        self.installs = 0
        self._rows = {}
        self._pinned = None     # the card's install buffer, and the event
        self._copied = None     # that its last copy has run

    @property
    def nbytes(self):
        return 0 if self.storage is None else (self.storage.numel()
                                               * self.storage.element_size())

    def _allocate(self, proto):
        layout, off = [], 0
        for name in sorted(proto):
            shape = tuple(np.shape(proto[name]))
            layout.append((name, off, shape))
            off += -(-math.prod(shape) // ALIGN) * ALIGN
        self.layout, self.width = tuple(layout), max(off, ALIGN)
        if self.device.type != "cuda":
            self.storage = torch.empty((self.capacity, self.width),
                                       dtype=torch.int32)
            return
        # allocated from the default stream's pool, where the dispatches
        # that read it run, whichever stream installs the rows; the
        # installing stream waits for the default stream's work so far,
        # which may still use the memory the pool handed back
        default = torch.cuda.default_stream(self.device)
        with torch.cuda.stream(default):
            self.storage = torch.empty((self.capacity, self.width),
                                       dtype=torch.int32, device=self.device)
        torch.cuda.current_stream(self.device).wait_stream(default)
        self._pinned = torch.empty(self.width, dtype=torch.int32,
                                   pin_memory=True)
        self._copied = torch.cuda.Event()

    def _flat(self, key):
        """The frame's tables as one row, checked against the layout."""
        frame = self.host[key]
        if sorted(frame) != [n for n, _, _ in self.layout]:
            raise ValueError(f"frame {key}'s geometry has leaves "
                             f"{sorted(frame)}, the bank's layout "
                             f"{[n for n, _, _ in self.layout]}")
        if self._pinned is not None:
            self._copied.synchronize()    # the last install has left it
            out = self._pinned
        else:
            out = torch.empty(self.width, dtype=torch.int32)
        row = out.numpy()
        for name, off, shape in self.layout:
            v = np.asarray(frame[name])
            if v.dtype != np.int32 or v.shape != shape:
                raise ValueError(
                    f"frame {key}'s geometry leaf {name!r} is {v.dtype} "
                    f"{v.shape}; the bank holds int32 {shape}")
            row[off:off + v.size] = v.ravel()
        return out

    def _install(self, key):
        if self.storage is None:
            self._allocate(self.host[key])
        if len(self._rows) >= self.capacity:
            raise ValueError(f"GeomBank overflow: >{self.capacity} distinct "
                             "frames")
        row = len(self._rows)
        # on the card a copy on the caller's stream (the prefetcher's side
        # stream), ordered before the dispatch that reads the row
        self.storage[row].copy_(self._flat(key),
                                non_blocking=self._pinned is not None)
        if self._copied is not None:
            self._copied.record()
        self._rows[key] = row
        self.installs += 1

    def rows(self, group_keys):
        """group_keys: [G][B] frame keys -> their rows, int64 [G, B] (numpy),
        installing the frames not seen before."""
        for k in dict.fromkeys(k for keys in group_keys for k in keys):
            if k not in self._rows:
                self._install(k)
        return np.array([[self._rows[k] for k in keys]
                         for keys in group_keys], np.int64)


def take(bank, rows):
    """The geometry of a batch's frames: {leaf: [B, ...]} from the bank's
    rows (an int64 tensor [B] on its device). One index_select of whole rows;
    each leaf is a view of its column range of the selection."""
    sel = bank.storage.index_select(0, rows)
    B = sel.shape[0]
    return {name: sel[:, off:off + math.prod(shape)].view((B,) + shape)
            for name, off, shape in bank.layout}
