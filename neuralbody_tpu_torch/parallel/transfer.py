"""Host -> device transfer of dispatch groups, off the caller's thread
(counterpart of neuralbody_tpu/parallel/transfer.py).

DevicePrefetcher keeps the JAX class's contract: prep_fn(item) runs on one
background thread, results come out in order, `depth` bounds the items
waiting, and a prep_fn exception is raised again on the caller's thread at
its next ready() or drain().

StagingRing is what prep_fn does with a group on the card. It holds R
staging sets, each a pinned host set and a device set of the group's stacked
leaves, allocated once (when the first group shows their shapes) and reused
in turn. Staging group n into set k = n mod R:
  * stack the G batches straight into pinned set k (np.stack(out=), with
    utils/platform.to_device's conversions: uint16 -> int32, float64 ->
    float32);
  * on a side stream, copy pinned set k into device set k (non_blocking);
  * record ready[k] on the side stream.
Four hazards, each held by an event:
  (a) pinned set k is rewritten only once its last host -> device copy has
      run: copied[k].synchronize() on the host before the stack;
  (b) device set k is refilled only once the dispatch that last used it has
      copied it into its own buffers: the side stream waits on consumed[k],
      which the consumer records on its stream right after that copy-in
      (Staged.consumed, called by train/graphs.StepGraph after _copy_in);
      and the host does not stage into set k before the consumer has
      recorded it (the slot is released then), so the wait is on the right
      record;
  (c) the consumer's stream waits on ready[k] before its copy-in
      (Staged.wait);
  (d) whatever the caller's `before` does on the side stream (the geometry
      bank's installs of new frames) is enqueued before ready[k], so (c)
      covers it too.
Every staging set is allocated once, from the default stream's pool (the
consumer's stream; the side stream then waits for the default stream's work
so far, which may still use the memory the pool handed back), and no
allocation is made per dispatch on the side stream, so no tensor crosses
streams in the caching allocator's sense and no record_stream is needed.
On the CPU the same ring runs without the streams and events: a set is
one CPU tensor set that the steps read directly.
"""
from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from ..utils.platform import resolve_device

_STAGED_DTYPE = {np.dtype(np.uint16): np.int32,
                 np.dtype(np.float64): np.float32}


class DevicePrefetcher:
    """Run `prep_fn(item)` on one background thread, preserving order.

    submit() enqueues work (blocks when `depth` items wait); ready() yields
    the finished results without blocking; drain() marks the end of the
    input and yields the rest in order. A prep_fn exception is raised again
    at the next ready() or drain() on the caller's thread.
    """

    def __init__(self, prep_fn, depth: int = 2):
        self._prep = prep_fn
        self._in: queue.Queue = queue.Queue(maxsize=depth)
        self._out: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                self._out.put((None, None))
                return
            try:
                self._out.put((self._prep(item), None))
            except BaseException as e:  # noqa: BLE001 — raised in the caller
                self._out.put((None, e))
                return

    def submit(self, item):
        self._in.put(item)

    def ready(self):
        """Yield finished results without blocking."""
        while True:
            try:
                res, err = self._out.get_nowait()
            except queue.Empty:
                return
            if err is not None:
                raise err
            if res is None:
                return
            yield res

    def drain(self):
        """Signal the end of the input and yield the remaining results in
        order."""
        self._in.put(None)
        while True:
            res, err = self._out.get()
            if err is not None:
                raise err
            if res is None:
                return
            yield res

    def close(self):
        """Best-effort shutdown (error paths; drain() is the normal end)."""
        try:
            self._in.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10)


class Staged(dict):
    """One staging set's batch tree (tensors on the ring's device) as the
    consumer receives it. wait() makes the consumer's stream wait for its
    copy (hazard c); consumed() marks, after the consumer's copy-in, that
    the set may be refilled (hazard b)."""

    def __init__(self, tree, ring, slot):
        super().__init__(tree)
        self._ring, self._slot = ring, slot

    def wait(self):
        if self._ring.stream is not None:
            torch.cuda.current_stream(self._ring.device).wait_event(
                self._ring.ready[self._slot])

    def consumed(self):
        if self._ring.stream is not None:
            self._ring.consumed[self._slot].record(
                torch.cuda.current_stream(self._ring.device))
        self._ring._release(self._slot)


class StagingRing:
    """`size` staging sets for dispatch groups, used in turn (see the
    module's docstring). stage(group) runs on the prefetcher's thread;
    `copies` counts the sets copied, `set_bytes` is one set's size and
    `leaves` its leaf count."""

    def __init__(self, device=None, size=3):
        if size < 1:
            raise ValueError(f"a staging ring needs a set, not {size}")
        self.device = resolve_device(device)
        self.size = size
        self.copies = 0
        self.set_bytes = 0
        self.leaves = 0
        self._layout = None     # ((path, shape, dtype), ...) of a set
        self._host = self._dev = None
        self._next = 0
        self._free = [True] * size
        self._closed = False
        self._cond = threading.Condition()
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.copied, self.ready, self.consumed = (
                [torch.cuda.Event() for _ in range(size)] for _ in range(3))

    def close(self):
        """Wake a stage() that waits for a set; it raises."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self):
        """After close() and the end of the thread that staged: every set
        free again (a set staged and never consumed is given up, once its
        copy has run)."""
        if self.stream is not None:
            self.stream.synchronize()
        with self._cond:
            self._closed = False
            self._free = [True] * self.size

    def _release(self, slot):
        with self._cond:
            self._free[slot] = True
            self._cond.notify_all()

    def _wait(self, slots):
        """Block until every set of `slots` is free (released)."""
        with self._cond:
            while not all(self._free[k] for k in slots):
                if self._closed:
                    raise RuntimeError("the staging ring was closed")
                self._cond.wait()

    def _acquire(self, slot):
        self._wait([slot])
        with self._cond:
            self._free[slot] = False

    def _allocate(self, slot, layout):
        """Every set anew for a new layout, once the old sets are free and
        their copies and copy-ins have run."""
        self._wait([k for k in range(self.size) if k != slot])
        if self.stream is not None:
            for e in self.copied + self.consumed:
                e.synchronize()
        self._layout = layout
        self.leaves = len(layout)
        self.set_bytes = sum(int(np.prod(s)) * d.itemsize
                             for _, s, d in layout)

        def make(pin, device):
            return [{path: torch.empty(
                shape, dtype=torch.from_numpy(np.empty(0, d)).dtype,
                device=device, pin_memory=pin) for path, shape, d in layout}
                for _ in range(self.size)]
        if self.stream is None:
            self._host = self._dev = make(False, "cpu")
            return
        self._host = make(True, "cpu")
        default = torch.cuda.default_stream(self.device)
        with torch.cuda.stream(default):
            self._dev = make(False, self.device)
        # the pool may hand back memory that work already on the default
        # stream still uses: the side stream writes after that work
        self.stream.wait_stream(default)

    def stage(self, group, before=None):
        """Stack `group` (a list of G batch trees of numpy arrays, the same
        leaves and shapes in each) into the next staging set and copy it to
        the device. before(), if given, runs first on the side stream and
        returns more leaves, already stacked ({name: array [G, ...]}).
        Returns the set as a Staged tree of nested dicts."""
        slot = self._next
        self._next = (slot + 1) % self.size
        self._acquire(slot)
        try:
            return self._stage(slot, group, before)
        except BaseException:
            self._release(slot)
            raise

    def _stage(self, slot, group, before):
        side = (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())
        with side:
            extra = before() if before is not None else {}
        leaves = _flatten(group[0])
        layout = tuple(
            (path, (len(group),) + v.shape,
             np.dtype(_STAGED_DTYPE.get(v.dtype, v.dtype)))
            for path, v in leaves) + tuple(
            (name, a.shape, a.dtype) for name, a in extra.items())
        if layout != self._layout:
            self._allocate(slot, layout)
        if self.stream is not None:
            self.copied[slot].synchronize()                         # (a)
        host, dev = self._host[slot], self._dev[slot]
        for path, _ in leaves:
            np.stack([_get(b, path) for b in group], out=host[path].numpy())
        for name, a in extra.items():
            host[name].numpy()[...] = a
        if self.stream is not None:
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(self.consumed[slot])         # (b)
                for path in dev:
                    dev[path].copy_(host[path], non_blocking=True)
                self.copied[slot].record(self.stream)
                self.ready[slot].record(self.stream)                # (c, d)
        self.copies += 1
        return Staged(_unflatten(dev), self, slot)


def _flatten(tree, prefix=""):
    """(path, array) of a nested dict of numpy arrays, keys sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _flatten(v, path + "/")
        else:
            out.append((path, np.asarray(v)))
    return out


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree
