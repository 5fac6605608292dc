"""Checkpoints with the reference's latest/epoch/prune semantics, in the JAX
package's file layout (counterpart of neuralbody_tpu/train/checkpoint.py).

One msgpack file bundles the params, the BN stats, the optimizer state, the
recorder's counters and the epoch. `latest.ckpt` is written every
save_latest_ep epochs and `{epoch}.ckpt` every save_ep; the numbered ones
are pruned to `keep` (ref: lib/utils/net_utils.py:288-348). A file goes to
a `.tmp` name first and is renamed.

The bytes are flax.serialization's (msgpack_serialize of to_state_dict),
so either package resumes from the other's file: an array is msgpack ext
type 1 holding the msgpack array (shape, dtype name, raw C-order bytes), a
list or tuple is a map keyed "0", "1", ..., and the optimizer state is the
state dict of the JAX package's optax chain for the same config: value
clip, coupled weight decay (adam and radam with weight_decay > 0), then
the optimizer and its learning rate, e.g. for Adam without weight decay
{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {"count"}}} and for SGD
{"0": {}, "1": {"0": {"trace"}, "1": {"count"}}}, each count a 0-d int32
array. flax imports JAX, so this module carries its own encoder and
decoder of the msgpack subset those files use (maps with str keys, str,
int, float, bool, nil, bin, array, ext).

Loading copies into the existing parameter, BN and optimizer tensors, which
keep their device and their addresses: a CUDA graph that captured them
(train/graphs.StepGraph) replays on after a resume without a new capture.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .optimizer import SGD

ARRAY_EXT = 1    # flax's ext code of an ndarray (_MsgpackExtType.ndarray)


# ---------------------------------------------------------------------------
# msgpack, the subset flax.serialization writes
# ---------------------------------------------------------------------------

def _head(out, n, small, fix_max, codes):
    """Append the header of a str / bin / array / map / ext of length n:
    a fix byte (small | n) when n <= fix_max, else the 8-, 16- or 32-bit
    length form (codes, None where the format has no such form)."""
    if small is not None and n <= fix_max:
        out.append(small | n)
        return
    for code, width, fmt in zip(codes, (0xff, 0xffff, 0xffffffff),
                                ("B", ">H", ">I")):
        if code is not None and n <= width:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack(x, out):
    if x is None:
        out.append(0xc0)
    elif isinstance(x, bool):
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, int):
        if 0 <= x < 0x80:
            out.append(x)
        elif -32 <= x < 0:
            out += struct.pack("b", x)
        elif x >= 0:
            out.append(0xcf)
            out += struct.pack(">Q", x)
        else:
            out.append(0xd3)
            out += struct.pack(">q", x)
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode()
        _head(out, len(b), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _head(out, len(x), None, 0, (0xc4, 0xc5, 0xc6))
        out += x
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, (None, 0xdc, 0xdd))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"a checkpoint's keys are str, not {k!r}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        arr = np.asarray(x)   # tobytes("C") copies a strided one
        data = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], data)
        n = len(data)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _head(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out += struct.pack("b", ARRAY_EXT)
        out += data
    else:
        raise TypeError(f"cannot write {type(x).__name__} to a checkpoint")


def packb(tree):
    """msgpack bytes of a tree of dicts (str keys), lists, str, bytes, int,
    float, bool, None and numpy arrays (as flax's ext type 1)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.data, self.at = memoryview(data), 0

    def take(self, n):
        if self.at + n > len(self.data):
            raise ValueError("the checkpoint ends inside a value")
        b = self.data[self.at:self.at + n]
        self.at += n
        return b

    def num(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.num("B")
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.value() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: "B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: "b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if c in ints:
            return self.num(ints[c])
        lens = {0xd9: "B", 0xda: ">H", 0xdb: ">I",     # str
                0xc4: "B", 0xc5: ">H", 0xc6: ">I",     # bin
                0xdc: ">H", 0xdd: ">I",                # array
                0xde: ">H", 0xdf: ">I",                # map
                0xc7: "B", 0xc8: ">H", 0xc9: ">I"}     # ext
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        if c not in lens:
            raise ValueError(f"msgpack type byte 0x{c:02x} is not in a "
                             "checkpoint's subset")
        n = self.num(lens[c])
        if c in (0xd9, 0xda, 0xdb):
            return str(self.take(n), "utf-8")
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(n))
        if c in (0xdc, 0xdd):
            return [self.value() for _ in range(n)]
        if c in (0xde, 0xdf):
            return self.map(n)
        return self.ext(n)

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n):
        code = self.num("b")
        data = bytes(self.take(n))
        if code != ARRAY_EXT:
            raise ValueError(f"msgpack ext type {code} is not an array")
        inner = _Reader(data)
        shape, dtype, raw = inner.value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def unpackb(data):
    """The tree that packb (or flax.serialization.msgpack_serialize) wrote:
    arrays come back as read-only numpy arrays."""
    r = _Reader(data)
    out = r.value()
    if r.at != len(r.data):
        raise ValueError("the checkpoint holds bytes after its value")
    return out


# ---------------------------------------------------------------------------
# the port's trees <-> the JAX package's state dicts
# ---------------------------------------------------------------------------

def state_dict(tree):
    """A tree of dicts, lists and tensors as flax.serialization's
    to_state_dict gives the JAX package's pytree: lists become maps keyed
    "0", "1", ..., tensors numpy arrays (copied to the host)."""
    if isinstance(tree, dict):
        return {str(k): state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous().numpy()
    return tree


def _load(dst, src, path):
    """Copy state dict `src` into the tensors of tree `dst` in place."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(map(str, dst)) != set(src):
            raise ValueError(f"{path or 'the tree'}: the checkpoint's keys "
                             f"{sorted(src) if isinstance(src, dict) else src}"
                             f" are not the tree's {sorted(dst)}")
        for k, v in dst.items():
            _load(v, src[str(k)], f"{path}/{k}")
    elif isinstance(dst, (list, tuple)):
        want = [str(i) for i in range(len(dst))]
        if not isinstance(src, dict) or sorted(src) != sorted(want):
            raise ValueError(f"{path}: the checkpoint holds no list of "
                             f"{len(dst)}")
        for i, v in enumerate(dst):
            _load(v, src[str(i)], f"{path}/{i}")
    else:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} in the "
                             f"checkpoint, {tuple(dst.shape)} in the tree")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.array(src)))


def load_state_dict(tree, state):
    """Copy a state dict (state_dict's layout) into the tensors of `tree`,
    which keep their device and addresses."""
    _load(tree, state, "")


def _count(n):
    return np.asarray(n, np.int32)


def _chain(opt):
    """The state dicts of the JAX chain's elements before the optimizer:
    the value clip's, and the weight decay's where the chain has one (both
    hold no state)."""
    head = [{}]                      # optax.clip
    if opt.weight_decay > 0:
        head.append({})              # optax.add_decayed_weights
    return head


def opt_state_dict(opt):
    """The optimizer's state as flax's to_state_dict of the JAX package's
    optax chain for the same config."""
    st = opt.state_dict()
    if isinstance(opt, SGD):
        inner = {"trace": state_dict(st["trace"])}
    else:
        inner = {"count": _count(st["count"]), "mu": state_dict(st["mu"]),
                 "nu": state_dict(st["nu"])}
    elems = _chain(opt) + [{"0": inner, "1": {"count": _count(st["count"])}}]
    return {str(i): e for i, e in enumerate(elems)}


def load_opt_state_dict(opt, state):
    """Copy an optax chain's state dict (opt_state_dict's layout) into the
    optimizer's own state tensors."""
    head = _chain(opt)
    if sorted(state) != [str(i) for i in range(len(head) + 1)]:
        raise ValueError(f"the checkpoint's optimizer chain has elements "
                         f"{sorted(state)}, this optimizer's {len(head) + 1}")
    tx = state[str(len(head))]
    count = int(np.asarray(tx["1"]["count"]))
    if isinstance(opt, SGD):
        load_state_dict(opt.trace, tx["0"]["trace"])
    else:
        load_state_dict(opt.mu, tx["0"]["mu"])
        load_state_dict(opt.nu, tx["0"]["nu"])
        count = int(np.asarray(tx["0"]["count"]))
    opt.count = count


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def save_checkpoint(model_dir, epoch, params, bn_stats, opt,
                    recorder_state=None, latest=False, keep=20):
    """Write `latest.ckpt` (latest=True) or `{epoch}.ckpt` under model_dir
    and prune the numbered ones to the newest `keep`."""
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "params": state_dict(params),
        "bn_stats": state_dict(bn_stats),
        "opt_state": opt_state_dict(opt),
        "recorder": recorder_state or {},
        "epoch": int(epoch),
    }
    name = "latest.ckpt" if latest else f"{epoch}.ckpt"
    tmp = os.path.join(model_dir, name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, os.path.join(model_dir, name))

    pths = sorted(
        int(p.split(".")[0]) for p in os.listdir(model_dir)
        if p.endswith(".ckpt") and p != "latest.ckpt"
    )
    while len(pths) > keep:
        os.remove(os.path.join(model_dir, f"{pths.pop(0)}.ckpt"))


def _pick(model_dir, epoch):
    """The file to load: `{epoch}.ckpt`, or for epoch -1 `latest.ckpt`, else
    the newest numbered one; None when there is none."""
    if not os.path.isdir(model_dir):
        return None
    names = os.listdir(model_dir)
    pths = sorted(int(p.split(".")[0]) for p in names
                  if p.endswith(".ckpt") and p != "latest.ckpt")
    if epoch == -1:
        if "latest.ckpt" in names:
            return os.path.join(model_dir, "latest.ckpt")
        if pths:
            return os.path.join(model_dir, f"{pths[-1]}.ckpt")
        return None
    path = os.path.join(model_dir, f"{epoch}.ckpt")
    return path if os.path.exists(path) else None


def read_checkpoint(path):
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_checkpoint(model_dir, params, bn_stats, opt, epoch=-1,
                    resume=True):
    """Full resume, in place: the checkpoint's params, BN stats and
    optimizer state are copied into `params`, `bn_stats` and `opt`.
    Returns (the recorder's state, the epoch to begin at: the saved one +
    1), or ({}, 0) with nothing changed when there is nothing to restore
    (or resume is False)."""
    path = _pick(model_dir, epoch) if resume else None
    if path is None:
        return {}, 0
    raw = read_checkpoint(path)
    print(f"load checkpoint: {path}")
    load_state_dict(params, raw["params"])
    load_state_dict(bn_stats, raw["bn_stats"])
    load_opt_state_dict(opt, raw["opt_state"])
    return raw.get("recorder", {}), int(raw["epoch"]) + 1


def load_params(model_dir, params, bn_stats, epoch=-1):
    """Weights-only load for evaluation, in place (ref:
    net_utils.py:351-380). Returns the saved epoch + 1, or 0 when there is
    no checkpoint."""
    path = _pick(model_dir, epoch)
    if path is None:
        print("pretrained model does not exist")
        return 0
    raw = read_checkpoint(path)
    print(f"load network: {path}")
    load_state_dict(params, raw["params"])
    load_state_dict(bn_stats, raw["bn_stats"])
    return int(raw["epoch"]) + 1
