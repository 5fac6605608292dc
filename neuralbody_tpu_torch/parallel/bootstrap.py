"""Process-group bootstrap (counterpart of
neuralbody_tpu/parallel/bootstrap.py).

One process drives one card; the processes form a torch.distributed group
before anything touches a card. The launch modes read the JAX package's
variables:

  * explicit: NB_COORDINATOR=host:port NB_NUM_PROCESSES=N NB_PROCESS_ID=i
    -> init_process_group(init_method="tcp://host:port", rank=i,
    world_size=N);
  * NB_DIST_AUTO=1: init_method="env://", which reads torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT.

Without either, a run is one process and nothing is initialized. The
backend is NCCL on the card and gloo on the CPU (NB_DIST_BACKEND picks
another: gloo on CUDA tensors is how two ranks share one card, which NCCL
refuses). Rank r drives cuda:LOCAL_RANK
(default r modulo the cards visible). The group has a finite timeout
(NB_DIST_TIMEOUT seconds, default DEFAULT_TIMEOUT_S): a group that does
not form in it raises, and so does a gloo collective that waits longer; an
NCCL collective that times out aborts the process (torch's watchdog).

rank(), world() and is_primary() are jax.process_index / process_count /
process_index() == 0: 0, 1 and True when no group was formed.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def _timeout():
    return datetime.timedelta(seconds=float(
        os.environ.get("NB_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def default_backend(device=None) -> str:
    """NCCL when the run is on the card, gloo on the CPU."""
    forced = os.environ.get("NB_DIST_BACKEND")
    if forced:
        return forced
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize_distributed(device=None) -> bool:
    """Form the process group when the environment asks for one.

    Returns True when this process is part of a group (formed now or
    before), False for a single-process run. Safe to call twice. device:
    the run's device ("cpu" picks gloo). A group that does not form within
    the timeout raises."""
    if dist.is_available() and dist.is_initialized():
        return True
    coord = os.environ.get("NB_COORDINATOR")
    auto = os.environ.get("NB_DIST_AUTO", "") in ("1", "true")
    if coord is None and not auto:
        return False
    backend = default_backend(device)
    kw = dict(backend=backend, timeout=_timeout())
    if coord is not None:
        kw.update(init_method=f"tcp://{coord}",
                  world_size=int(os.environ["NB_NUM_PROCESSES"]),
                  rank=int(os.environ["NB_PROCESS_ID"]))
    else:
        kw.update(init_method="env://")
    if backend == "nccl":
        # NCCL binds a communicator to the current device: set it first
        torch.cuda.set_device(local_device(kw.get("rank")))
    dist.init_process_group(**kw)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def local_device(r=None) -> torch.device:
    """The card rank r drives: cuda:LOCAL_RANK, or r modulo the visible
    cards when LOCAL_RANK is not set (r defaults to this rank, or to
    RANK / NB_PROCESS_ID before the group forms)."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if r is None:
        r = (rank() if dist.is_available() and dist.is_initialized()
             else int(os.environ.get("RANK",
                                     os.environ.get("NB_PROCESS_ID", 0))))
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible to this rank")
    return torch.device("cuda", r % n)


def run_device(device=None) -> torch.device | None:
    """The device an entry point runs on: `device` when the caller gave
    one, else this rank's card in a group, else None (the default card)."""
    if device is not None:
        return torch.device(device)
    if world() > 1:
        return local_device()
    return None


def shutdown():
    """Destroy the process group if one was formed (safe to call when
    none was)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
