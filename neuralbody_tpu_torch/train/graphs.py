"""CUDA graphs of latent_xyzc's training dispatch and hat render.

The JAX package runs G training steps as one XLA program
(neuralbody_tpu/train/step.py:train_step_scan) because dispatching a step
from the host costs more than the step's device work. The port's eager step
launches some 2,400 kernels one at a time from Python, and the card idles
between them. A CUDA graph records those launches once and replays them
with one host call: StepGraph holds G consecutive train_steps (the
counterpart of one scan dispatch), RenderGraph one eval_step render of a
hat batch.

A graph reads and writes fixed addresses. Each graph owns buffers for the
batch, for the optimizer's per-step scalars (train/optimizer.Adam.scalars)
and for the BatchNorm running stats, and a call copies into them what is not
there already. The parameters and the Adam moments are updated in place
where they live, so the graph works on those tensors themselves and
captures again when they are other tensors, as it does when the shapes, the
dtypes or the settings change.

Capture follows PyTorch's recipe for a whole network: warm-up on a side
stream (it loads the kernels' libraries and builds the cached constants,
autograd's and cuBLAS's state; the training state it changes is restored),
then one capture with torch.cuda.graph into a private memory pool. Both
graphs run on the card only: on a CPU device they raise, as does a capture
or a replay that fails. Nothing falls back to the eager loop.
"""
from __future__ import annotations

import torch

from ..parallel.geom import take
from ..parallel.transfer import Staged
from ..renderer.dispatch import get_render_fn
from ..renderer.renderer import RenderSettings
from ..utils.platform import resolve_device, to_device
from ..utils.profiling import span
from .optimizer import Adam, tree_leaves, tree_map
from .step import loss_and_grads, merge_bn_stats, scan_length, scan_slice

WARMUP = 1   # eager runs of a graph's body on a side stream before capture

def _card(device):
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs run on a CUDA device, not {device}; "
                         "on the CPU use train_step_scan(device='cpu') or "
                         "eval_step")
    return device


def _hat_batch(batch, settings, what, device_plan=False):
    """Refuse a batch off latent_xyzc's hat path: one with a host plan
    (ops/hat_interp.prepare_hat_batch), or, where device_plan, a rays-only
    one under settings.hat_plan (the plan built in the graph)."""
    if isinstance(settings, RenderSettings) and (
            "hat_sort" in batch
            or (device_plan and settings.hat_plan is not None)):
        return
    raise ValueError(f"{what} takes latent_xyzc's hat batches "
                     "(ops/hat_interp.prepare_hat_batch"
                     + (", or rays only under RenderSettings.hat_plan"
                        if device_plan else "") + ") and their "
                     "RenderSettings")


def _signature(tree, path=""):
    """(path, shape, dtype) of every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return tuple(x for k in sorted(tree)
                     for x in _signature(tree[k], f"{path}/{k}"))
    if isinstance(tree, (list, tuple)):
        return tuple(x for i, v in enumerate(tree)
                     for x in _signature(v, f"{path}/{i}"))
    return ((path, tuple(tree.shape), tree.dtype),)


def _addresses(tensors):
    return tuple(t.data_ptr() for t in tensors)


def _owned(tree):
    """Contiguous copies of a tree's tensors: the buffers a graph reads."""
    return tree_map(lambda t: t.detach().contiguous().clone(), tree)


def _copy_in(dst, src):
    """Copy every src tensor that is not its dst tensor into it."""
    pairs = [(d, s) for d, s in zip(dst, src) if d.data_ptr() != s.data_ptr()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _check_on(device, tensors, what):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what} must be on {device}, found one on "
                             f"{t.device}")


def _capture(body, restore, generator=None):
    """Run body() WARMUP times on a side stream, call restore(), and
    capture one call of body() into a new graph with a private memory pool.
    Returns (graph, that call's outputs). The span graph.capture holds it
    all."""
    with span("graph.capture"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                body()
        torch.cuda.current_stream().wait_stream(side)
        restore()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a "
                    "torch.Generator with a CUDA graph; the raw-noise term "
                    "(raw_noise_std > 0) and the perturbed depths of a plan "
                    "built on the device cannot be captured")
            graph.register_generator_state(generator)
        # thread_local: the prefetcher's thread (parallel/transfer.py) may
        # stage the next group (event waits, copies on its own stream)
        # while this thread captures; CUDA refuses such calls from other
        # threads in the default "global" mode
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = body()
        return graph, out


class StepGraph:
    """G consecutive train_steps of latent_xyzc as one CUDA graph.

    Call it as train_step_scan is called, with `batches` a hat batch (on
    the card or in numpy) whose every leaf has a leading axis of G steps:
    precompute_hat_device's batches, un-expanded ones with
    settings.hat_rows_caps (the segment expansion is device work with
    static caps), or rays-only ones under settings.hat_plan (the plan is
    built inside the graph, ops/device_plan.py). With a `bank` (parallel/geom.GeomBank) the batches carry
    geom_rows [G, B] in place of geom, and step i takes its geometry from
    the bank inside the graph (take). It captures at the first call and
    whenever the shapes, dtypes, settings, generator, the optimizer's
    constants, the parameters' or moments' tensors or the bank's storage or
    layout change (`captures` counts them; a frame installed into a free row
    of the bank changes none of them), copies in the batch and bn_stats
    where they are not its own buffers, writes the G steps' rows of
    opt.scalars() into its scalar buffer, replays, and advances opt.count
    by G. A batch staged by parallel/transfer.StagingRing (a Staged tree,
    already on the card) is copied in device to device after its copy has
    run, and released for refilling right after. Returns (bn_stats,
    stats): bn_stats are the graph's own running-stat buffers, which the
    next call overwrites (pass them back, as a JAX caller passes back the
    state); stats are copies, each stacked over the G steps.
    """

    def __init__(self, device=None):
        self.device = _card(device)
        self.captures = 0
        self._key = None

    def __call__(self, params, bn_stats, opt, batches, settings,
                 generator=None, bank=None):
        _hat_batch(batches, settings, "StepGraph", device_plan=True)
        if not isinstance(opt, Adam):
            raise ValueError(f"StepGraph reads Adam's moments and per-step "
                             f"scalars, not {type(opt).__name__}'s")
        state = tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
        _check_on(self.device, state, "params and the optimizer's state")
        staged = batches if isinstance(batches, Staged) else None
        if staged is not None:
            staged.wait()
            _check_on(self.device, tree_leaves(batches), "a staged batch")
        else:
            batches = to_device(batches, self.device)
        bn_stats = to_device(bn_stats, self.device)
        G = scan_length(batches)
        # the graph draws from the generator for the raw-noise term and
        # for the depths of a plan built on the device
        draws = settings.raw_noise_std > 0 or (
            settings.hat_plan is not None and settings.perturb
            and "hat_sort" not in batches)
        noise = generator if draws else None
        banked = None if bank is None else (
            bank.storage.data_ptr(), tuple(bank.storage.shape), bank.layout)
        key = (settings, _signature(batches), _signature(bn_stats),
               _signature(params), _addresses(state), id(noise),
               (opt.clip, opt.weight_decay, opt.b1, opt.b2, opt.eps), banked)
        if key != self._key:
            self._capture(params, bn_stats, opt, batches, settings, noise, G,
                          bank)
            self._key = key
        _copy_in(tree_leaves(self._batches), tree_leaves(batches))
        if staged is not None:
            staged.consumed()
        _copy_in(tree_leaves(self._bn), tree_leaves(bn_stats))
        # the staging buffer is free once the last call's copy has run
        self._copied.synchronize()
        self._host.copy_(opt.scalars(G))
        self._scalars.copy_(self._host, non_blocking=True)
        self._copied.record()
        self._graph.replay()
        opt.count += G
        return self._bn, {k: v.clone() for k, v in self._stats.items()}

    def _capture(self, params, bn_stats, opt, batches, settings, generator,
                 G, bank):
        self._key = self._graph = None   # the old graph's pool goes first
        self._batches = _owned(batches)
        self._bn = _owned(bn_stats)
        self._scalars = opt.scalars(G).to(self.device)
        self._host = torch.empty((G, 3), pin_memory=True)
        self._copied = torch.cuda.Event()
        # what the warm-up changes and the capture must start from; the
        # parameters and moments are held here so that their addresses,
        # which the graph writes, stay theirs
        self._state = (tree_leaves(params) + tree_leaves(opt.mu)
                       + tree_leaves(opt.nu) + tree_leaves(self._bn))
        saved = [t.detach().clone() for t in self._state]
        count = opt.count
        rng = None if generator is None else generator.get_state()

        def body():
            bn, stats = self._bn, []
            for i in range(G):
                batch = scan_slice(self._batches, i)
                if bank is not None:
                    batch["geom"] = take(bank, batch.pop("geom_rows"))
                loss, (_, new_bn, st), grads = loss_and_grads(
                    params, batch, settings, generator)
                opt.step(params, grads, scalars=self._scalars[i])
                st["loss"] = loss
                bn = merge_bn_stats(bn, new_bn)
                stats.append(st)
            torch._foreach_copy_(tree_leaves(self._bn), tree_leaves(bn))
            return {k: torch.stack([s[k] for s in stats]) for k in stats[0]}

        def restore():
            with torch.no_grad():
                torch._foreach_copy_(list(self._state), saved)
            opt.count = count
            if rng is not None:
                generator.set_state(rng)

        try:
            self._graph, self._stats = _capture(body, restore, generator)
        finally:
            opt.count = count
        self.captures += 1


class RenderGraph:
    """One eval_step render of a latent_xyzc hat batch as a CUDA graph.

    Call it with (params, batch, settings) as eval_step is called. It
    captures at the first call and whenever the shapes, dtypes, settings or
    the parameters' tensors change (`captures` counts them), copies the
    batch into its own buffers where it is not there already, replays, and
    returns copies of the render's maps.
    """

    def __init__(self, device=None):
        self.device = _card(device)
        self.captures = 0
        self._key = None

    def __call__(self, params, batch, settings):
        _hat_batch(batch, settings, "RenderGraph")
        _check_on(self.device, tree_leaves(params), "params")
        batch = to_device(batch, self.device)
        key = (settings, _signature(batch), _signature(params),
               _addresses(tree_leaves(params)))
        if key != self._key:
            self._key = self._graph = None
            self._batch = _owned(batch)
            self._params = params   # the tensors the graph reads stay alive

            def body():
                with torch.no_grad():
                    ret, _ = get_render_fn(settings)(params, self._batch,
                                                     settings)
                return ret

            self._graph, self._out = _capture(body, lambda: None)
            self._key = key
            self.captures += 1
        _copy_in(tree_leaves(self._batch), tree_leaves(batch))
        self._graph.replay()
        return {k: v.clone() for k, v in self._out.items()}
