"""StepGraph and RenderGraph (train/graphs.py) on the card, at a small size
(500 vertices, 2 cm voxels, 64 rays x 16 samples), against eager
train_steps and eval_step; and the kernels a replay launches, counted by
name in a torch.profiler trace. Skips where no NVIDIA GPU is present; run on
the card with `python -m pytest --noconftest tests/test_torch_graph_cuda.py
-q`.

Tolerances: the hat backward's float atomics and index_add_'s change order
from run to run, so eager runs of the same steps differ; that is the noise
floor. The graph's run may lie at most twice the largest distance between
two of EAGER_RUNS eager runs, plus 1e-6 of scale, from the nearest of them
(L2), in the losses, every parameter leaf, the Adam moments and the BN
running stats; chip_smoke.py holds the full-width steps so. A graphed
render against eval_step: 1e-4 (f32) / 2e-2 (bf16) of scale,
chip_smoke.py's render tolerances.
"""
import itertools

import pytest
import torch

from neuralbody_tpu_torch.models import latent_xyzc as lx
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
from neuralbody_tpu_torch.ops import conv_kernel, hat_kernel
from neuralbody_tpu_torch.renderer.renderer import (RenderSettings,
                                                    precompute_hat_device)
from neuralbody_tpu_torch.train import optimizer
from neuralbody_tpu_torch.train.graphs import RenderGraph, StepGraph
from neuralbody_tpu_torch.train.step import eval_step, scan_slice, train_steps
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.synthetic import make_batch

pytestmark = pytest.mark.cuda

G = 3
EAGER_RUNS = 5
NV = 500
VOX = 0.02
RENDER_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNELS = {"hat_interp_kernel": 4, "hat_interp_bwd_kernel": 4,
           "sparse_conv_mma_kernel": 34}   # launches a training step


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    conv_kernel.build()
    return torch.device("cuda")


def _scene(dev, n_rays=64):
    batch, static = make_batch(n_rays=n_rays, n_verts=NV, voxel_size=VOX,
                               seed=3, hat=True, n_samples=16)
    return to_device(batch, dev), static


def _settings(static, dtype):
    return RenderSettings(
        model=lx.ModelStatic(encoder=EncoderStatic(
            out_sh=static["out_sh"], site_caps=static["site_caps"],
            compute_dtype=dtype)),
        voxel_size=(VOX,) * 3, hat_rows_caps=static["hat"]["rows_caps"])


def _fresh(dev):
    params, bn = lx.init(torch.Generator().manual_seed(0), num_train_frame=1,
                         nv=NV, device=dev)
    params["alpha_fc"]["b"] += 1.0   # random weights leave the rays empty
    return params, bn, optimizer.make_optimizer(params, lambda t: 5e-4)


def _stack(batch):
    return optimizer.tree_map(lambda x: x[None].expand(G, *x.shape), batch)


def _leaves(params, bn, opt, losses):
    return optimizer.tree_leaves([params, opt.mu, opt.nu, bn]) + [losses]


def _eager(dev, batches, settings):
    """EAGER_RUNS eager runs of the G steps, each from the seeded state."""
    runs = []
    for _ in range(EAGER_RUNS):
        params, bn, opt = _fresh(dev)
        bn, st = train_steps(params, bn, opt,
                             [scan_slice(batches, i) for i in range(G)],
                             settings, device=dev)
        runs.append(_leaves(params, bn, opt, st["loss"]))
    return runs


def _within_noise(graph, eager):
    """Per leaf (L2): the graph's distance from the nearest eager run at
    most 2 x the largest distance between two eager runs + 1e-6 x scale."""
    for i, (g, *es) in enumerate(zip(graph, *eager)):
        g, es = g.float(), [e.float() for e in es]
        err = min((g - e).norm().item() for e in es)
        floor = max((a - b).norm().item()
                    for a, b in itertools.combinations(es, 2))
        assert err <= 2 * floor + 1e-6 * es[0].norm().item(), (i, err, floor)


def _kernel_counts(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {name: sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and name in e.key)
            for name in KERNELS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_graph_against_eager_steps(dev, dtype):
    batch, static = _scene(dev)
    settings = _settings(static, dtype)
    batches = _stack(batch)
    eager = _eager(dev, batches, settings)
    params, bn, opt = _fresh(dev)
    graph = StepGraph(dev)
    bn, st = graph(params, bn, opt, batches, settings)
    assert opt.count == G and graph.captures == 1
    _within_noise(_leaves(params, bn, opt, st["loss"]), eager)


def test_step_graph_copies_in_and_captures_again(dev):
    batch, static = _scene(dev)
    settings = _settings(static, "bfloat16")
    other = dict(batch, rgb=1.0 - batch["rgb"])
    eager = _eager(dev, _stack(other), settings)
    params, bn, opt = _fresh(dev)
    state = [t.clone() for t in optimizer.tree_leaves([params, opt.mu,
                                                       opt.nu])]
    graph = StepGraph(dev)
    graph(params, bn, opt, _stack(batch), settings)
    # the same state again, the other batch: copied into the graph's
    # buffers, no second capture
    with torch.no_grad():
        for t, s in zip(optimizer.tree_leaves([params, opt.mu, opt.nu]),
                        state):
            t.copy_(s)
    opt.count = 0
    _, fresh_bn, _ = _fresh(dev)
    bn, st = graph(params, fresh_bn, opt, _stack(other), settings)
    assert graph.captures == 1
    _within_noise(_leaves(params, bn, opt, st["loss"]), eager)
    # another ray count: another shape, captured again
    small, small_static = _scene(dev, n_rays=32)
    graph(params, bn, opt, _stack(small), _settings(small_static, "bfloat16"))
    assert graph.captures == 2


def test_step_graph_replay_launches_the_kernels(dev):
    batch, static = _scene(dev)
    settings = _settings(static, "bfloat16")
    batch = precompute_hat_device(batch, static["hat"]["rows_caps"],
                                  static["site_caps"], 16)
    params, bn, opt = _fresh(dev)
    graph = StepGraph(dev)
    bn, _ = graph(params, bn, opt, _stack(batch), settings)
    counts = _kernel_counts(lambda: graph(params, bn, opt, _stack(batch),
                                          settings))
    assert counts == {k: G * n for k, n in KERNELS.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_graph_against_eval_step(dev, dtype):
    batch, static = _scene(dev)
    settings = _settings(static, dtype)
    params, _, _ = _fresh(dev)
    render = RenderGraph(dev)
    for b in (batch, dict(batch, Th=batch["Th"] + 0.01)):
        got = render(params, b, settings)
        want = eval_step(params, b, settings, device=dev)
        for k in ("rgb_map", "acc_map", "depth_map", "disp_map"):
            err = (got[k] - want[k]).abs().max().item()
            scale = max(1.0, want[k].abs().max().item())
            assert err <= RENDER_TOL[dtype] * scale, (k, err)
    assert render.captures == 1
    counts = _kernel_counts(lambda: render(params, batch, settings))
    assert counts == {"hat_interp_kernel": 4, "hat_interp_bwd_kernel": 0,
                      "sparse_conv_mma_kernel": 17}
