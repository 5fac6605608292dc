"""StepGraph and RenderGraph (train/graphs.py) on the card, at a small size
(500 vertices, 2 cm voxels, 64 rays x 16 samples), against eager
train_steps and eval_step; and the kernels a replay launches, counted by
name in a torch.profiler trace. Skips where no NVIDIA GPU is present; run on
the card with `python -m pytest --noconftest tests/test_torch_graph_cuda.py
-q`.

Tolerances: the hat backward's float atomics (measured with them; the
backward sums in one fixed order now) and index_add_'s change order from
run to run, so eager runs of the same steps may differ. A graph's run is
held against one eager run of the same steps from the same state, per leaf
(the losses, every parameter, Adam moment and BN running stat) by the L2
distance ||g - e|| over the group's scale, the largest max(||g_l||,
||e_l||) of its leaves (tools/graph_noise.py check), at most TOL of its
group: 4x the farthest pair of 32 eager runs of this scene's steps (the
"small" scene of tools/graph_noise.py on an H100 80GB HBM3 at 700 W), the
largest over three separate runs of the tool (in bf16 the runs agreed
exactly; in f32 this scene's spread moved by up to 560x from one run of
the tool to another); the loss group's rule is older and keeps its
tolerance from three earlier calls (1.5x the largest loss spread measured
since).
chip_smoke.py holds the full-width steps so. A graphed render against
eval_step: 1e-4 (f32) / 2e-2 (bf16) of scale, chip_smoke.py's render
tolerances.
"""
import pytest
import torch

from neuralbody_tpu_torch.models import latent_xyzc as lx
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
from neuralbody_tpu_torch.ops import conv_kernel, hat_kernel
from neuralbody_tpu_torch.renderer.renderer import (RenderSettings,
                                                    precompute_hat_device)
from neuralbody_tpu_torch.tools.graph_noise import (batch_pair, check,
                                                    run_state)
from neuralbody_tpu_torch.tools.trace_loss import device_events
from neuralbody_tpu_torch.train import optimizer
from neuralbody_tpu_torch.train.fresh import stack_batches as stack
from neuralbody_tpu_torch.train.graphs import RenderGraph, StepGraph
from neuralbody_tpu_torch.train.step import eval_step, train_steps
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.synthetic import make_batch

pytestmark = pytest.mark.cuda

G = 2
NV = 500
VOX = 0.02
N_RAYS, N_SAMPLES, SEED = 64, 16, 3
TOL = {"params": 3.03e-4, "mu": 2.35e-3, "nu": 5.25e-4, "bn": 2.66e-5,
       "loss": 3.7e-7}
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


def _scene(dev, n_rays=N_RAYS):
    batch, static = make_batch(n_rays=n_rays, n_verts=NV, voxel_size=VOX,
                               seed=SEED, hat=True, n_samples=N_SAMPLES)
    return to_device(batch, dev), static


def _pair(dev):
    """Batches A and B of one body (tools/graph_noise.batch_pair: two ray
    sets, one plan size) on the card, and their statics."""
    (a, b), static = batch_pair(N_RAYS, NV, VOX, N_SAMPLES, SEED)
    return to_device(a, dev), to_device(b, dev), static


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
    return params, bn, optimizer.build_optimizer(params, lambda t: 5e-4)


def _eager(dev, steps, settings):
    """One eager run of the steps from the seeded state."""
    params, bn, opt = _fresh(dev)
    bn, st = train_steps(params, bn, opt, steps, settings, device=dev)
    return run_state(params, bn, opt, st["loss"])


def _within_tol(graph, eager):
    """Every leaf within its group's TOL of the eager run's."""
    groups, over = check(graph, eager, TOL)
    print("ratio_to_TOL", {g: v["ratio"] for g, v in groups.items()})
    assert not over, (over[:5], groups)


def _kernel_counts(fn, tmp_path):
    """Kernels of one call of fn() by name (device_events: the second of
    two calls in one profile, since a profile's first records are
    sometimes lost)."""
    names = [e["name"] for e in device_events(fn, str(tmp_path / "t.json"))
             if e.get("cat") == "kernel"]
    return {name: sum(name in n for n in names) for name in KERNELS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_graph_against_eager_steps(dev, dtype):
    """Two replays, [A, A] then [B, B], against four eager steps."""
    a, b, static = _pair(dev)
    settings = _settings(static, dtype)
    eager = _eager(dev, [a, a, b, b], settings)
    params, bn, opt = _fresh(dev)
    graph, losses = StepGraph(dev), []
    for batches in (stack([a, a]), stack([b, b])):
        bn, st = graph(params, bn, opt, batches, settings)
        losses.append(st["loss"])
    assert opt.count == 2 * G and graph.captures == 1
    _within_tol(run_state(params, bn, opt, torch.cat(losses)), eager)


def test_step_graph_copies_in_and_captures_again(dev):
    a, b, static = _pair(dev)
    settings = _settings(static, "bfloat16")
    eager = _eager(dev, [b, b], settings)
    params, bn, opt = _fresh(dev)
    state = [t.clone() for t in optimizer.tree_leaves([params, opt.mu,
                                                       opt.nu])]
    graph = StepGraph(dev)
    graph(params, bn, opt, stack([a, a]), settings)
    # the same state again, the other batch: copied into the graph's
    # buffers, no second capture
    with torch.no_grad():
        for t, s in zip(optimizer.tree_leaves([params, opt.mu, opt.nu]),
                        state):
            t.copy_(s)
    opt.count = 0
    _, fresh_bn, _ = _fresh(dev)
    bn, st = graph(params, fresh_bn, opt, stack([b, b]), settings)
    assert graph.captures == 1
    _within_tol(run_state(params, bn, opt, st["loss"]), eager)
    # another ray count: another shape, captured again
    small, small_static = _scene(dev, n_rays=32)
    graph(params, bn, opt, stack([small] * G),
          _settings(small_static, "bfloat16"))
    assert graph.captures == 2


def test_step_graph_replay_launches_the_kernels(dev, tmp_path):
    batch, static = _scene(dev)
    settings = _settings(static, "bfloat16")
    batch = precompute_hat_device(batch, static["hat"]["rows_caps"],
                                  static["site_caps"], 16)
    params, bn, opt = _fresh(dev)
    graph = StepGraph(dev)
    bn, _ = graph(params, bn, opt, stack([batch] * G), settings)
    counts = _kernel_counts(lambda: graph(params, bn, opt,
                                          stack([batch] * G), settings),
                            tmp_path)
    assert counts == {k: G * n for k, n in KERNELS.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_graph_against_eval_step(dev, dtype, tmp_path):
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
    counts = _kernel_counts(lambda: render(params, batch, settings),
                            tmp_path)
    assert counts == {"hat_interp_kernel": 4, "hat_interp_bwd_kernel": 0,
                      "sparse_conv_mma_kernel": 17}
