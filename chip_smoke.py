#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neuralbody_tpu_torch) on one NVIDIA
GPU. It builds the port's CUDA kernels from the checkout (one nvcc per
source, started together) and drives the port's main paths at full width
through their entry points:

  * the forward render on the host-planned hat path (eval_step), bf16 and
    f32, held against the port's own CPU render;
  * the training step (train_step: encode, hat interpolation, decode,
    composite, masked MSE, backward, value-clip + Adam, BN EMA), bf16 and
    f32: the first step's loss and gradients held against the same step
    run by the port on the CPU, then ten steps on one batch whose loss must
    fall;
  * the plan-free eval render (eval_step on a rays-only batch of 8192 rays
    in four chunks, hull culling on), bf16 and f32, through the
    site-interpolation and the dense branch: held against the port's CPU
    render, the two branches against each other, the site sampler's
    kernel against its plain version on the site render's own chunks
    (one launch a chunk, no plain call), and the site render of
    the 1024-ray batch against its hat render; then render_density_grid on
    one chunk of points against the CPU;
  * the NeRF baseline family (D=8, W=256, 64 coarse + 128 importance
    samples, f32): nerf_eval_step on 8192 rays in four chunks, held against
    the port's CPU render and against four one-chunk renders; the first
    nerf_train_step's loss and gradients against the same step on the CPU,
    then ten steps with the perturbation on whose loss must fall;
  * the graphed paths (train/graphs.py), bf16 and f32: two replays of a
    two-step StepGraph (train_step_scan's dispatch) on batches A then B
    against one eager run of the four steps (the losses, every parameter,
    Adam moment and BN-stat leaf within GRAPH_TOL, a fixed tolerance per
    group on the L2 distance over the group's scale), the same graph fed A
    in its second replay (a stale copy, which the check must put over its
    limit by STALE_MIN) and the graphed state with mu's largest leaf
    negated (which must be over it) or params' largest at its seeded
    value,
    the kernels a replay launches counted by name in a torch.profiler
    trace, and a RenderGraph render against eval_step; then both timed
    beside their eager loops, an eager step's host operations profiled,
    and the port's bench (neuralbody_tpu_torch/bench.py) run;
  * the config path, bf16: make_cfg of the 313 config, the registered
    factories, make_data_loader over two spawned workers (the C++ hat
    planner in the workers) on a SyntheticDataset of 4 frames x 4 cameras
    at 512^2, G = 8 batches a dispatch. Banked (the default): each frame's
    geometry in a device GeomBank, each group staged by the prefetcher
    (pinned sets, a side stream) for train_step_scan_banked's graph: a
    warm epoch of two dispatches held against eager steps on the same
    batches (CONFIG_TOL), a timed epoch of four (dispatch ms, rays/s, bytes
    copied a dispatch, bank installs and bytes, one capture in all), an
    epoch of two whose second dispatch is traced (kernels by name, busy
    share), another traced whole (its host-to-device copies and how much
    of them kernels on another stream cover). Then, on the same pool, the
    stacked path (bank=False: each group stacked on the host) timed the
    same way, and the bench's fresh half (bench.measure_fresh: 2 warm and
    12 timed dispatches), whose rays/s fill the bench line's `value`;
  * the training harness (train/trainer.Trainer) on a fake ZJU-MoCap
    sequence (utils/fake_zju: 4 frames x 4 cameras at 1024^2, 6890
    vertices; views 0-2 train, view 3 tests): "trainer_fit", the 313
    config in bf16 (G = 8, two loader workers), fit() of two epochs of two
    dispatches (one capture; latest.ckpt, 0.ckpt and 1.ckpt), validate()
    on the test view's four frames (finite PSNR, SSIM in [0, 1]), a second
    Trainer resumed from latest.ckpt bit for bit, the Trainer's epoch
    timed with a read of every dispatch and with one read at its end
    beside the fresh half's dispatch, a resume in place (no new capture);
    "trainer_nerf", nerf_313.yaml (f32) through the eager branch, one
    epoch of eight steps and validate();
  * the first trained model and the tool entry point over it:
    "quality_short", tools/convergence_run.main for two epochs of 250
    steps at full width (f32, G = 8, the shaded fixture at 512^2: 5
    training views, 1 held out), the held-out PSNR after them at least
    QUALITY_MIN_PSNR, then tools/novel_pose_eval.main on two unseen poses;
    "run_entry", every runner of neuralbody_tpu_torch/run.py over that
    checkpoint: evaluate against Trainer.validate, visualize in the four
    vis_* modes (orbit views, playback frames, rotated SMPL, the mesh at
    5 mm with its first density chunk against the CPU), light_stage,
    evaluate_nv on evaluate's renders, dataset and network; "run_nerf",
    evaluate and vis_mesh over trainer_nerf's checkpoint;
  * "graph_vs_eager_trained": graphed bf16 steps from quality_short's
    checkpoint against eager ones at TRAINED_TOL (the trained state
    spreads eager bf16 runs wider than seeded weights), a stale copy and a
    negated mu leaf over it;
  * the T-pose variant (configs/tpose/tpose_313.yaml, f32, eager) over the
    harness's sequence with warping from a posed synthetic SMPL model:
    "tpose_kernel", the conv kernel against its plain version at the
    T-pose encoder's 17 layer shapes, forward and dx; "tpose_render", the
    1024-ray render against the port's CPU render; "tpose_train", the
    first step's gradients against the CPU's, an eager step timed and its
    parts timed apart, Trainer fit and validate;
  * the hat plan built on the card ("device_plan"): plan_hat_device on the
    card against the CPU, bit for bit; the render from a device plan
    against the host plan's; the 313 config with cfg.tpu.hat_plan_device
    (graphed, banked) beside the host-planned config, its warm epoch
    against eager steps at CONFIG_TOL;
  * the multi-process layer: "dist_two_ranks", two ranks of the sharded
    steps on the one card (tools/dist_check.py; NCCL, or gloo on CUDA
    tensors where NCCL refuses two ranks on one device) against one
    process at DIST_TOL, the ranks bit for bit, ShardedEval of 8192 rays
    against eval_step, batch mode's synced BatchNorm over two frames;
    "dist_entry", the port's train_net under torchrun's variables (NCCL,
    one rank) for one epoch and a validate.

Each kernel (the hat contraction forward, with its cell lookup and with
its scan, and backward, its sums in one fixed order; the gather-fused sparse conv on the tensor cores
in all 17 layers of the encoder, forward and dx, timed beside the conv
weight gradient; and the dense layer in every layer of the NeRF MLPs: the product forward, dx and dW on its tensor-core, narrow and FMA
routes, and `linear` with the bias and the ReLU in the epilogue, forward
and its three gradients; the site sampler's four levels in one launch a
chunk of the plan-free render) is held against its plain PyTorch version on the
inputs the main paths hand it, and timed beside its plain version, a
library yardstick (where one PyTorch call computes the function) and its
bound; the renders and the training steps are
timed and profiled. The conv library's machine code is read with cuobjdump
to show that both modes of the conv issue tensor-core (HMMA) instructions.

    python3 chip_smoke.py

The full-width batches are the reference working point: 6890 vertices,
5 mm voxels, 64 samples per ray, 1024 rays (hat paths) or 8192 rays
(plan-free render), encoder channels 16/32/64/128/128, decoder 352 -> 256
-> ... -> 3, random weights from a seeded torch.Generator. The NeRF
baseline renders the same 8192 and 1024 rays.

Every phase raises on failure. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels.
Exits non-zero with no result line when no CUDA device is present.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

SEED = 0
N_RAYS = 1024
N_SAMPLES = 64
VOX = 0.005
ALPHA_BIAS = 1.0   # raised alike in both renders: random weights are empty
LR = 5e-4          # the latent_xyzc configs: exponential, gamma 0.1 over
EP_ITER = 500      # 1000 epochs of 500 iterations
TRAIN_STEPS = 10   # steps on one batch whose loss must fall
TRAIN_ROUNDS = 4   # timed rounds of bf16 and f32 steps, interleaved
STEPS_PER_ROUND = 6
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_OPS = {"bf16": 989e12,        # tensor cores, dense
            "tf32": 495e12,
            "f32": 67e12}          # f32 outside the tensor cores
KERNEL_TOL = {"f32": 1e-5,   # relative to the level's scale: sum order
              # a weight one f32 ulp apart can round to the neighbouring
              # bf16 value: 2**-8 on that one term
              "bf16": 1e-3}
RENDER_TOL = {"f32": 1e-4,   # against the CPU f32 render: sum order
              "bf16": 2e-2}  # bf16 storage and operands against f32
# the first training step's gradients on the card against the same step on
# the CPU (f32, plain versions), per leaf, as the L2 norm of the error over
# the leaf's, for (decoder leaves, encoder leaves). The encoder's gradients
# of these random weights (~1e-7, behind 14 BatchNorms) are ill-conditioned:
# sum order alone moves them by ~3e-3, as the "conditioning" phase measures
# (one f32 ulp on the vertex codes on the CPU; the card run to run, float
# atomics). bf16 storage and operands round at 2**-9 in every layer, which
# the same conditioning amplifies.
GRAD_TOL = {"f32": (1e-3, 2e-2), "bf16": (1e-1, 1.0)}
GRAD_FLOOR = 1e-30  # a leaf whose gradient is exactly zero
MAPS = ("rgb_map", "acc_map", "depth_map", "disp_map")
SPIN_CYCLES = 10_000_000  # ~5 ms at the H100's clock: covers host enqueue
RENDER_ROUNDS = 8         # rounds of bf16 and f32 renders, interleaved
RENDERS_PER_ROUND = 3     # per mode and round
EVAL_RAYS = 8192          # the plan-free render's batch:
CHUNK_RAYS = 2048         # four chunks of 131,072 points,
HULL_VIEWS = 4            # culled against four source views
EVAL_ROUNDS = 4           # rounds of bf16 and f32 renders per branch
CONV_LAYERS = 17          # sparse convs per encode (and dx per backward)
CONV_TOL = 1e-5   # of the layer's scale, f32 and bf16 storage alike: both
# versions round the operands alike, so only the f32 sum's order differs
SITE_DENSE_TOL = 1e-4     # the two branches read the same numbers (f32)
SITE_TOL = 1e-6   # the site sampler's kernel against its plain version, of
# the output's scale: the kernel repeats the plain f32 operations in their
# order and upcasts bf16 features exactly: equal bits is the design target
N_IMPORTANCE = 128        # the NeRF configs: 64 coarse + 128 importance
NERF_ALPHA_BIAS = 1.0     # on alpha_linear of both MLPs, card and CPU alike:
# random weights leave half the samples empty, and an empty last bin makes
# the importance sample at u = 1 jump a bin with the last bit of the cdf
NERF_ROUNDS = 4           # timed rounds of NeRF renders and steps
MM_TOL = 1e-5     # of the product's scale, f32 and bf16 operands alike: the
# same products (exact in f32) summed in another order
NERF_TOL = 1e-4   # of scale: the card's render, loss and gradient leaves
# against the CPU's (f32; no BatchNorm and no atomics in this family)
# The first NeRF step's gradient leaves, card against CPU, per leaf as
# (max |err| / max |ref|, L2 of the error over the leaf's L2). The fine
# MLP's depths come from the coarse weights through the inverse CDF, and the
# positional encoding multiplies a depth's last bits by up to 2**9, so the
# fine MLP's first layers are the worst conditioned: the "nerf_conditioning"
# phase measures what one f32 ulp on the first layers' weights does to the
# CPU step, and what the products' sum order alone does on the card.
NERF_GRAD_TOL = (2e-3, 2e-3)
MM_PER_MLP = 12           # dense layers of one MLP application
DECODE_POINTS = 131072    # one chunk of the plan-free latent_xyzc render
DECODE_LAYERS = ((352, 256), (256, 256), (256, 256), (256, 1), (256, 256),
                 (384, 256), (346, 128), (128, 3))   # decode_raw's (K, N)
GRAPH_G = 2      # steps a StepGraph replay: two replays held against
# eager steps, five (ten steps) for the launches and the falling loss (a
# replay's trace of ~4,700 kernels; the profiler dropped some of 10,300)
SCAN_G = 8       # steps a dispatch in scan_timing, as in the bench
SCAN_ROUNDS = 2  # ABBA rounds of one graphed and one eager dispatch
# A graph against one eager run of the same steps from the same state: per
# leaf the L2 distance ||g - e|| over its group's scale, the largest
# max(||g_l||, ||e_l||) of the group's leaves (an equal leaf is at 0), at
# most the group's tolerance (tools/graph_noise.py says why the scale is the
# group's). The hat backward's float atomics and index_add_ change their
# order from run to run, and the encoder amplifies that over the steps, so
# eager runs differ; each tolerance is 4x the farthest pair of 32 eager runs,
# the larger of bf16's and f32's, the largest over two separate runs of
# tools/graph_noise.py on an H100 80GB HBM3 at 700 W (PERF.md section 2);
# the loss group, whose rule did not change, keeps the largest of the
# earlier calls' that is no looser.
# GRAPH_TOL: graph_vs_eager's four steps ("full" scene); CONFIG_TOL:
# config_path's two dispatches of G = 8 loader batches ("config" scene,
# bf16).
GRAPH_TOL = {"params": 1.24e-3, "mu": 2.7e-3, "nu": 3.42e-3, "bn": 9.8e-4,
             "loss": 8.6e-6}
CONFIG_TOL = {"params": 5.5e-3, "mu": 1.97e-2, "nu": 7.0e-3, "bn": 0.126,
              "loss": 1.2e-3}
STALE_MIN = 10   # a second replay fed the first's batch (a stale copy)
# must be over its tolerance by at least this in its worst group
CONFIG_G = 8         # config_path: steps a dispatch, as in production
CONFIG_WORKERS = 2   # its loader workers (one pool for both epochs)
CONFIG_WARM = 2      # dispatches of its warm epoch (the capture)
CONFIG_TIMED = 4     # dispatches of its timed epoch
CONFIG_READ_ROUNDS = 2    # its rounds of epochs read every dispatch / once
CONFIG_HOST_BATCHES = 8   # batches whose host parts it times
CONFIG_H2D_MAX = 10e6     # bytes a banked dispatch may copy to the card
FRESH_DISPATCHES = 12     # the bench's fresh half: its timed dispatches
TRAINER_FRAMES = 4        # trainer_fit / trainer_nerf: frames of the fake
TRAINER_CAMS = 4          # ZJU sequence, its cameras (views 0-2 train,
TRAINER_HW = 1024         # view 3 tests), written at 1024^2 (the configs'
TRAINER_VERTS = 6890      # ratio 0.5 gives 512^2), SMPL's vertex count
TRAINER_DISPATCHES = 2    # dispatches of each of fit's two epochs
TRAINER_TIMED = 4         # dispatches of each timed Trainer epoch
NERF_STEPS = 8            # trainer_nerf: its epoch of eager steps
QUALITY_EPOCHS = 2        # quality_short: epochs of 250 steps (G = 8, f32)
QUALITY_MIN_PSNR = 19.0   # its held-out PSNR after them (the JAX package's
# TPU run read 21.29 dB at step 500, QUALITY_r05.json)
EVAL_VS_VALIDATE = 1e-6   # run.py evaluate against Trainer.validate (dB;
# the same renders of the same state)
NV_VS_EVALUATE = 0.5      # evaluate_nv on evaluate's saved renders (dB:
# 8-bit JPEGs of the float renders)
VIEWS = 4                 # run_entry: vis_novel_view's views (of 50),
PERFORM_FRAMES = 2        # vis_novel_pose's frames,
ROTATE_INTERVAL = 28      # vis_rotate_smpl's FrameSampler interval (rows of
# 5 training views: indices 0-4 of 144)
DATASET_BATCHES = 16      # the dataset runner's epoch
NERF_MESH_TH = 1.0        # run_nerf: the iso of an 8-step NeRF, whose
# densities sit near the raised alpha bias (the YAML's 5 is for a trained
# body)
# TRAINED_TOL: graph_vs_eager_trained's four bf16 steps ("full" scene)
# from quality_short's checkpoint (500 steps). A trained state spread the
# eager bf16 runs of the atomic hat backward far wider than seeded weights
# did (PERF.md section 2): 4x the largest spread of seven calls of
# tools/graph_noise.py --ckpt from 19,000-, 18,500- and 500-step
# checkpoints (an H100 80GB HBM3 at 700 W).
TRAINED_TOL = {"params": 2.13e-3, "mu": 7.75e-2, "nu": 5.15e-2,
               "bn": 1.72e-3, "loss": 1.14e-3}
TRAINED_GRAPH_RUNS = 2    # graphed runs held against the one eager run
DIST_WORLD = 2            # dist_two_ranks: ranks on the one card
# dist_two_ranks: the sharded runs' group distance from one process
# (tools/graph_noise.distances after tools/dist_check.STEPS steps), by
# precision, measured with tools/dist_check.py at this size in five calls
# on an H100 80GB HBM3 at 700 W (PERF.md section 2). f32: 4x the largest
# one-process spread (the hat backward's float atomics), the loss, whose
# spread was 0, at 4 units of f32's last place. bf16 is deterministic (its
# one-process runs bit-equal, its sharded distances the same to the digit
# in all five calls): 2x the larger of the two layouts' distances. The
# faults dist_check plants (the parameter leaf that moved farthest left
# stale; the gradients' all_reduce dropped) must land over these in both
# layouts.
DIST_TOL = {"f32": {"params": 1.25e-4, "mu": 1.26e-4, "nu": 3.24e-5,
                    "bn": 7.4e-6, "loss": 4.8e-7},
            "bf16": {"params": 6.64e-4, "mu": 3.32e-3, "nu": 6.36e-3,
                     "bn": 2.58e-4, "loss": 3.66e-6}}
TPOSE_CONFIG = "configs/tpose/tpose_313.yaml"
TPOSE_VSIZE = 0.02        # the posed warping grid's voxel (the YAML's)
TPOSE_POSE_STD = 0.02     # the synthetic SMPL poses of its frames (radians;
# 0.2 swelled the posed grid to 591k points)
TPOSE_DISPATCHES = 2      # dispatches of each of its fit's two epochs
TPOSE_STEP_RUNS = 5       # timed eager steps on one batch
PRODUCT_KERNEL = re.compile(r"gemm|gemv|splitkreduce", re.IGNORECASE)
HOST_TOP = 15    # host operations listed by host_profile
MM_REPLACES = "tools/probes/pallas_enc_interp.py:22"
CONV_REPLACES = ("tools/probes/pallas_gather.py:25, "
                 "tools/probes/indexed_ops.py:122, "
                 "tools/probes/pallas_dconv_scatter.py:50")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


START = time.perf_counter()


def emit(**kw):
    """One JSON line of a phase's results, with the seconds since start."""
    print(json.dumps(dict(kw, at_s=time.perf_counter() - START)), flush=True)


def median_ms(torch, fn, runs=11, warmup=3):
    """Median device time of fn() over `runs` CUDA-event timings, after
    `warmup` calls. A device-side spin before each timed region keeps the
    card busy while the host enqueues fn's launches, so the interval holds
    the device's work and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def hat_bound(torch, rows, pos, C, capS, elem_bytes, nnz, mode, nbytes_out):
    """The least time of one level's hat function on this card: its bytes
    (pos and rows read; the features, at elem_bytes each, and coordinates
    of each site some group names read once; the output written once)
    against its operations (2 C per nonzero weight)."""
    used = torch.unique(rows[rows < capS]).numel()
    nbytes = (4 * (pos.numel() + rows.numel()) + nbytes_out
              + used * (C * elem_bytes + 4 * 3))
    ops = 2 * C * nnz
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[mode]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def conv_bound(torch, T, idx, W, mode):
    """The least time of one sparse conv on this card: its bytes (each table
    row some index names read once at the table's element size, the index
    table and the weights, in the table's type, read, the f32 output
    written) against its operations (2 E Cout per index that names a row;
    the zero-row entries need none). bf16 operands run on the tensor cores;
    f32 operands go to them as three TF32 products of the operands' halves,
    so their operations count three times at the TF32 rate, and the same
    operations at the f32 CUDA cores' rate are returned beside it."""
    n_rows, E = T.shape[-2:]
    Cout = W.shape[2]
    named = idx[idx < n_rows]
    nbytes = (torch.unique(named).numel() * E * T.element_size()
              + 4 * idx.numel() + W.numel() * T.element_size()
              + 4 * idx.numel() // idx.shape[-2] * Cout)
    ops = 2 * E * Cout * named.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops / PEAK_OPS["bf16"] if mode == "bf16"
             else 3 * ops / PEAK_OPS["tf32"])
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_cores_ms=1e3 * max(t_bytes, ops / PEAK_OPS["f32"]),
                bytes=nbytes, ops=ops)


def conv_tiles(torch, idx, n_rows, tile):
    """What the conv kernel's tiles of `tile` sites see in an index table:
    the share of (tile, tap) pairs that no site of the tile names (skipped
    whole), and the share of the entries of the other pairs that name a row
    (the rest the tensor cores multiply as zeros)."""
    K, S = idx.shape[-2:]
    named = (idx < n_rows).reshape(-1, K, S).float()
    named = torch.nn.functional.pad(named, (0, -S % tile)).reshape(
        named.shape[0], K, -1, tile)
    live = named.amax(-1)
    return (1.0 - live.mean().item(),
            named.sum().item() / max(1.0, tile * live.sum().item()))


def sass_counts(path, kernel):
    """{function: HMMA instructions} of the functions of a built library
    whose name holds `kernel`, read with cuobjdump -sass."""
    from neuralbody_tpu_torch.utils import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def mm_bound(A, B, mode):
    """The least time of one dense product on this card: its bytes (both
    operands read once at their element size, the f32 output written once)
    against its operations (2 M K N). An f32 product goes to the tensor
    cores as three TF32 products of the operands' halves, so its operations
    count three times at the TF32 rate; the same operations at the rate of
    the f32 CUDA cores are returned beside it."""
    M, K = A.shape
    N = B.shape[1]
    nbytes = (M * K + K * N) * A.element_size() + 4 * M * N
    ops = 2 * M * K * N
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops / PEAK_OPS["bf16"] if mode == "bf16"
             else 3 * ops / PEAK_OPS["tf32"])
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_cores_ms=1e3 * max(t_bytes, ops / PEAK_OPS["f32"]),
                bytes=nbytes, ops=ops)


def library_conv(torch, T, idx, W):
    """The yardstick of the conv kernel: PyTorch's own gather and batched
    product (a zero row appended, index_select, a cast, torch.bmm and a sum
    over the taps), which is how the port ran every conv before it had the
    kernel. Timed here, called nowhere in the port. One batch element."""
    T, idx = T[0], idx[0]
    fpad = torch.cat([T, torch.zeros_like(T[:1])], dim=0)
    g = torch.index_select(fpad, 0, idx.reshape(-1).long()).reshape(
        *idx.shape, T.shape[1])
    return torch.bmm(g.float(), W.to(T.dtype).float()).sum(0)


def materialized_hat(torch, sites, rows, pos):
    """The [ngrp, P, capR] hat weights, materialized (yardsticks and
    bounds only)."""
    spad = torch.cat([sites.float(),
                      torch.full((1, 3), 1e9, device=sites.device)])
    rc = spad[rows.long()]
    t = (1.0 - (pos[:, :, None, :] - rc[:, None, :, :]).abs()).clamp(min=0)
    return t[..., 0] * t[..., 1] * t[..., 2]


def hat_nonzeros(torch, sites, rows, pos):
    """Nonzero hat weights of one level: the products this data needs."""
    return int((materialized_hat(torch, sites, rows, pos) > 0).sum())


def profile_step(torch, step, what, mode, step_ms, top=12):
    """Device time of one render or training step by kernel
    (torch.profiler, tools/trace_loss.device_events: the second of two
    steps in one profile), and the share of the unprofiled step time the
    device is busy."""
    from neuralbody_tpu_torch.tools.trace_loss import device_events
    from neuralbody_tpu_torch.utils import cuda_build
    by_name = {}
    for e in device_events(step, os.path.join(cuda_build.BUILD_DIR,
                                              f"profile_{what}_{mode}.json")):
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    # the device's own events (kernels, copies, memsets)
    rows = [(k, ms, n) for k, (ms, n) in by_name.items() if ms]
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit(phase="profile", path=what, mode=mode, device_busy_ms=busy,
         busy_share=busy / step_ms, kernels=len(rows), launches=launches,
         top=[{"name": k[:90], "ms": ms, "count": n}
              for k, ms, n in rows[:top]])
    return busy, launches


def interleaved_ms(torch, run, modes, rounds, per_round):
    """Host-clock times (ms) of run(mode) in ABBA rounds, each ending in a
    synchronize, so a drift of the host's speed reaches both modes alike.
    Returns ({mode: [ms, ...]}, [median bf16 - median f32 per round])."""
    times = {mode: [] for mode in modes}
    gaps = []
    for mode in modes:
        for _ in range(2):
            run(mode)
    torch.cuda.synchronize()
    for rnd in range(rounds):
        med = {}
        for mode in (modes if rnd % 2 == 0 else modes[::-1]):
            ts = []
            for _ in range(per_round):
                t0 = time.perf_counter()
                run(mode)
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            times[mode] += ts
            med[mode] = statistics.median(ts)
        gaps.append(med[modes[0]] - med[modes[1]])
    return times, gaps


def leaves(tree):
    """(path, tensor) pairs of a nested dict/list tree, keys sorted."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", x) for i, v in enumerate(tree)
                for p, x in leaves(v)]
    return [("", tree)]


def stack_steps(batch, G):
    """A batch repeated on a leading axis of G steps (a broadcast view)."""
    return {k: stack_steps(v, G) if isinstance(v, dict)
            else v[None].expand(G, *v.shape) for k, v in batch.items()}


def traced_kernels(torch, fn, path):
    """The kernels one call of fn() launches on the card, read from a
    torch.profiler trace (CUDA activity; a graph's replay shows each of its
    kernel nodes; tools/trace_loss.device_events: fn() runs twice in the
    profile and the second call is read, since a profile's first records
    are sometimes lost): the three hand kernels by name, the conv launches
    that run as a cluster (grid.y > 1: the split count, which is the
    cluster's size), the dense products (cuBLAS's gemm, gemv and split-K
    kernels), and the device's busy ms and busy share (trace_loss.busy_share:
    the union of the kernels', copies' and fills' intervals on every stream,
    over the span from the first to the last)."""
    from neuralbody_tpu_torch.tools.trace_loss import busy_share, device_events
    events = device_events(fn, path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy, _, share = busy_share(events)

    def count(pred):
        return sum(1 for e in kernels if pred(e["name"], e.get("args", {})))

    return dict(
        busy_ms=busy / 1e3, busy_share=share,
        kernels=len(kernels),
        hat_fwd=count(lambda n, a: "hat_interp_kernel" in n),
        hat_bwd=count(lambda n, a: "hat_interp_bwd_kernel" in n),
        conv=count(lambda n, a: "sparse_conv_mma_kernel" in n),
        conv_cluster=count(lambda n, a: "sparse_conv_mma_kernel" in n
                           and a.get("grid", [1, 1, 1])[1] > 1),
        products=count(lambda n, a: PRODUCT_KERNEL.search(n) is not None))


def timed_epoch(epoch):
    """Run an epoch's dispatches, each read back (its losses) as it comes:
    (the losses of each, ms from the last read to this one, the epoch's
    seconds)."""
    losses, ms = [], []
    t0 = last = time.perf_counter()
    for st in epoch:
        losses.append(st["loss"].tolist())
        now = time.perf_counter()
        ms.append(1e3 * (now - last))
        last = now
    return losses, ms, last - t0


def start_pool(ds):
    """A started loader pool over ds (every worker spawned, its imports
    done, the dataset unpickled, one batch through the result queue) and
    the seconds that took."""
    from neuralbody_tpu_torch.datasets.loader import WorkerPool
    t0 = time.perf_counter()
    pool = WorkerPool(ds, CONFIG_WORKERS)
    try:
        list(pool.run_epoch(-1, [0] * CONFIG_WORKERS, 1, ds.n_rand, None, 0,
                            0, CONFIG_WORKERS))
    except BaseException:
        pool.shutdown()
        raise
    return pool, time.perf_counter() - t0


def config_path(torch, dev, card, cfg, ds, pool, failed):
    """The config path, bf16: make_cfg of the 313 config (tools/graph_noise
    config_case "full": SyntheticDataset of 4 frames x 4 cameras at 512^2,
    1024 rays x 64 samples, 6890 vertices, 5 mm voxels), the registered
    factories (train/fresh.ConfigRun), make_data_loader over `pool`
    (CONFIG_WORKERS spawned workers, the C++ planner in the workers), G = 8
    batches a dispatch. Banked (the default): each frame's geometry in a
    device GeomBank, each group staged by the prefetcher (pinned sets, a
    side stream) for train_step_scan_banked's StepGraph. A warm epoch of
    CONFIG_WARM dispatches (the capture), a timed epoch of CONFIG_TIMED,
    then an epoch of two whose second dispatch is traced, another of
    two traced whole for its host-to-device copies, and CONFIG_READ_ROUNDS
    rounds of two timed epochs of CONFIG_TIMED: one that reads each
    dispatch's losses as it ends (as the YAML's log_interval 1 does) and
    one that reads them once, at its end (as the bench's fresh half
    does). Then the stacked
    path (bank=False) on the same pool and plan sizes: one warm dispatch
    (its capture) and a timed epoch of CONFIG_TIMED; and, apart, the parts
    of a stacked dispatch. Held: the banked warm epoch's
    state against one eager run of its batches (tools/graph_noise.check at
    CONFIG_TOL), one capture a path, the kernels a banked step launches, the
    mean loss of the last banked dispatch under the first's, a banked
    dispatch's copy under 10 MB. Returns the hat forward, hat backward,
    conv and conv dx launches counted over the banked epochs (at capture)
    and a banked replay's kernels per step."""
    import cv2
    import numpy as np

    from neuralbody_tpu_torch.datasets.loader import (
        _batch_seed, apply_hat_spec, collate, make_data_loader)
    from neuralbody_tpu_torch.ops import hat_planner_native
    from neuralbody_tpu_torch.tools import graph_noise
    from neuralbody_tpu_torch.train.fresh import stack_batches, with_geom
    from neuralbody_tpu_torch.train.graphs import WARMUP
    from neuralbody_tpu_torch.train.optimizer import tree_leaves
    from neuralbody_tpu_torch.train.step import train_step_scan, train_steps
    from neuralbody_tpu_torch.utils import cuda_build
    from neuralbody_tpu_torch.utils.platform import to_device

    G = CONFIG_G
    cfg.ep_iter = CONFIG_WARM * G
    run = graph_noise.config_run(cfg, ds, dev, pool)
    reset_kernel_counts()
    t0 = time.perf_counter()
    warm = list(run.loader(0))
    warm_losses = [st["loss"] for st in run.epoch(0, loader=warm)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    graph_state = graph_noise.run_state(
        run.params, run.bn_stats, run.opt, torch.cat(warm_losses))
    # the timed epoch (the loader reads ep_iter per epoch; the optimizer's
    # schedule keeps the warm epoch's)
    cfg.ep_iter = CONFIG_TIMED * G
    losses, dispatch_ms, epoch_s = timed_epoch(run.epoch(1))
    counts = kernel_counts(*HAT_CONV, "conv_dx")
    captures = run.opt.step_graph.captures
    # an epoch of two dispatches, the second traced: its kernels by name,
    # its copies, and the card's busy share (an interval union)
    cfg.ep_iter = 2 * G
    epoch = run.epoch(2)
    path = os.path.join(cuda_build.BUILD_DIR, "config_replay.json")
    trace = traced_kernels(torch, lambda: next(epoch), path)
    for _ in epoch:
        pass
    # the staging copies of an epoch of two dispatches, all in one profile
    # (the prefetcher stages ahead, so one dispatch's copies run during
    # the dispatch before it)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in run.epoch(3):
            pass
        torch.cuda.synchronize()
    path = os.path.join(cuda_build.BUILD_DIR, "config_copies.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        h2d = h2d_overlap(json.load(f)["traceEvents"])
    # what the read back costs: epochs that read each dispatch's losses as
    # it ends against epochs read once at their end, alternating which
    # goes first; each epoch's first dispatch (the loader and prefetcher
    # starting) is read and left out, and the rest timed from that read
    cfg.ep_iter = CONFIG_TIMED * G
    read_ms = {"every": [], "once": []}
    for r in range(CONFIG_READ_ROUNDS):
        order = ("every", "once") if r % 2 == 0 else ("once", "every")
        for i, how in enumerate(order):
            epoch = run.epoch(4 + 2 * r + i)
            next(epoch)["loss"].tolist()
            t0 = time.perf_counter()
            if how == "every":
                for st in epoch:
                    st["loss"].tolist()
            else:
                torch.stack([st["loss"] for st in epoch]).tolist()
            read_ms[how].append(1e3 * (time.perf_counter() - t0)
                                / (CONFIG_TIMED - 1))
    per_step = {k: v / G for k, v in trace.items() if k != "busy_share"}
    banked = dict(
        read_rounds=CONFIG_READ_ROUNDS,
        read_every_dispatch_ms=read_ms["every"],
        read_once_dispatch_ms=read_ms["once"],
        read_every_dispatch_ms_median=statistics.median(read_ms["every"]),
        read_once_dispatch_ms_median=statistics.median(read_ms["once"]),
        timed_dispatches=len(dispatch_ms), epoch_s=epoch_s,
        dispatch_ms=dispatch_ms,
        dispatch_ms_median=statistics.median(dispatch_ms),
        rays_per_s=len(dispatch_ms) * G * ds.n_rand / epoch_s,
        h2d_bytes_per_dispatch=run.staging.set_bytes,
        staging_leaves=run.staging.leaves, staging_sets=run.staging.size,
        staging_copies=run.staging.copies,
        bank_installs=run.bank.installs, bank_bytes=run.bank.nbytes,
        bank_rows=run.bank.capacity, traced_busy_share=trace["busy_share"],
        epoch_of_two_h2d=h2d, captures=captures)
    hat_state = dict(run.hat_state)
    state = (run.params, run.bn_stats, run.opt)
    del run, epoch
    torch.cuda.empty_cache()

    # the stacked path on the same pool and plan sizes
    stacked = graph_noise.config_run(cfg, ds, dev, pool, bank=False)
    stacked.hat_state.update(hat_state)
    warm_geom = [with_geom(b, m, pool.geom_cache) for b, m in warm]
    float(stacked.dispatch(warm_geom[:G])["loss"][-1])    # its capture
    cfg.ep_iter = CONFIG_TIMED * G
    s_losses, s_ms, s_epoch_s = timed_epoch(stacked.epoch(1))
    copied = sum(t.nbytes for t in tree_leaves(
        to_device(stack_batches(warm_geom[:G]), "cpu")))
    # a stacked dispatch part by part: the G batches stacked, copied to the
    # card (pageable, as StepGraph's to_device copies them), then the
    # dispatch of the copy (the graph's copy-in, its replay, the read)
    settings = stacked.settings._replace(
        hat_rows_caps=tuple(hat_state["rows_caps"]))
    stack_ms, copy_ms, replay_ms = [], [], []
    for group in (warm_geom[:G], warm_geom[G:]):
        t0 = time.perf_counter()
        on_host = stack_batches(group)
        t1 = time.perf_counter()
        on_card = to_device(on_host, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stacked.bn_stats, st = train_step_scan(
            stacked.params, stacked.bn_stats, stacked.opt, on_card, settings,
            device=dev)
        st["loss"].tolist()
        stack_ms.append(1e3 * (t1 - t0))
        copy_ms.append(1e3 * (t2 - t1))
        replay_ms.append(1e3 * (time.perf_counter() - t2))
    stacked_row = dict(
        timed_dispatches=len(s_ms), epoch_s=s_epoch_s, dispatch_ms=s_ms,
        dispatch_ms_median=statistics.median(s_ms),
        rays_per_s=len(s_ms) * G * ds.n_rand / s_epoch_s,
        h2d_bytes_per_dispatch=copied,
        stack_ms_median=statistics.median(stack_ms),
        copy_ms_median=statistics.median(copy_ms),
        device_batch_dispatch_ms_median=statistics.median(replay_ms),
        captures=stacked.opt.step_graph.captures, losses=s_losses)
    del stacked
    torch.cuda.empty_cache()

    # a batch's host parts as a worker makes it (here, one thread): the
    # JPEG decode, the rest of the sample (the rays), collate and the plan
    loader = make_data_loader(cfg, "train", dataset=ds, epoch=1,
                              hat_state=hat_state)
    spec = loader._spec()
    parts = {k: [] for k in ("decode", "rays", "collate", "plan")}
    for bi, j in enumerate(loader.indices[:CONFIG_HOST_BATCHES]):
        i, c = divmod(j, ds.n_cams)
        t0 = time.perf_counter()
        cv2.imdecode(np.frombuffer(ds._jpgs[(i, c)], np.uint8),
                     cv2.IMREAD_COLOR)
        t1 = time.perf_counter()
        np.random.seed(_batch_seed(1, bi, loader.seed0))
        sample = ds[j]
        t2 = time.perf_counter()
        batch, _ = collate([sample], ds.n_rand)
        t3 = time.perf_counter()
        apply_hat_spec(batch, spec, _batch_seed(1, bi, loader.seed0 + 1))
        t4 = time.perf_counter()
        for k, v in (("decode", t1 - t0), ("rays", t2 - t1 - (t1 - t0)),
                     ("collate", t3 - t2), ("plan", t4 - t3)):
            parts[k].append(1e3 * v)
    host_ms = {k: statistics.median(v) for k, v in parts.items()}
    # the banked warm epoch's steps, eager, from the seeded state
    eager_run = graph_noise.config_run(cfg, ds, dev, bank=False)
    bn, st = train_steps(eager_run.params, eager_run.bn_stats, eager_run.opt,
                         warm_geom, settings, device=dev)
    eager = graph_noise.run_state(eager_run.params, bn, eager_run.opt,
                                  st["loss"])
    del eager_run, state
    check, over = graph_noise.check(graph_state, eager, CONFIG_TOL)
    # the mean loss of each banked dispatch, warm and timed
    means = [statistics.mean(x) for x in
             [w.tolist() for w in warm_losses] + losses]
    want = tuple((1 + WARMUP) * G * n
                 for n in (4, 4, 2 * CONV_LAYERS, CONV_LAYERS))
    planner = ("native" if hat_planner_native._LIB is not None
               else "not loaded")
    emit(phase="config_path", config=os.path.relpath(graph_noise.CONFIG_313),
         network=cfg.network_module, renderer=cfg.renderer_module,
         trainer=cfg.trainer_module, compute_dtype=cfg.tpu.compute_dtype,
         lr=cfg.train.lr, scheduler=cfg.train.scheduler.type,
         dataset=dict(frames=ds.n_frames, cams=ds.n_cams, hw=list(ds.hw),
                      rays=ds.n_rand, out_sh=list(ds.out_sh),
                      site_caps=list(ds.site_caps)),
         workers=CONFIG_WORKERS, planner=planner,
         hat_state={k: list(v) if isinstance(v, tuple) else v
                    for k, v in hat_state.items()},
         steps_per_dispatch=G, warm_dispatches=CONFIG_WARM, warm_s=warm_s,
         banked=banked, stacked=stacked_row,
         banked_over_stacked_rays_per_s=(banked["rays_per_s"]
                                         / stacked_row["rays_per_s"]),
         replay_busy_ms=trace["busy_ms"], host_ms_per_batch=host_ms,
         host_ms_per_batch_total=sum(host_ms.values()),
         host_batches=CONFIG_HOST_BATCHES, losses=losses,
         mean_loss_per_dispatch=means, launches_at_capture=counts,
         launches_expected=want, replay_per_step=per_step, card=card)
    emit(phase="config_vs_eager", steps=CONFIG_WARM * G, tol=CONFIG_TOL,
         groups=check, over=len(over),
         graph_losses=graph_state["loss"][0][1].tolist(),
         eager_losses=eager["loss"][0][1].tolist())
    if (counts != want or captures != 1 or stacked_row["captures"] != 1
            or planner != "native"
            or per_step["hat_fwd"] != 4 or per_step["hat_bwd"] != 4
            or per_step["conv"] != 2 * CONV_LAYERS
            or not all(math.isfinite(x) for row in losses for x in row)
            or not means[-1] < means[0]
            or not banked["h2d_bytes_per_dispatch"] < CONFIG_H2D_MAX):
        failed.append(f"config_path: launches {counts} (want {want}), a "
                      f"replay's per step {per_step}, captures {captures} "
                      f"and {stacked_row['captures']}, planner {planner}, "
                      f"losses {losses}, bytes a dispatch "
                      f"{banked['h2d_bytes_per_dispatch']}")
    if over:
        failed.append(f"config_path against eager steps: {over[:5]}")
    return counts, per_step


def h2d_overlap(events):
    """The host -> device copies of a trace (chrome-trace events): their
    count, bytes, ms, and the ms of them that kernels on another stream
    covered."""
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e["name"]]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    covered = 0.0
    for c in copies:
        a, b = c["ts"], c["ts"] + c.get("dur", 0)
        spans = sorted((max(a, k["ts"]), min(b, k["ts"] + k.get("dur", 0)))
                       for k in kernels
                       if k.get("args", {}).get("stream")
                       != c.get("args", {}).get("stream"))
        end = a
        for lo, hi in spans:
            if hi > max(lo, end):
                covered += hi - max(lo, end)
                end = hi
    return dict(copies=len(copies),
                bytes=sum(e.get("args", {}).get("bytes", 0) for e in copies),
                ms=sum(e.get("dur", 0) for e in copies) / 1e3,
                covered_ms=covered / 1e3)


def fresh_bench(torch, card, pool):
    """The bench's fresh half (neuralbody_tpu_torch/bench.measure_fresh) on
    the config path's pool and dataset: a warm epoch of 2 dispatches, a
    timed epoch of FRESH_DISPATCHES, a profiled one. Returns its result."""
    from neuralbody_tpu_torch import bench as port_bench
    t0 = time.perf_counter()
    fresh = port_bench.measure_fresh(n_disp=FRESH_DISPATCHES, pool=pool)
    emit(phase="fresh_bench", seconds=time.perf_counter() - t0,
         dispatches=FRESH_DISPATCHES, steps_per_dispatch=port_bench.G,
         card=card, **fresh)
    share = fresh["fresh_device_busy_share"]
    if not (fresh["fresh_rays_per_s"] > 0 and share is not None
            and 0 < share <= 1
            and fresh["fresh_h2d_bytes_per_dispatch"] < CONFIG_H2D_MAX):
        raise AssertionError(f"fresh bench: {fresh}")
    torch.cuda.empty_cache()
    return fresh


def plan_spec(hs, out_sh, site_caps):
    """The loader's static plan sizes for a plan built on the device
    (datasets/loader.py _derive_hat_static with plan_device): n_groups and
    rows_caps from the host plan's with their margins, seg_caps from its
    d-spans."""
    from neuralbody_tpu_torch.ops.device_plan import DevicePlanSpec
    return DevicePlanSpec(
        out_sh=tuple(out_sh), site_caps=tuple(site_caps), group_size=128,
        tile=(4, 8), n_groups=-(-int(hs["n_groups"] * 1.08) // 8) * 8,
        rows_caps=tuple(-(-int(c * 1.15) // 32) * 32
                        for c in hs["rows_caps"]),
        seg_caps=tuple(-(-int(c * 1.25) // 8) * 8 for c in hs["d_spans"]))


def device_plan(torch, dev, card, rbatch, rstatic, ds, pool, failed):
    """The hat plan built on the card (ops/device_plan.py, the 313 config's
    cfg.tpu.hat_plan_device). plan_hat_device on the card against the same
    function on the CPU at the full-width batch's voxel coordinates (perm
    and rows bit for bit, no overflow), timed; the render of `rbatch` (1024
    rays, no plan) from a device plan against the host plan's render of the
    same rays at the same depths, both modes, at RENDER_TOL; then the 313
    config (bf16, banked, `pool`) with the plan on the card beside the
    host-planned one: a warm epoch of two dispatches each (the derivation
    and the capture; the device-planned one held against eager steps on
    its batches at CONFIG_TOL), then epochs of two dispatches in ABBA
    order: dispatch ms, rays/s, bytes a dispatch; and the host ms of a
    batch made without and with its plan. Returns the kernels' launches
    over the device-planned runs."""
    import numpy as np

    from neuralbody_tpu_torch.datasets.loader import (
        make_data_loader, produce_batch)
    from neuralbody_tpu_torch.models import latent_xyzc as lx
    from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu_torch.ops.device_plan import plan_hat_device
    from neuralbody_tpu_torch.ops.hat_interp import prepare_hat_batch
    from neuralbody_tpu_torch.renderer.renderer import (RenderSettings,
                                                        render_rays)
    from neuralbody_tpu_torch.tools import graph_noise
    from neuralbody_tpu_torch.train.fresh import synthetic_cfg, with_geom
    from neuralbody_tpu_torch.train.graphs import WARMUP
    from neuralbody_tpu_torch.train.step import eval_step, train_steps
    from neuralbody_tpu_torch.utils.platform import to_device

    # (a) the plan: card against CPU on one frame's voxel coordinates
    vs = (VOX,) * 3
    hat, hs = prepare_hat_batch(rbatch, rstatic["out_sh"],
                                rstatic["site_caps"], vs, N_SAMPLES,
                                d_spans=True)
    spec = plan_spec(hs, rstatic["out_sh"], rstatic["site_caps"])
    pts = (rbatch["ray_o"][0][:, None, :] + rbatch["ray_d"][0][:, None, :]
           * hat["z_vals"][0][..., None]).reshape(-1, 3)
    rev = [2, 1, 0]
    dhw = (((pts - rbatch["Th"][0].reshape(1, 3)) @ rbatch["R"][0])[:, rev]
           - rbatch["bounds"][0][0][rev]) / np.float32(VOX)
    dhw = torch.from_numpy(dhw.astype(np.float32))
    geom = {k: v[0] for k, v in rbatch["geom"].items()}
    cpu = plan_hat_device(dhw, to_device(geom, "cpu"), spec)
    gdev, ddev = to_device(geom, dev), dhw.to(dev)
    card_plan = plan_hat_device(ddev, gdev, spec)
    equal = (torch.equal(cpu[0], card_plan[0].cpu())
             and all(torch.equal(cpu[1][l], card_plan[1][l].cpu())
                     for l in cpu[1]))
    overflow = (float(cpu[2]), float(card_plan[2]))
    plan_ms = median_ms(torch, lambda: plan_hat_device(ddev, gdev, spec),
                        runs=20)

    # (b) the render from a device plan against the host plan's
    params, _ = lx.init(torch.Generator().manual_seed(SEED),
                        num_train_frame=1,
                        nv=rbatch["geom"]["vert_idx"].shape[-1], device=dev)
    params["alpha_fc"]["b"] += ALPHA_BIAS
    render_err = {}
    for mode in ("bf16", "f32"):
        s = RenderSettings(
            model=lx.ModelStatic(encoder=EncoderStatic(
                out_sh=rstatic["out_sh"], site_caps=rstatic["site_caps"],
                compute_dtype="bfloat16" if mode == "bf16" else "float32")),
            voxel_size=vs, n_samples=N_SAMPLES, perturb=False,
            hat_rows_caps=tuple(hs["rows_caps"]))
        want = eval_step(params, hat, s, device=dev)
        with torch.no_grad():
            got, _ = render_rays(params, to_device(rbatch, dev),
                                 s._replace(hat_plan=spec), train=True)
        render_err[mode] = max(
            ((got[k] - want[k]).abs().max()
             / want[k].abs().max().clamp(min=1e-30)).item()
            for k in ("rgb_map", "acc_map", "depth_map"))
        if not render_err[mode] <= RENDER_TOL[mode]:
            failed.append(f"device_plan render {mode}: {render_err[mode]} "
                          f"over {RENDER_TOL[mode]}")
    del params

    # (c) the config path with the plan on the card, beside the host plan
    G = CONFIG_G
    runs, warm = {}, {}
    counted = {}
    for way in ("host", "device"):
        c = synthetic_cfg(ds, "bfloat16", G, 2 * G)
        c.tpu.hat_plan_device = way == "device"
        run = graph_noise.config_run(c, ds, dev, pool)
        reset_kernel_counts()
        warm[way] = list(run.loader(0))
        losses = torch.cat([st["loss"] for st in run.epoch(
            0, loader=warm[way])])
        if way == "device":
            counted = kernel_counts(*HAT_CONV, "conv_dx")
            graph_state = graph_noise.run_state(run.params, run.bn_stats,
                                                run.opt, losses)
        runs[way] = (run, c)
    timed = {"host": [], "device": []}
    for r, way in enumerate(("host", "device", "device", "host")):
        run, c = runs[way]
        losses, ms, epoch_s = timed_epoch(run.epoch(1 + r))
        timed[way].append(dict(dispatch_ms=ms, epoch_s=epoch_s,
                               rays_per_s=len(ms) * G * ds.n_rand / epoch_s))
    rows = {}
    for way, (run, c) in runs.items():
        rows[way] = dict(
            h2d_bytes_per_dispatch=run.staging.set_bytes,
            staging_leaves=run.staging.leaves,
            captures=(run.opt.step_graph.captures
                      if run.opt.step_graph else 0),
            hat_state={k: list(v) if isinstance(v, tuple) else v
                       for k, v in run.hat_state.items()},
            dispatch_ms_median=statistics.median(
                x for t in timed[way] for x in t["dispatch_ms"]),
            rays_per_s=[t["rays_per_s"] for t in timed[way]])
    # the device-planned warm epoch against eager steps on its batches
    run, c = runs["device"]
    settings = run._settings({})
    eager_run = graph_noise.config_run(c, ds, dev, bank=False)
    eager_run.generator.manual_seed(eager_run.seed)   # the epoch-0 draws
    bn, st = train_steps(eager_run.params, eager_run.bn_stats,
                         eager_run.opt,
                         [with_geom(b, m, pool.geom_cache)
                          for b, m in warm["device"]], settings, device=dev,
                         generator=eager_run.generator)
    eager = graph_noise.run_state(eager_run.params, bn, eager_run.opt,
                                  st["loss"])
    check, over = graph_noise.check(graph_state, eager, CONFIG_TOL)
    # (d) a batch's host ms with its plan and without (the loader's thread)
    host_ms = {}
    loader = make_data_loader(c, "train", dataset=ds, epoch=1,
                              hat_state=run.hat_state)
    for way, spec_ in (("host", loader._spec()), ("device", None)):
        ms = []
        for bi in range(CONFIG_HOST_BATCHES):
            t0 = time.perf_counter()
            produce_batch(ds, loader.indices, bi, 1, ds.n_rand, spec_, 1,
                          loader.seed0)
            ms.append(1e3 * (time.perf_counter() - t0))
        host_ms[way] = statistics.median(ms)
    del runs, run, eager_run
    torch.cuda.empty_cache()
    want = tuple((1 + WARMUP) * G * n
                 for n in (4, 4, 2 * CONV_LAYERS, CONV_LAYERS))
    emit(phase="device_plan", plan_bit_equal=equal, overflow=overflow,
         spec=spec._asdict(), plan_ms_per_step=plan_ms,
         render_err=render_err, render_tol=RENDER_TOL, config=rows,
         timed=timed, host_ms_per_batch=host_ms,
         launches_at_capture=counted, launches_expected=want,
         config_vs_eager=dict(tol=CONFIG_TOL, groups=check, over=len(over)),
         card=card)
    if not equal or overflow != (0.0, 0.0):
        failed.append(f"device_plan: card plan equal {equal}, overflow "
                      f"{overflow}")
    if (counted != want or rows["device"]["captures"] != 1
            or not rows["device"]["h2d_bytes_per_dispatch"]
            < rows["host"]["h2d_bytes_per_dispatch"]):
        failed.append(f"device_plan config path: launches {counted} (want "
                      f"{want}), {rows}")
    if over:
        failed.append(f"device_plan against eager steps: {over[:5]}")
    return counted


def dist_two_ranks(torch, card, failed):
    """Two ranks of the sharded steps on the one card
    (neuralbody_tpu_torch/tools/dist_check.py, full width): NCCL when it
    takes two ranks on one device, else gloo on CUDA tensors. Held: the
    ranks' parameters bit for bit; each group of the sharded run's state
    and of batch mode's within DIST_TOL of one process's, and both planted
    faults over it in both layouts; ShardedEval of 8192 rays within
    RENDER_TOL of eval_step; every rank's hat and conv launches. Returns
    each kernel's launches over both ranks' sharded steps, by mode."""
    from neuralbody_tpu_torch.tools import dist_check
    from neuralbody_tpu_torch.utils import cuda_build
    out = os.path.join(cuda_build.BUILD_DIR, "dist_check")
    t0 = time.perf_counter()
    refused = None
    # NCCL has refused two ranks on one device in every version tried: its
    # attempt runs beside gloo's, and gloo's result stands where it refuses
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        gloo = pool.submit(dist_check.launch, DIST_WORLD, "gloo", "full",
                           out, timeout=900)
        try:
            results, _ = dist_check.launch(DIST_WORLD, "nccl", "full",
                                           out + "_nccl", timeout=240)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            lines = [x for x in str(e).splitlines()
                     if "Duplicate GPU" in x or "ncclInvalidUsage" in x]
            if not lines:
                raise
            refused = lines[0].strip()[:300]
            results = None
        gloo_results, _ = gloo.result()
    results = results or gloo_results
    seconds = time.perf_counter() - t0
    r0 = results[0]
    want = {"hat_fwd": 4 * dist_check.STEPS, "hat_bwd": 4 * dist_check.STEPS,
            "conv": 2 * CONV_LAYERS * dist_check.STEPS,
            "conv_dx": CONV_LAYERS * dist_check.STEPS}
    rows, launches = {}, {}
    for mode, row in r0["modes"].items():
        same = all(r["modes"][mode][k] == row[k] for r in results
                   for k in ("digest", "eval_digest", "batch_digest"))
        tol = DIST_TOL[mode]
        ratios = {g: row["vs_single"][g] / tol[g] for g in tol}
        batch_ratios = {g: row["batch_vs_single"][g] / tol[g] for g in tol}
        # each planted fault's worst group over its tolerance: must be > 1
        faults = {f"{lay}/{name}": max(dist[g] / tol[g] for g in tol)
                  for lay, key in (("rays", "faults"),
                                   ("batch", "batch_faults"))
                  for name, dist in row[key].items() if name != "stale_path"}
        launches[mode] = {k: sum(r["modes"][mode]["launches"][k]
                                 for r in results) for k in want}
        rows[mode] = dict(
            ranks_bit_equal=same, loss=row["loss"],
            single_loss=row["single_loss"], vs_single=row["vs_single"],
            spread=row["spread"], ratio_to_tol=ratios,
            batch_vs_single=row["batch_vs_single"],
            batch_ratio_to_tol=batch_ratios, fault_ratio_to_tol=faults,
            stale_path=row["faults"]["stale_path"], eval_err=row["eval_err"],
            step_ms=[r["modes"][mode]["step_ms"] for r in results],
            collective_ms=[r["modes"][mode]["collective_ms"]
                           for r in results],
            collective_bytes=row["collective_bytes"],
            collective_calls=row["collective_calls"],
            launches=[r["modes"][mode]["launches"] for r in results])
        if (not same or max(ratios.values()) > 1
                or max(batch_ratios.values()) > 1
                or not min(faults.values()) > 1
                or not row["eval_err"] <= RENDER_TOL[mode]
                or any(r["modes"][mode]["launches"] != want
                       for r in results)):
            failed.append(f"dist_two_ranks {mode}: {rows[mode]}")
    emit(phase="dist_two_ranks", backend=r0["backend"], nccl_refused=refused,
         world=DIST_WORLD, n_groups=r0["n_groups"], seconds=seconds,
         steps=dist_check.STEPS, tol=DIST_TOL, launches_expected=want,
         modes=rows, card=card)
    return launches


def dist_entry(torch, card, root, work, failed):
    """The port's train_net under torchrun's variables (RANK=0
    WORLD_SIZE=1 NB_DIST_AUTO=1, NCCL) over the fake ZJU sequence at
    `root`: one epoch of one dispatch (bf16, G = 8, the loader's thread)
    and a validate, in a process of its own. Held: exit 0, the group it
    formed, latest.ckpt written, a finite PSNR."""
    import glob
    import shutil
    import socket

    from neuralbody_tpu_torch.train.fresh import CONFIG_313
    cwd = os.path.join(work, "dist_entry")
    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    data = []
    for split in ("train", "test"):
        data += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.human", os.path.basename(root),
                 f"{split}_dataset.ann_file", f"{root}/annots.npy"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NB_", "LOCAL_RANK"))}
    here = os.path.dirname(os.path.abspath(__file__))
    env.update(RANK="0", WORLD_SIZE="1", NB_DIST_AUTO="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [env.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "neuralbody_tpu_torch.train_net",
           "--cfg_file", CONFIG_313, "training_view", "[0, 1, 2]",
           "test.frame_sampler_interval", "1", *data,
           "num_train_frame", str(TRAINER_FRAMES),
           "tpu.compute_dtype", "bfloat16", "tpu.steps_per_dispatch", "8",
           "train.num_workers", "0", "ep_iter", "8", "train.epoch", "1",
           "exp_name", "dist_entry"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    group = [x for x in proc.stdout.splitlines()
             if x.startswith("process group:")]
    psnr = [float(x.split()[-1]) for x in proc.stdout.splitlines()
            if x.startswith("psnr:")]
    ckpts = sorted(os.path.relpath(p, cwd) for p in glob.glob(
        os.path.join(cwd, "data", "trained_model", "**", "*.ckpt"),
        recursive=True))
    emit(phase="dist_entry", returncode=proc.returncode, seconds=seconds,
         group=group, psnr=psnr, checkpoints=ckpts, card=card)
    if (proc.returncode != 0
            or group != ["process group: rank 0 of 1, backend nccl"]
            or not any(p.endswith("latest.ckpt") for p in ckpts)
            or not psnr or not all(math.isfinite(x) for x in psnr)):
        failed.append(f"dist_entry: rc {proc.returncode}, group {group}, "
                      f"psnr {psnr}, checkpoints {ckpts}: {text[-3000:]}")


def kernel_counts(*names):
    """Every hand kernel's launch counter: hat forward, hat backward, conv
    (all), conv dx, dense products, dense column sums, the dense products
    by route with those that carried an epilogue, and the site sampler's
    kernel with its plain version's calls. With names, just those counters
    as a tuple."""
    from neuralbody_tpu_torch.ops import (conv_kernel, dense_kernel,
                                          hat_kernel, site_sample_kernel)
    counts = dict(hat_fwd=hat_kernel.LAUNCHES,
                  hat_bwd=hat_kernel.BWD_LAUNCHES,
                  conv=conv_kernel.CONV_LAUNCHES,
                  conv_dx=conv_kernel.CONV_DX_LAUNCHES,
                  dense=dense_kernel.MM_LAUNCHES,
                  dense_sum=dense_kernel.SUM_LAUNCHES,
                  routes=dict(dense_kernel.ROUTE_LAUNCHES,
                              epilogue=dense_kernel.EPILOGUE_LAUNCHES),
                  site=site_sample_kernel.LAUNCHES,
                  site_plain=site_sample_kernel.PLAIN_CALLS)
    return tuple(counts[n] for n in names) if names else counts


# the counters that the latent_xyzc phases hold to their expected launches
HAT_CONV = ("hat_fwd", "hat_bwd", "conv")


def reset_kernel_counts():
    from neuralbody_tpu_torch.ops import (conv_kernel, dense_kernel,
                                          hat_kernel, site_sample_kernel)
    hat_kernel.LAUNCHES = hat_kernel.BWD_LAUNCHES = 0
    site_sample_kernel.LAUNCHES = site_sample_kernel.PLAIN_CALLS = 0
    conv_kernel.CONV_LAUNCHES = conv_kernel.CONV_DX_LAUNCHES = 0
    dense_kernel.MM_LAUNCHES = dense_kernel.SUM_LAUNCHES = 0
    dense_kernel.EPILOGUE_LAUNCHES = 0
    for route in dense_kernel.ROUTE_LAUNCHES:
        dense_kernel.ROUTE_LAUNCHES[route] = 0


def trainer_cfg(path, root, out, opts):
    """make_cfg of a shipped YAML over the fake ZJU sequence at `root`
    (views 0-2 train, view 3 tests, every frame of the YAML's
    num_train_frame tested), its checkpoints, records and results under
    `out`."""
    from neuralbody_tpu_torch.config import make_cfg
    data = []
    for split in ("train", "test"):
        data += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.human", os.path.basename(root),
                 f"{split}_dataset.ann_file", f"{root}/annots.npy"]
    cfg = make_cfg(path, opts=["training_view", "[0, 1, 2]",
                               "test.frame_sampler_interval", "1",
                               *data, *opts])
    for k in ("trained_model_dir", "record_dir", "result_dir"):
        cfg[k] = os.path.join(out, k)
    return cfg


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def trainer_fit(torch, dev, card, root, out, failed, fresh=None,
                opts=()):
    """The training harness (train/trainer.Trainer) on the 313 config in
    bf16 as shipped (G = 8, Adam with its exponential schedule), over the
    fake ZJU sequence at `root` (TRAINER_FRAMES frames, 1024^2 images that
    the config's ratio halves), two loader workers: fit() of two epochs of
    TRAINER_DISPATCHES dispatches (save_ep 1, eval_ep 2), then validate()
    timed on the test view's frames; a second Trainer resumes from
    latest.ckpt (its begin epoch, recorder step, params, BN stats and
    moments against the first's, bit for bit); then the first Trainer's
    epochs timed with the YAML's log_interval (every dispatch read back)
    and with one read at the epoch's end, beside the bench's fresh half
    (`fresh`, measured in this run), and the loader alone over as many
    batches; then a resume into the first Trainer (in place: no new
    capture) and one more epoch. Returns the launches of fit and of
    validate."""
    import shutil

    from neuralbody_tpu_torch.train.fresh import CONFIG_313
    from neuralbody_tpu_torch.train.optimizer import tree_leaves
    from neuralbody_tpu_torch.train.trainer import Trainer
    shutil.rmtree(out, ignore_errors=True)
    G = 8
    cfg = trainer_cfg(CONFIG_313, root, out, [
        "num_train_frame", str(TRAINER_FRAMES),
        "tpu.compute_dtype", "bfloat16", "tpu.steps_per_dispatch", str(G),
        "train.num_workers", str(CONFIG_WORKERS),
        "ep_iter", str(TRAINER_DISPATCHES * G), "train.epoch", "2",
        "save_ep", "1", "save_latest_ep", "1", "eval_ep", "2",
        "exp_name", "smoke_fit", *opts])
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    init_s = time.perf_counter() - t0
    with torch.no_grad():
        trainer.params["alpha_fc"]["b"] += ALPHA_BIAS
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        trainer.fit()
        sync(torch, dev)
        fit_s = time.perf_counter() - t0
        fit_counts = kernel_counts()
        run = trainer.run
        captures = run.opt.step_graph.captures if run.opt.step_graph else 0
        ckpts = sorted(os.listdir(cfg.trained_model_dir))
        state = [x.clone() for x in tree_leaves(
            [trainer.params, trainer.bn_stats, trainer.opt.mu,
             trainer.opt.nu])]
        step = trainer.recorder.step
        reset_kernel_counts()
        t0 = time.perf_counter()
        metrics = trainer.validate()
        sync(torch, dev)
        val_s = time.perf_counter() - t0
        val_counts = kernel_counts()
        images = len(trainer.test_dataset)

        # a second Trainer resumes from latest.ckpt
        second = Trainer(cfg, device=dev)
        begin = second.resume()
        resumed = tree_leaves([second.params, second.bn_stats,
                               second.opt.mu, second.opt.nu])
        equal = len(resumed) == len(state) and all(
            torch.equal(a, b) for a, b in zip(state, resumed))
        second_step = second.recorder.step
        del second, resumed

        # the Trainer's epochs timed: the YAML's log_interval (every
        # dispatch read back) and one read at the end (log_interval past
        # the epoch)
        timed = {}
        cfg.ep_iter = TRAINER_TIMED * G
        for epoch, (what, interval) in enumerate(
                (("every_dispatch", cfg.log_interval),
                 ("epoch_end", 10 ** 9)), start=2):
            cfg.log_interval = interval
            sync(torch, dev)
            t0 = time.perf_counter()
            trainer.train_epoch(epoch)
            sync(torch, dev)
            s = time.perf_counter() - t0
            timed[what] = dict(epoch_s=s, dispatch_ms=1e3 * s / TRAINER_TIMED,
                               rays_per_s=TRAINER_TIMED * G * cfg.N_rand / s)
        # the loader alone over as many batches (the pool's workers)
        t0 = time.perf_counter()
        n = sum(1 for _ in trainer.run.loader(5))
        loader_s = time.perf_counter() - t0
        timed["loader_only"] = dict(batches=n, epoch_s=loader_s,
                                    ms_per_dispatch=1e3 * loader_s * G / n)
        # a resume into the same Trainer copies into the tensors the graph
        # captured: the next epoch replays it
        trainer.resume()
        trainer.train_epoch(4)
        sync(torch, dev)
        captures_after = (run.opt.step_graph.captures
                          if run.opt.step_graph else 0)
        losses = trainer.recorder.scalars["loss"]
        emit(phase="trainer_fit", config=os.path.relpath(CONFIG_313),
             compute_dtype=cfg.tpu.compute_dtype, steps_per_dispatch=G,
             frames=TRAINER_FRAMES, workers=CONFIG_WORKERS,
             dispatches_per_epoch=TRAINER_DISPATCHES, init_s=init_s,
             fit_s=fit_s, fit_launches=fit_counts, captures=captures,
             captures_after_resume=captures_after, checkpoints=ckpts,
             validate_images=images, validate_ms_per_image=1e3 * val_s
             / max(images, 1), validate_launches=val_counts,
             metrics=metrics, resume_begin_epoch=begin,
             resume_step=second_step, step=step,
             resume_bit_equal=equal, timed=timed,
             fresh_bench_dispatch_ms=(
                 None if fresh is None else 1e3 * G * cfg.N_rand
                 / fresh["fresh_rays_per_s"]),
             loss_median=losses.median, tensorboard_writer=trainer
             .recorder.has_writer, card=card)
        if (captures != 1 or captures_after != 1
                or not {"latest.ckpt", "0.ckpt", "1.ckpt"} <= set(ckpts)
                or not math.isfinite(metrics["psnr"])
                or not 0 <= metrics["ssim"] <= 1 or images < 4
                or begin != 2 or second_step != step or not equal
                or not all(fit_counts[k] > 0 for k in
                           ("hat_fwd", "hat_bwd", "conv", "conv_dx"))
                or not val_counts["conv"] > 0):
            failed.append(f"trainer_fit: captures {captures} and "
                          f"{captures_after}, checkpoints {ckpts}, metrics "
                          f"{metrics} over {images} images, resume at "
                          f"{begin} step {second_step} of {step}, equal "
                          f"{equal}, launches {fit_counts} {val_counts}")
    finally:
        trainer.close()
    return fit_counts, val_counts


def trainer_nerf(torch, dev, card, root, out, failed, opts=()):
    """The NeRF baseline through the harness: nerf_313.yaml (D=8, W=256,
    64 + 128 samples, f32, the perturbation on) over the same sequence,
    one epoch of NERF_STEPS eager steps (one dispatch: the graph takes
    latent_xyzc's hat batches only), then validate() on the test view.
    Held: the masked MSE of the epoch's first batch, rendered by eval_step
    (deterministic) before and after the epoch, falls (the steps' own
    losses are of eight different batches, perturbed). Returns the
    launches of fit and of validate."""
    import shutil

    from neuralbody_tpu_torch.train.step import eval_step, masked_mse
    from neuralbody_tpu_torch.train.trainer import Trainer
    from neuralbody_tpu_torch.utils.platform import to_device
    shutil.rmtree(out, ignore_errors=True)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "nerf", "nerf_313.yaml")
    cfg = trainer_cfg(path, root, out, [
        "tpu.steps_per_dispatch", str(NERF_STEPS), "train.num_workers", "0",
        "ep_iter", str(NERF_STEPS), "train.epoch", "1", "log_interval",
        "1", "exp_name", "smoke_nerf", *opts])
    trainer = Trainer(cfg, device=dev)
    try:
        with torch.no_grad():
            for net in ("coarse", "fine"):
                trainer.params[net]["alpha_linear"]["b"] += NERF_ALPHA_BIAS
        losses = []
        dispatch = trainer.run.dispatch_staged

        def recording(staged):
            stats = dispatch(staged)
            losses.extend(stats["loss"].tolist())
            return stats

        trainer.run.dispatch_staged = recording
        first, _ = next(iter(trainer.run.loader(0)))

        def first_loss():
            ret = eval_step(trainer.params, first, trainer.run.settings,
                            device=dev)
            b = to_device(first, dev)
            return masked_mse(ret["rgb_map"], b["rgb"], b["ray_mask"]).item()

        before = first_loss()
        reset_kernel_counts()
        t0 = time.perf_counter()
        trainer.fit()
        sync(torch, dev)
        fit_s = time.perf_counter() - t0
        fit_counts = kernel_counts()
        after = first_loss()
        reset_kernel_counts()
        t0 = time.perf_counter()
        metrics = trainer.validate()
        sync(torch, dev)
        val_s = time.perf_counter() - t0
        val_counts = kernel_counts()
        images = len(trainer.test_dataset)
        graphed = trainer.opt.step_graph is not None
        emit(phase="trainer_nerf", config=os.path.relpath(path),
             steps=len(losses), losses=losses, fit_s=fit_s,
             first_batch_loss_before=before, first_batch_loss_after=after,
             step_ms=1e3 * fit_s / max(len(losses), 1),
             fit_launches=fit_counts, validate_images=images,
             validate_ms_per_image=1e3 * val_s / max(images, 1),
             validate_launches=val_counts, metrics=metrics,
             graphed=graphed, card=card)
        if (len(losses) != NERF_STEPS or graphed
                or not all(map(math.isfinite, losses))
                or not after < before
                or not fit_counts["dense"] > 0
                or not val_counts["dense"] > 0 or images < 1
                or not math.isfinite(metrics["psnr"])
                or not 0 <= metrics["ssim"] <= 1):
            failed.append(f"trainer_nerf: losses {losses}, the first "
                          f"batch's {before} -> {after}, launches "
                          f"{fit_counts} {val_counts}, metrics {metrics}, "
                          f"graphed {graphed}")
    finally:
        trainer.close()
    return fit_counts, val_counts


def quality_short(torch, dev, card, work, failed):
    """The port's first trained model, cut short: the convergence tool's
    entry (tools/convergence_run.main) at full width for QUALITY_EPOCHS
    epochs of 250 steps (f32, G = 8, two loader workers, the shaded
    fixture at 512^2: 5 training views, 1 held out, 6 frames) with an eval
    after each; the held-out PSNR after the last must reach
    QUALITY_MIN_PSNR. Then tools/novel_pose_eval.main from its checkpoint
    on the two unseen poses: finite PSNR, SSIM in [0, 1]. Returns the
    convergence run's workdir and the launches of its training."""
    import shutil

    from neuralbody_tpu_torch.tools import convergence_run, novel_pose_eval
    shutil.rmtree(work, ignore_errors=True)
    conv = os.path.join(work, "convergence")
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = convergence_run.main([
        "--epochs", str(QUALITY_EPOCHS), "--eval-every", "1",
        "--workdir", conv, "--out", os.path.join(work, "quality.json")])
    sync(torch, dev)
    conv_s = time.perf_counter() - t0
    counts = kernel_counts()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "QUALITY_r05.json")) as f:
        jax_psnr = {c["step"]: c["psnr"] for c in json.load(f)["curve"]}
    t0 = time.perf_counter()
    pose = novel_pose_eval.main([
        "--train-workdir", conv, "--workdir", os.path.join(work, "novel"),
        "--out", os.path.join(work, "novelpose.json")])
    pose_s = time.perf_counter() - t0
    last = out["curve"][-1]
    emit(phase="quality_short", epochs=out["epochs"], steps=out["steps"],
         curve=out["curve"], jax_tpu_psnr_at=[
             jax_psnr.get(c["step"]) for c in out["curve"]],
         min_psnr=QUALITY_MIN_PSNR, train_s=out["train_s"],
         train_rays_per_s=out["train_rays_per_s"], tool_s=conv_s,
         launches=counts, novel_pose=pose, novel_pose_s=pose_s, card=card)
    if (out["epochs"] != QUALITY_EPOCHS or len(out["curve"]) !=
            QUALITY_EPOCHS or not math.isfinite(last["psnr"])
            or not last["psnr"] >= QUALITY_MIN_PSNR
            or not 0 <= last["ssim"] <= 1
            or not math.isfinite(pose["value"])
            or not 0 <= pose["ssim"] <= 1
            or not all(counts[k] > 0 for k in
                       ("hat_fwd", "hat_bwd", "conv", "conv_dx"))):
        failed.append(f"quality_short: curve {out['curve']} (at least "
                      f"{QUALITY_MIN_PSNR} dB), novel pose {pose}, "
                      f"launches {counts}")
    return conv, counts


def link_checkpoint(cwd, cfg, trained):
    """Make cfg.trained_model_dir (relative: data/trained_model/<task>/
    <exp_name>, where run.py looks) under `cwd` point at `trained`."""
    link = os.path.join(cwd, cfg.trained_model_dir)
    os.makedirs(os.path.dirname(link), exist_ok=True)
    if not os.path.islink(link):
        os.symlink(trained, link)


def changed_files(root, before):
    """The files under `root` new or rewritten since `before` (a dict of
    path -> mtime), and the new snapshot."""
    now = {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
           for d, _, fs in os.walk(root) for f in fs}
    return sorted(p for p, t in now.items() if before.get(p) != t), now


def run_entry(torch, dev, card, work, conv, failed):
    """Every runner of neuralbody_tpu_torch/run.py over quality_short's
    checkpoint (`conv`: its workdir): evaluate (run_evaluate on the
    convergence config, perturb off) against Trainer.validate on the same
    state within EVAL_VS_VALIDATE dB; then, as a user calls it (run.main
    with the 313 YAML cut to the fixture, in a working directory whose
    data/trained_model links to the checkpoint), visualize in each mode
    (vis_novel_view: VIEWS of 50 views; vis_novel_pose: PERFORM_FRAMES
    frames; vis_rotate_smpl: the first row of 5 (one per training view) of
    the 144 indices in FrameSampler rows; vis_mesh: one frame at 5 mm,
    its first density chunk against the CPU at RENDER_TOL), light_stage on
    a sphere written with save_ply, evaluate_nv on evaluate's saved
    renders, dataset (DATASET_BATCHES batches) and network. Returns the
    launches of evaluate and of the mesh."""
    import shutil
    from contextlib import chdir

    import cv2
    import numpy as np

    from neuralbody_tpu_torch import run
    from neuralbody_tpu_torch.datasets.loader import make_data_loader
    from neuralbody_tpu_torch.datasets.samplers import frame_sampler_indices
    from neuralbody_tpu_torch.renderer import mesh as mesh_mod
    from neuralbody_tpu_torch.renderer.renderer import render_density_grid
    from neuralbody_tpu_torch.tools import convergence_run
    from neuralbody_tpu_torch.train import step as step_mod
    from neuralbody_tpu_torch.train.fresh import CONFIG_313
    from neuralbody_tpu_torch.train.trainer import Trainer
    from neuralbody_tpu_torch.utils.mesh_io import load_ply, save_ply
    from neuralbody_tpu_torch.utils.platform import to_device
    cfg = convergence_run.run_cfg(conv)
    root = cfg.train_dataset.data_root

    # evaluate against Trainer.validate on the trained state
    trainer = Trainer(cfg, device=dev)
    try:
        trainer.resume()
        t0 = time.perf_counter()
        val = trainer.validate()
        sync(torch, dev)
        val_s = time.perf_counter() - t0
    finally:
        trainer.close()
    ecfg = cfg.clone()
    ecfg.perturb = 0
    reset_kernel_counts()
    t0 = time.perf_counter()
    summary = run.run_evaluate(ecfg, dev)
    sync(torch, dev)
    eval_s = time.perf_counter() - t0
    eval_counts = kernel_counts()
    images = len(make_data_loader(cfg, "test",
                                  dataset=trainer.test_dataset))
    diff = {k: abs(summary[k] - val[k]) for k in ("psnr", "ssim")}
    emit(phase="run_evaluate", summary=summary, validate=val, diff=diff,
         tol=EVAL_VS_VALIDATE, images=images,
         ms_per_image=1e3 * eval_s / images,
         validate_ms_per_image=1e3 * val_s / images, launches=eval_counts,
         card=card)
    if (not math.isfinite(summary["psnr"]) or not 0 <= summary["ssim"] <= 1
            or not max(diff.values()) <= EVAL_VS_VALIDATE
            or not eval_counts["conv"] > 0):
        failed.append(f"run_evaluate: {summary} against validate {val}, "
                      f"launches {eval_counts}")

    # the runners as a user calls them, from a working directory
    cwd = os.path.join(work, "cwd")
    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    data = []
    for split in ("train", "test"):
        data += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.human", "CoreView_999",
                 f"{split}_dataset.ann_file", f"{root}/annots.npy"]
    # the 313 YAML with the convergence config's sizes and data
    keys = ("exp_name", "H", "W", "ratio", "num_train_frame",
            "training_view", "N_rand", "N_samples", "voxel_size", "nv",
            "tpu.chunk_rays", "test.frame_sampler_interval")
    common = ["--cfg_file", CONFIG_313, *data, *(
        x for k in keys for x in (k, str(cfg.get_path(k))))]
    link_checkpoint(cwd, run.setup(["--type", "evaluate", *common])[0],
                    os.path.join(conv, "trained"))
    modes = {
        "vis_novel_view": ["num_render_views", str(VIEWS)],
        "vis_novel_pose": ["num_render_frame", str(PERFORM_FRAMES)],
        "vis_rotate_smpl": ["test.sampler", "FrameSampler",
                            "test.frame_sampler_interval",
                            str(ROTATE_INTERVAL)],
        "vis_mesh": ["test.frame_sampler_interval", "6"]}
    mesh_rows, mesh_counts, finite = [], {}, []
    extract, cubes = mesh_mod.extract_mesh, mesh_mod.marching_cubes
    render = step_mod.eval_step

    def checked(params, batch, settings, device=None):
        ret = render(params, batch, settings, device=device)
        finite.append(all(torch.isfinite(v).all().item()
                          for v in ret.values()))
        return ret

    def timed_iso(*a):
        t0 = time.perf_counter()
        out = cubes(*a)
        mesh_rows[-1]["iso_surface_ms"] = 1e3 * (time.perf_counter() - t0)
        return out

    def timed_extract(params, batch, meta, settings, mcfg, device=None):
        mesh_rows.append({})
        sync(torch, dev)
        t0 = time.perf_counter()
        out = extract(params, batch, meta, settings, mcfg, device=device)
        total = 1e3 * (time.perf_counter() - t0)
        # the path's launches, before the comparison below adds its own
        mesh_rows[-1]["launches"] = kernel_counts()
        chunk = int(mcfg.tpu.mesh_pt_chunk)
        first = dict(to_device(batch, "cpu"),
                     pts=torch.from_numpy(batch["pts"][:, :chunk]))
        with torch.no_grad():
            card_a = render_density_grid(
                params, to_device(first, dev), settings, pt_chunk=chunk)
            cpu_a = render_density_grid(
                to_device(params, "cpu"), first, settings, pt_chunk=chunk)
        err = (card_a.cpu() - cpu_a).abs().max().item()
        scale = max(1.0, cpu_a.abs().max().item())
        inside = np.asarray(meta["inside"])
        mesh_rows[-1].update(
            grid_shape=list(inside.shape), inside_points=int(inside.sum()),
            chunks=batch["pts"].shape[1] // chunk, chunk=chunk,
            extract_ms=total,
            density_ms=total - mesh_rows[-1]["iso_surface_ms"],
            V=len(out["vertices"]), T=len(out["triangles"]),
            first_chunk_err=err, first_chunk_scale=scale,
            cube_finite=bool(np.isfinite(out["cube"]).all()))
        return out

    rows = {}
    with chdir(cwd):
        before = changed_files(cwd, {})[1]
        for mode, extra in modes.items():
            if mode == "vis_mesh":
                mesh_mod.extract_mesh = timed_extract
                mesh_mod.marching_cubes = timed_iso
                reset_kernel_counts()
            step_mod.eval_step = checked
            finite.clear()
            try:
                t0 = time.perf_counter()
                n = run.main(["--type", "visualize", *common, mode, "True",
                              *extra])
                sync(torch, dev)
                s = time.perf_counter() - t0
            finally:
                mesh_mod.extract_mesh = extract
                mesh_mod.marching_cubes = cubes
                step_mod.eval_step = render
            if mode == "vis_mesh" and mesh_rows:
                mesh_counts = mesh_rows[0]["launches"]
            files, before = changed_files(cwd, before)
            pngs = [f for f in files if f.endswith(".png")]
            shapes = {cv2.imread(f).shape for f in pngs}
            rows[mode] = dict(items=n, files=len(files), pngs=len(pngs),
                              png_shapes=sorted(shapes), renders=len(finite),
                              renders_finite=all(finite), s=s,
                              ms_per_item=1e3 * s / n)
        plys = [f for f in files if f.endswith(".ply")]
        v, f = load_ply(plys[0]) if plys else ((), None)
        V, T = len(v), 0 if f is None else len(f)
        rows["vis_mesh"].update(mesh=mesh_rows, ply_V=V, ply_T=T)

        # light_stage on a sphere's point cloud
        stage = os.path.join(work, "stage")
        os.makedirs(os.path.join(stage, "pointcloud"), exist_ok=True)
        pts = np.random.RandomState(SEED).randn(5000, 3)
        save_ply(os.path.join(stage, "pointcloud", "000.ply"),
                 0.5 * pts / np.linalg.norm(pts, axis=1, keepdims=True))
        t0 = time.perf_counter()
        npz = run.main(["--type", "light_stage", "--cfg_file", CONFIG_313,
                        "train_dataset.data_root", stage])
        occupied = [int(np.unpackbits(np.load(f)["compressed_occupancies"])
                        .sum()) for f in npz]
        rows["light_stage"] = dict(npz=len(npz), occupied=occupied,
                                   s=time.perf_counter() - t0)

        # evaluate_nv on the renders evaluate saved (comparison/frame
        # {fi:04d}_view{vi:04d}.png -> frame_{fi}/pred_{vi + 1}.jpg)
        pred = os.path.join(work, "nv_pred")
        comp = os.path.join(ecfg.result_dir, "comparison")
        n_pred = 0
        for f in sorted(os.listdir(comp)):
            if f.endswith("_gt.png"):
                continue
            fi, vi = (int(x) for x in re.findall(r"\d+", f))
            os.makedirs(os.path.join(pred, f"frame_{fi}"), exist_ok=True)
            cv2.imwrite(os.path.join(pred, f"frame_{fi}",
                                     f"pred_{vi + 1}.jpg"),
                        cv2.imread(os.path.join(comp, f)),
                        [cv2.IMWRITE_JPEG_QUALITY, 100])
            n_pred += 1
        t0 = time.perf_counter()
        nv = run.main(["--type", "evaluate_nv", *common,
                       "pred_result_dir", pred])
        rows["evaluate_nv"] = dict(preds=n_pred, summary=nv,
                                   s=time.perf_counter() - t0)

        t0 = time.perf_counter()
        batches = run.main(["--type", "dataset", *common, "ep_iter",
                            str(DATASET_BATCHES)])
        rows["dataset"] = dict(batches=batches, s=time.perf_counter() - t0)
        times = run.main(["--type", "network", *common])
        rows["network"] = dict(renders=len(times),
                               ms=[1e3 * t for t in times])
    emit(phase="run_entry", card=card, **rows)
    m = mesh_rows[0] if mesh_rows else {}
    want_pngs = {"vis_novel_view": VIEWS, "vis_novel_pose": PERFORM_FRAMES,
                 "vis_rotate_smpl": len(frame_sampler_indices(
                     144, len(cfg.training_view), ROTATE_INTERVAL))}
    if (any(rows[k]["pngs"] != n or rows[k]["renders"] != n
            or not rows[k]["renders_finite"]
            or rows[k]["png_shapes"] != [(cfg.H, cfg.W, 3)]
            for k, n in want_pngs.items())
            or len(mesh_rows) != 1 or not m["V"] > 0 or not m["T"] > 0
            or not m["cube_finite"] or (V, T) != (m["V"], m["T"])
            or not m["first_chunk_err"] <= RENDER_TOL["f32"]
            * m["first_chunk_scale"]
            or not mesh_counts.get("conv", 0) > 0
            or not occupied or not all(occupied)
            or not abs(nv["psnr"] - summary["psnr"]) <= NV_VS_EVALUATE
            or not 0 <= nv["ssim"] <= 1 or n_pred != images
            or batches != DATASET_BATCHES or not times
            or not all(t > 0 for t in times)):
        failed.append(f"run_entry: {rows}")
    return eval_counts, mesh_counts


def run_nerf(torch, dev, card, root, out, work, failed):
    """run.py over trainer_nerf's checkpoint (under `out`), so that the
    dense kernel (#7) runs from the tool entry: evaluate on one image of
    the test view and vis_mesh on one frame (the nerf_mesh network's
    coarse trunk on the 5 mm grid, iso NERF_MESH_TH; the inside points'
    density range is printed beside V and T). Returns the launches of
    evaluate and of the mesh."""
    import shutil
    from contextlib import chdir

    import numpy as np

    from neuralbody_tpu_torch import run
    from neuralbody_tpu_torch.renderer import mesh as mesh_mod
    from neuralbody_tpu_torch.utils.mesh_io import load_ply
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "nerf", "nerf_313.yaml")
    data = []
    for split in ("train", "test"):
        data += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.human", os.path.basename(root),
                 f"{split}_dataset.ann_file", f"{root}/annots.npy"]
    common = ["--cfg_file", path, "exp_name", "smoke_nerf",
              "training_view", "[0, 1, 2]", "test.frame_sampler_interval",
              str(TRAINER_FRAMES), *data]
    cwd = os.path.join(work, "cwd_nerf")
    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    link_checkpoint(cwd, run.setup(["--type", "evaluate", *common])[0],
                    os.path.join(out, "trained_model_dir"))
    counts, cube = {}, {}
    iso = mesh_mod.marching_cubes

    def recording_iso(grid, level):
        inside = grid[grid != 0]
        if inside.size:
            cube.update(points=int(inside.size), min=float(inside.min()),
                        median=float(np.median(inside)),
                        max=float(inside.max()))
        return iso(grid, level)

    with chdir(cwd):
        reset_kernel_counts()
        t0 = time.perf_counter()
        summary = run.main(["--type", "evaluate", *common])
        sync(torch, dev)
        eval_s = time.perf_counter() - t0
        counts["evaluate"] = kernel_counts()
        reset_kernel_counts()
        mesh_mod.marching_cubes = recording_iso
        try:
            t0 = time.perf_counter()
            n = run.main(["--type", "visualize", *common, "vis_mesh",
                          "True", "mesh_th", str(NERF_MESH_TH)])
            sync(torch, dev)
            mesh_s = time.perf_counter() - t0
        finally:
            mesh_mod.marching_cubes = iso
        counts["mesh"] = kernel_counts()
        mesh_dir = os.path.join(run.setup([
            "--type", "visualize", *common, "vis_mesh", "True"])[0]
            .result_dir, "mesh")
        plys = sorted(os.listdir(mesh_dir))
        v, f = load_ply(os.path.join(mesh_dir, plys[0]))
        V, T = len(v), 0 if f is None else len(f)
    emit(phase="run_nerf", summary=summary, evaluate_s=eval_s,
         mesh_frames=n, mesh_s=mesh_s, mesh_th=NERF_MESH_TH, V=V, T=T,
         inside_density=cube,
         launches=counts, card=card)
    if (not math.isfinite(summary["psnr"]) or not 0 <= summary["ssim"] <= 1
            or n != 1 or len(plys) != 1
            or not counts["evaluate"]["dense"] > 0
            or not counts["mesh"]["dense"] > 0):
        failed.append(f"run_nerf: {summary}, {n} meshes ({plys}), V {V} "
                      f"T {T}, launches {counts}")
    return counts["evaluate"], counts["mesh"]


def graph_vs_eager_trained(torch, dev, card, conv, failed):
    """Graphed bf16 steps from a trained state against eager ones: the
    "full" scene of tools/graph_noise.py (1024 rays x 64 samples, batches
    A then B, two replays of a two-step StepGraph) started from
    quality_short's checkpoint under `conv` (its params, BN stats and Adam
    state), held by graph_noise.check at TRAINED_TOL. TRAINED_GRAPH_RUNS
    correct graphed runs must pass; a stale copy (the second replay fed A)
    and mu's largest leaf negated must each read over 1; the ratio of
    params' largest leaf left at its trained value is reported."""
    from neuralbody_tpu_torch.tools import graph_noise
    ckpt = os.path.join(conv, "trained")
    t0 = time.perf_counter()
    ((_, settings, init, chains),) = graph_noise.scenes(
        dev, ["full"], "bfloat16", ckpt)
    steps, disp, stale = chains[0]
    eager = graph_noise.eager_run(dev, init, steps, settings)
    worst, over_all, state = {}, [], None
    for _ in range(TRAINED_GRAPH_RUNS):
        state = graph_noise.graph_run(dev, init, disp, settings)
        groups, over = graph_noise.check(state, eager, TRAINED_TOL)
        over_all += over
        for g, v in groups.items():
            worst[g] = max(worst.get(g, 0.0), v["ratio"])
    teeth, _ = graph_noise.check(graph_noise.graph_run(dev, init, stale,
                                                       settings),
                                 eager, TRAINED_TOL)
    stale_ratio = max(v["ratio"] for v in teeth.values())
    p0, bn0, opt0 = init()
    before = graph_noise.run_state(p0, bn0, opt0, [])
    del p0, bn0, opt0
    faults = {}
    for what, (g, path, bad) in graph_noise.mutations(state,
                                                      before).items():
        ratios, _ = graph_noise.check(bad, eager, TRAINED_TOL)
        faults[what] = dict(
            groups={k: v["ratio"] for k, v in ratios.items()}, leaf=path,
            leaf_ratio=graph_noise.ratio(dict(graph_noise.distances(
                bad, eager)[g])[path], TRAINED_TOL[g]))
    emit(phase="graph_vs_eager_trained", checkpoint=ckpt, mode="bf16",
         steps=len(steps), graph_runs=TRAINED_GRAPH_RUNS, tol=TRAINED_TOL,
         graph_worst_ratio=worst, over=over_all[:8],
         stale_copy=teeth, stale_copy_worst_ratio=stale_ratio,
         mutations=faults, seconds=time.perf_counter() - t0, card=card)
    if over_all:
        failed.append(f"graph_vs_eager_trained: graphed leaves over "
                      f"TRAINED_TOL {over_all[:8]}")
    if not stale_ratio > 1:
        failed.append(f"graph_vs_eager_trained: a stale copy within "
                      f"TRAINED_TOL (worst ratio {stale_ratio})")
    if not faults["mu"]["groups"]["mu"] > 1:
        failed.append(f"graph_vs_eager_trained: mu's largest leaf negated "
                      f"within TRAINED_TOL ({faults['mu']})")


def encoder_leaf(path):
    """Whether a leaves() path is the encoder's (its convs, BatchNorms and
    the vertex codes)."""
    return path.startswith(("xyzc_net", "vertex_code"))


class kept_volumes:
    """Within the block, the T-pose encoder's output volumes keep their
    gradient (retain_grad): `with kept_volumes(tpose_xyzc) as vols:` gives
    the list they are appended to."""

    def __init__(self, tpose_xyzc):
        self.mod, self.vols = tpose_xyzc, []

    def __enter__(self):
        self.encode = self.mod.encode_tpose_voxels

        def encode(*args):
            volumes, stats = self.encode(*args)
            for v in volumes:
                v.retain_grad()
            self.vols.extend(volumes)
            return volumes, stats
        self.mod.encode_tpose_voxels = encode
        return self.vols

    def __exit__(self, *exc):
        self.mod.encode_tpose_voxels = self.encode


def tpose_family(torch, dev, card, root, out, failed):
    """The T-pose variant at full width (f32 always, eager), over the fake
    ZJU sequence at `root` (TRAINER_FRAMES frames of TRAINER_VERTS
    vertices, 1024^2 images that the config's ratio halves) with warping
    from tools/prepare_warping.write_synthetic_warping (make_synthetic_model
    of TRAINER_VERTS vertices, posed by N(0, TPOSE_POSE_STD) poses; a grid
    at TPOSE_VSIZE), the 313 T-pose YAML (5 mm T-pose voxels, 1024 rays x
    64 samples):
      "tpose_kernel": the conv kernel against its plain version at the
        T-pose encoder's 17 layer shapes, forward (a render's) and dx (a
        training step's), at CONV_TOL of scale, timed per encode beside its
        plain version, the library yardstick, its bound and the conv
        weight gradient;
      "tpose_render": eval_step of a training batch on the card against
        the port's CPU render of the same batch and weights, at
        RENDER_TOL["f32"] of scale;
      "tpose_train": the first step's gradients on the card against the
        CPU's (GRAD_TOL["f32"]): the loss, the decoder's leaves and the
        cotangent at the encoder's output volumes (through the decode and
        both samples) at 1e-3; the encoder's leaves at the encoder's L2
        rule, 2e-2, from the card's step with the plain conv (with the
        kernel they read ~2.6e-2: this random-weight encoder magnifies the
        kernel's tf32x3 arithmetic, within 1e-5 of each layer's scale, that
        much; reported beside), an eager step timed on
        one batch, the step's parts timed apart (the profile by
        operation), then Trainer fit (two epochs of TPOSE_DISPATCHES
        dispatches, the loader's thread) and validate().
    Returns the conv kernel's numbers on this path for the kernels line."""
    import shutil

    from neuralbody_tpu_torch.config import build
    from neuralbody_tpu_torch.datasets.loader import (make_data_loader,
                                                      make_dataset)
    from neuralbody_tpu_torch.models import tpose_xyzc
    from neuralbody_tpu_torch.ops import conv_kernel, sparse_conv
    from neuralbody_tpu_torch.tools.prepare_warping import \
        write_synthetic_warping
    from neuralbody_tpu_torch.train import optimizer
    from neuralbody_tpu_torch.train.step import (eval_step, loss_and_grads,
                                                 train_step)
    from neuralbody_tpu_torch.train.trainer import Trainer
    from neuralbody_tpu_torch.utils.platform import to_device
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_warping(root, TRAINER_FRAMES, n_verts=TRAINER_VERTS,
                            ptot_vsize=TPOSE_VSIZE, pose_std=TPOSE_POSE_STD,
                            seed=SEED, device=dev)
    warp_s = time.perf_counter() - t0
    G = 8
    cfg = trainer_cfg(TPOSE_CONFIG, root, out, [
        "num_train_frame", str(TRAINER_FRAMES),
        "tpu.steps_per_dispatch", str(G), "train.num_workers", "0",
        "ep_iter", str(TPOSE_DISPATCHES * G), "train.epoch", "2",
        "save_ep", "1", "save_latest_ep", "1", "eval_ep", "100",
        "exp_name", "smoke_tpose"])
    t0 = time.perf_counter()
    ds = make_dataset(cfg, "train")
    static = build("model_static", cfg.network_module, cfg, ds)
    settings = build("renderer", cfg.renderer_module, cfg, static)
    batch, _ = next(iter(make_data_loader(cfg, "train", dataset=ds)))
    data_s = time.perf_counter() - t0
    init_fn, _ = build("network", cfg.network_module, cfg)

    def fresh(device=dev):
        params, bn = init_fn(torch.Generator().manual_seed(SEED),
                             device=device)
        with torch.no_grad():
            params["alpha_fc"]["b"] += ALPHA_BIAS
        return params, bn

    params, _ = fresh()
    batch_dev = to_device(batch, dev)
    n_rays = batch["ray_o"].shape[1]
    emit(phase="tpose_data", config=TPOSE_CONFIG, warping_s=warp_s,
         data_s=data_s, out_sh=list(static.encoder.out_sh),
         site_caps=list(static.encoder.site_caps),
         ptot_shape=list(static.ptot_shape),
         warp_points=math.prod(static.ptot_shape), rays=n_rays,
         samples=settings.n_samples, compute_dtype=cfg.tpu.compute_dtype,
         encoder_dtype=static.encoder.compute_dtype, card=card)
    if static.encoder.compute_dtype != "float32":
        failed.append(f"tpose: the encoder runs in "
                      f"{static.encoder.compute_dtype}, not f32")

    # -- tpose_kernel: every conv a render and a training step hand the
    # wrapper, against the plain version
    conv_launch, calls = sparse_conv.sparse_conv, []

    def recorder(T, idx, W, dx=False):
        calls.append((T, idx, W))
        return conv_launch(T, idx, W, dx=dx)

    sparse_conv.sparse_conv = recorder
    try:
        reset_kernel_counts()
        ret = eval_step(params, batch_dev, settings, device=dev)
        render_counts = kernel_counts("conv", "conv_dx")
        fwd = list(calls)
        calls.clear()
        p0, _ = fresh()
        with kept_volumes(tpose_xyzc) as card_vols:
            card_step = loss_and_grads(p0, batch_dev, settings)
        step_fwd, dx = calls[:CONV_LAYERS], calls[CONV_LAYERS:]
        n_step = len(calls)
    finally:
        sparse_conv.sparse_conv = conv_launch
    calls.clear()
    torch.cuda.synchronize()
    if (len(fwd) != CONV_LAYERS or n_step != 2 * CONV_LAYERS
            or render_counts != (CONV_LAYERS, 0)):
        raise AssertionError(f"tpose: {len(fwd)} render convs and {n_step} "
                             f"step convs, counters {render_counts}")
    conv = {}
    for kind, layers in (("fwd", fwd), ("dx", dx)):
        tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bound_ms=0.0, weight_grad_ms=0.0)
        by = {"bytes": 0.0, "operations": 0.0}
        shapes = []
        for layer, (T, idx, W) in enumerate(layers):
            if T.dtype != torch.float32:
                raise AssertionError(f"tpose {kind} {layer}: {T.dtype}")
            out_k = conv_kernel.sparse_conv(T, idx, W)
            ref = conv_kernel.sparse_conv_plain(T, idx, W)
            torch.cuda.synchronize()
            err = (out_k - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not (scale > 0 and err <= CONV_TOL * scale):
                raise AssertionError(f"tpose conv kernel {kind} layer "
                                     f"{layer}: err {err} at scale {scale}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            bound = conv_bound(torch, T, idx, W, "f32")
            by[bound["bound_by"]] += bound["bound_ms"]
            tot["bound_ms"] += bound["bound_ms"]
            tot["ms"] += median_ms(torch, lambda: conv_kernel.sparse_conv(
                T, idx, W), runs=10)
            tot["plain_ms"] += median_ms(
                torch, lambda: conv_kernel.sparse_conv_plain(T, idx, W),
                runs=5)
            tot["library_ms"] += median_ms(
                torch, lambda: library_conv(torch, T, idx, W), runs=5)
            if kind == "dx":
                Tf, idx_f, _ = step_fwd[CONV_LAYERS - 1 - layer]
                S_in = idx.shape[-1]
                x = (Tf if idx_f.shape[-2] == 27 else
                     Tf[..., :S_in, Tf.shape[-1] // 3:
                        2 * Tf.shape[-1] // 3])
                tot["weight_grad_ms"] += median_ms(
                    torch, lambda: sparse_conv._weight_grad(
                        x, conv_kernel.gather_rows(T, idx)), runs=5)
            shapes.append(dict(n_rows=T.shape[-2], E=T.shape[-1],
                               K=idx.shape[-2], S=idx.shape[-1],
                               Cout=W.shape[2], max_abs_err=err,
                               max_rel_err=err / scale))
        tot["bound_by"] = max(by, key=by.get)
        if kind == "fwd":
            del tot["weight_grad_ms"]
        conv[kind] = tot
        emit(phase="tpose_kernel", direction=kind, mode="f32", layers=shapes,
             tol_rel=CONV_TOL, card=card, **tot)
    del fwd, dx, step_fwd

    # -- tpose_render: the card against the CPU, one training batch
    t0 = time.perf_counter()
    ref = eval_step(to_device(params, "cpu"), batch, settings, device="cpu")
    cpu_s = time.perf_counter() - t0
    render_ms = median_ms(torch, lambda: eval_step(params, batch_dev,
                                                   settings, device=dev),
                          runs=5, warmup=1)
    errs = {}
    for k in ("rgb_map", "acc_map", "depth_map"):
        errs[k] = (ret[k].cpu() - ref[k]).abs().max().item()
        scale = max(1.0, ref[k].abs().max().item())
        if not errs[k] <= RENDER_TOL["f32"] * scale:
            raise AssertionError(f"tpose render vs the CPU {k}: err "
                                 f"{errs[k]} (scale {scale})")
    emit(phase="tpose_render", rays=n_rays, max_abs_err=errs,
         tol_rel=RENDER_TOL["f32"], mean_acc=ret["acc_map"].mean().item(),
         render_ms=render_ms, conv_launches=render_counts[0],
         cpu_render_s=cpu_s, card=card)
    if not ret["acc_map"].mean().item() > 0:
        failed.append("tpose render: every ray empty")

    # -- tpose_train: the first step's gradients against the CPU's
    t0 = time.perf_counter()
    p_cpu, _ = fresh("cpu")
    batch_cpu = to_device(batch, "cpu")
    with kept_volumes(tpose_xyzc) as cpu_vols:
        cpu_loss, _, cpu_grads = loss_and_grads(p_cpu, batch_cpu, settings)
    cpu_s = time.perf_counter() - t0
    loss, _, grads = card_step

    def l2_errors(a, b):
        out = {}
        for (path, g), (_, c) in zip(leaves(a), leaves(b)):
            g, c = g.float().cpu(), c.float().cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"tpose gradient {path} not finite")
            out[path] = (g - c).norm().item() / max(c.norm().item(),
                                                    GRAD_FLOOR)
        return out

    l2 = l2_errors(grads, cpu_grads)
    # the conditioning: the card's step run again, and the CPU step with
    # the vertex codes one f32 ulp apart
    _, _, again = loss_and_grads(fresh()[0], batch_dev, settings)
    with torch.no_grad():
        p_cpu["vertex_code"].mul_(1.0 + 2.0 ** -23)
    _, _, ulp = loss_and_grads(p_cpu, batch_cpu, settings)
    run_to_run, one_ulp = l2_errors(again, grads), l2_errors(ulp, cpu_grads)
    emit(phase="tpose_grads_per_leaf", card_vs_cpu=l2,
         card_run_to_run=run_to_run, cpu_one_ulp=one_ulp)
    del again, ulp
    # the cotangent at the encoder's output (the T-pose volumes), through
    # the decode, the ray sample and the warp
    vol_l2 = [((a.grad.cpu() - b.grad).norm() / b.grad.norm()).item()
              for a, b in zip(card_vols, cpu_vols)]
    # the card's step with the plain conv in place of the kernel: the
    # encoder's leaves against the CPU's without the kernel's arithmetic,
    # which tpose_kernel holds layer by layer
    sparse_conv.sparse_conv = (lambda T, idx, W, dx=False:
                               conv_kernel.sparse_conv_plain(T, idx, W))
    try:
        _, _, plain_grads = loss_and_grads(fresh()[0], batch_dev, settings)
    finally:
        sparse_conv.sparse_conv = conv_launch
    plain_l2 = l2_errors(plain_grads, cpu_grads)
    tol = GRAD_TOL["f32"]
    worst = {part: max((v, k) for k, v in l2.items()
                       if encoder_leaf(k) == (part == "encoder"))
             for part in ("decoder", "encoder")}
    worst_plain = max((v, k) for k, v in plain_l2.items()
                      if encoder_leaf(k))
    loss_diff = loss.double().item() - cpu_loss.double().item()
    emit(phase="tpose_grads_vs_cpu", loss=loss.item(),
         cpu_loss=cpu_loss.item(), loss_diff=loss_diff, leaves=len(l2),
         worst_l2_rel=worst, volume_cotangent_l2_rel=vol_l2,
         encoder_plain_conv_worst_l2_rel=worst_plain,
         tol_l2_rel=dict(decoder=tol[0], volume_cotangent=tol[0],
                         encoder_plain_conv=tol[1]), cpu_step_s=cpu_s)
    if not (torch.isfinite(loss)
            and abs(loss_diff) <= tol[0] * abs(cpu_loss.item())
            and worst["decoder"][0] <= tol[0]
            and all(x <= tol[0] for x in vol_l2)
            and worst_plain[0] <= tol[1]):
        failed.append(f"tpose step vs the CPU step: loss {loss_diff}, "
                      f"worst leaves {worst}, volume cotangents {vol_l2}, "
                      f"encoder with the plain conv {worst_plain}")
    del plain_grads, card_vols, cpu_vols
    del card_step, cpu_grads, grads, p_cpu, p0

    # an eager step on one batch, timed; then its parts apart
    tp, tbn = fresh()
    opt = optimizer.build_optimizer(tp, lambda t: 5e-4)
    step_ms = median_ms(torch, lambda: train_step(
        tp, tbn, opt, batch_dev, settings, device=dev),
        runs=TPOSE_STEP_RUNS, warmup=1)
    busy, kernels = profile_step(torch, lambda: train_step(
        tp, tbn, opt, batch_dev, settings, device=dev), "tpose_step", "f32",
        step_ms)
    emit(phase="tpose_step", step_ms=step_ms,
         rays_per_s=1e3 * n_rays / step_ms, device_busy_ms=busy,
         launches=kernels, card=card)
    emit(phase="tpose_profile", card=card, **tpose_parts(
        torch, tp, batch_dev, settings, tpose_xyzc))
    del tp, tbn, opt

    # -- the harness: Trainer fit + validate from the YAML
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    init_s = time.perf_counter() - t0
    with torch.no_grad():
        trainer.params["alpha_fc"]["b"] += ALPHA_BIAS
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        trainer.fit()
        sync(torch, dev)
        fit_s = time.perf_counter() - t0
        fit_counts = kernel_counts()
        ckpts = sorted(os.listdir(cfg.trained_model_dir))
        cfg.log_interval = 10 ** 9
        sync(torch, dev)
        t0 = time.perf_counter()
        trainer.train_epoch(2)
        sync(torch, dev)
        epoch_s = time.perf_counter() - t0
        reset_kernel_counts()
        t0 = time.perf_counter()
        metrics = trainer.validate()
        sync(torch, dev)
        val_s = time.perf_counter() - t0
        val_counts = kernel_counts()
        images = len(trainer.test_dataset)
        run = trainer.run
        emit(phase="tpose_train", config=TPOSE_CONFIG, steps_per_dispatch=G,
             dispatches_per_epoch=TPOSE_DISPATCHES, init_s=init_s,
             fit_s=fit_s, fit_launches=fit_counts, checkpoints=ckpts,
             bank_installs=run.bank.installs, bank_rows=run.bank.capacity,
             graph_captures=0 if run.opt.step_graph is None else
             run.opt.step_graph.captures,
             epoch_dispatch_ms=1e3 * epoch_s / TPOSE_DISPATCHES,
             epoch_rays_per_s=TPOSE_DISPATCHES * G * cfg.N_rand / epoch_s,
             step_ms=step_ms, rays_per_s=1e3 * n_rays / step_ms,
             validate_images=images,
             validate_ms_per_image=1e3 * val_s / max(images, 1),
             validate_launches=val_counts, metrics=metrics,
             loss_median=trainer.recorder.scalars["loss"].median, card=card)
        if (not {"latest.ckpt", "0.ckpt", "1.ckpt"} <= set(ckpts)
                or run.bank.installs != 1 or run.opt.step_graph is not None
                or not math.isfinite(metrics["psnr"])
                or not 0 <= metrics["ssim"] <= 1 or images < 1
                or fit_counts["hat_fwd"] or fit_counts["hat_bwd"]
                or fit_counts["conv_dx"] != TPOSE_DISPATCHES * 2 * G
                * CONV_LAYERS or not val_counts["conv"] > 0):
            failed.append(f"tpose_train: checkpoints {ckpts}, bank installs "
                          f"{run.bank.installs}, metrics {metrics} over "
                          f"{images} images, launches {fit_counts} "
                          f"{val_counts}")
    finally:
        trainer.close()
    return dict(conv=conv, fit=fit_counts, validate=val_counts,
                render=render_counts)


def busy_ms(torch, fn, what):
    """The card's busy ms in one call of fn() (the union of its kernels',
    copies' and fills' intervals in a torch.profiler trace,
    tools/trace_loss.device_events and busy_share): device time, whatever
    the host's launch time."""
    from neuralbody_tpu_torch.tools.trace_loss import busy_share, device_events
    from neuralbody_tpu_torch.utils import cuda_build
    busy, _, _ = busy_share(device_events(fn, os.path.join(
        cuda_build.BUILD_DIR, f"parts_{what}.json")))
    return busy / 1e3


def tpose_parts(torch, params, batch, settings, tpose_xyzc):
    """The device ms of one T-pose training step's parts, each traced apart
    on the step's own full-width inputs (busy_ms): the encoder (the
    scatter of the codes, 17 convs with their BatchNorms, the densify)
    forward, and its backward (17 dx convs, the conv weight gradients,
    the BatchNorm backwards); the warp sample (the four T-pose volumes at
    the posed grid's T-pose coordinates) and its backward scatter into the
    T-pose volumes; the ray sample (the warped volumes at the samples'
    posed coordinates) and its backward scatter into the warped volumes;
    the decode MLP forward and backward."""
    from neuralbody_tpu_torch.renderer.tpose_renderer import \
        tpose_grid_coords
    from neuralbody_tpu_torch.ops.ray_ops import sample_along_rays
    s = settings
    m = s.model
    for p in leaves(params):
        p[1].requires_grad_(True)
    try:
        vols, _ = tpose_xyzc.encode_tpose_voxels(params, batch["geom"], m)
        vols0 = [v[0].detach().requires_grad_(True) for v in vols]
        tgc = tpose_grid_coords(batch["ptot_pts"][0], batch["tbounds"][0],
                                s.voxel_size, m.encoder.out_sh)
        warped = tpose_xyzc.warp_volumes(vols0, tgc, m.ptot_shape)
        warped0 = [w.detach().requires_grad_(True) for w in warped]
        pts, _ = sample_along_rays(batch["ray_o"][0], batch["ray_d"][0],
                                   batch["near"][0], batch["far"][0],
                                   s.n_samples)
        wpts = pts.reshape(-1, 3)
        ppts = torch.matmul(wpts - batch["Th"][0].reshape(1, 3),
                            batch["R"][0])
        pgc = ((ppts - batch["pbounds"][0][0]) / torch.tensor(
            s.ptot_vsize, device=wpts.device)) / torch.tensor(
                m.ptot_shape, dtype=torch.float32,
                device=wpts.device) * 2.0 - 1.0
        pgc = pgc.flip(-1)
        feat = tpose_xyzc.sample_warped(warped0, pgc)
        feat0 = feat.detach().requires_grad_(True)
        vdir = torch.nn.functional.normalize(wpts, dim=-1)
        raw = tpose_xyzc.decode(params, feat0, wpts, vdir,
                                batch["latent_index"][0], m)

        def back(outs, ins):
            cots = [torch.ones_like(o) for o in outs]
            return lambda: torch.autograd.grad(outs, ins, cots,
                                               retain_graph=True,
                                               allow_unused=True)

        parts = dict(
            encoder=lambda: tpose_xyzc.encode_tpose_voxels(
                params, batch["geom"], m),
            encoder_backward=back(vols, [p for _, p in leaves(params)
                                         if p.requires_grad]),
            warp_sample=lambda: tpose_xyzc.warp_volumes(vols0, tgc,
                                                        m.ptot_shape),
            warp_sample_backward=back(warped, vols0),
            ray_sample=lambda: tpose_xyzc.sample_warped(warped0, pgc),
            ray_sample_backward=back([feat], warped0),
            decode=lambda: tpose_xyzc.decode(
                params, feat0, wpts, vdir, batch["latent_index"][0], m),
            decode_backward=back([raw], [feat0] + [
                p for _, p in leaves(params) if p.requires_grad]))
        return dict(
            points=dict(warp=tgc.shape[0], rays_x_samples=wpts.shape[0]),
            **{f"{k}_ms": busy_ms(torch, fn, f"tpose_{k}")
               for k, fn in parts.items()})
    finally:
        for p in leaves(params):
            p[1].requires_grad_(False)


def nerf_family(torch, dev, card, ebatch, rbatch):
    """The NeRF baseline's phases: the dense kernel against its plain
    version on the operands of a real full-width step, the render and the
    training step through their entry points against the port's CPU
    versions, launch counts, timings and profiles. Returns the kernel's
    entries of the `kernels` line."""
    from neuralbody_tpu_torch.models import nerf
    from neuralbody_tpu_torch.ops import dense_kernel as dk
    from neuralbody_tpu_torch.renderer.volume_renderer import \
        NerfRenderSettings
    from neuralbody_tpu_torch.train import optimizer
    from neuralbody_tpu_torch.train.step import (loss_and_grads,
                                                 nerf_eval_step,
                                                 nerf_train_step)
    from neuralbody_tpu_torch.utils.platform import to_device

    st = nerf.NerfStatic()
    ray_keys = ("ray_o", "ray_d", "near", "far", "rgb", "ray_mask")
    eb = {k: ebatch[k] for k in ray_keys}      # 8192 rays, numpy
    tb = {k: rbatch[k] for k in ray_keys}      # 1024 rays
    eb_dev, tb_dev = to_device(eb, dev), to_device(tb, dev)

    def settings(chunk_rays, perturb=False):
        return NerfRenderSettings(
            model=st, model_fine=st, n_samples=N_SAMPLES,
            n_importance=N_IMPORTANCE, perturb=perturb,
            chunk_rays=chunk_rays)

    def fresh_params(device=dev):
        params, _ = nerf.init(torch.Generator().manual_seed(SEED), st, st,
                              device=device)
        for mlp in params.values():
            mlp["alpha_linear"]["b"] += NERF_ALPHA_BIAS
        return params

    # -- the kernel against its plain version on a real step's operands -----
    # one full-width step (1024 rays: 65,536 coarse and 196,608 fine points)
    # records what the MLPs' forwards and backwards hand the wrapper
    calls = []
    launch = dk.mm

    def recorder(A, B, bias=None, relu=False):
        calls.append((A, B, bias, relu))
        return launch(A, B, bias, relu)

    dk.mm = recorder
    try:
        card_step = loss_and_grads(fresh_params(), tb_dev,
                                   settings(N_RAYS))
        n_fwd = len(calls)
        # the operands of a render chunk: 2048 rays
        nerf_eval_step(fresh_params(), {k: v[:, :CHUNK_RAYS]
                                        for k, v in eb_dev.items()},
                       settings(CHUNK_RAYS), device=dev)
    finally:
        dk.mm = launch
    torch.cuda.synchronize()
    step_calls, chunk_calls = calls[:n_fwd], calls[n_fwd:]
    if len(chunk_calls) != 2 * MM_PER_MLP:
        raise AssertionError(f"a render chunk made {len(chunk_calls)} "
                             f"products, not {2 * MM_PER_MLP}")

    def kind_of(i):
        """forward products first, then the backward's dx (g [points, N]
        first) and dW (x^T [K, points] first)."""
        if i < 2 * MM_PER_MLP:
            return "fwd"
        A = step_calls[i][0]
        return "dw" if A.shape[0] < A.shape[1] else "dx"

    kinds = [kind_of(i) for i in range(len(step_calls))]
    n_kind = {k: kinds.count(k) for k in ("fwd", "dx", "dw")}
    if n_kind != {"fwd": 2 * MM_PER_MLP, "dx": 2 * (MM_PER_MLP - 1),
                  "dw": 2 * MM_PER_MLP}:
        raise AssertionError(f"a step's products: {n_kind}")

    # the layer shapes the timings below use are those the step handed over
    def layer_of(kind, A, B):
        """(points, K, N) of the forward layer a product belongs to."""
        return {"fwd": (A.shape[0], A.shape[1], B.shape[1]),
                "dx": (A.shape[0], B.shape[1], A.shape[1]),
                "dw": (A.shape[1], A.shape[0], B.shape[1])}[kind]

    for kind in n_kind:
        seen = sorted(layer_of(kind, c[0], c[1]) for c, k
                      in zip(step_calls, kinds) if k == kind)
        want = sorted((N_RAYS * per_ray, K, N)
                      for per_ray in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE)
                      for K, N, count in nerf_layers(kind)
                      for _ in range(count))
        if seen != want:
            raise AssertionError(f"a step's {kind} products: {seen}, not "
                                 f"{want}")

    def operands(A, B, mode):
        if mode == "f32":
            return A, B
        # .to keeps the strides of a dense view (the transposes of dx, dW)
        return A.to(torch.bfloat16), B.to(torch.bfloat16)

    route_err = {}

    def check(A, B, mode, what, bias=None, relu=False, **info):
        """The wrapper as the path called it (the bias and the ReLU of a
        forward layer in its epilogue) against the plain version."""
        a, b = operands(A, B, mode)
        out = dk.mm(a, b, bias, relu)
        ref = dk.mm_plain(a, b, bias, relu)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        route, splits, _ = dk.route_plan(a, b)
        emit(phase="kernel_vs_plain", kernel="dense_mm", what=what,
             mode=mode, M=A.shape[0], K=A.shape[1], N=B.shape[1],
             a_strides=list(a.stride()), b_strides=list(b.stride()),
             route=route, splits=splits, bias=bias is not None, relu=relu,
             max_abs_err=err, scale=scale, max_rel_err=err / scale
             if scale else None, tol_rel=MM_TOL, **info)
        if not (scale > 0 and err <= MM_TOL * scale):
            raise AssertionError(f"dense kernel {mode} {what} {info}: err "
                                 f"{err} at scale {scale}")
        route_err[route] = max(route_err.get(route, 0.0), err)
        return err

    def check_linear(x, w, b, relu, what, call):
        """`linear` under autograd against its plain version: the output
        against `linear_plain`, and the gradients of x, w and b for one
        cotangent against the plain products of that cotangent masked by the
        kernel's own output (an output within rounding of 0 may fall on
        either side of it in the two versions, and its whole cotangent with
        it: that is the ReLU, not the kernel)."""
        gy = torch.randn(
            (x.shape[0], w.shape[1]), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + call))
        ins = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        (before,) = kernel_counts("dense")
        y = dk.linear(*ins, relu)
        y.backward(gy)
        (after,) = kernel_counts("dense")
        if after != before + 3:
            raise AssertionError(f"linear launched {after - before} "
                                 "products, not 3")
        y = y.detach()
        gm = gy * (y > 0) if relu else gy
        ref = [dk.linear_plain(x, w, b, relu), dk.mm_plain(gm, w.t()),
               dk.mm_plain(x.t(), gm), gm.sum(0)]
        torch.cuda.synchronize()
        errs = {}
        for name, o, r in zip(("out", "dx", "dw", "db"),
                              [y] + [t.grad for t in ins], ref):
            scale = r.abs().max().item()
            errs[name] = (o - r).abs().max().item()
            if not (scale > 0 and errs[name] <= MM_TOL * scale):
                raise AssertionError(
                    f"linear {what} call {call} {name}: err {errs[name]} at "
                    f"scale {scale}")
            errs[name + "_rel"] = errs[name] / scale
        emit(phase="kernel_vs_plain", kernel="dense_linear", what=what,
             call=call, M=x.shape[0], K=x.shape[1], N=w.shape[1], relu=relu,
             tol_rel=MM_TOL, **errs)
        return errs["out"]

    mm_err = {}
    for mode in ("f32", "bf16"):
        for i, (A, B, bias, relu) in enumerate(step_calls):
            key = (kinds[i], mode)
            mm_err[key] = max(mm_err.get(key, 0.0),
                              check(A, B, mode, kinds[i], bias, relu, call=i))
            if bias is not None:   # the product alone, too
                check(A, B, mode, kinds[i] + "_no_epilogue", call=i)
        for i, (A, B, bias, relu) in enumerate(chunk_calls):
            check(A, B, mode, "fwd_chunk", bias, relu, call=i)
    linear_err = 0.0
    n_relu = 0
    for what, some in (("step", step_calls[:2 * MM_PER_MLP]),
                       ("chunk", chunk_calls)):
        for i, (A, B, bias, relu) in enumerate(some):
            if bias is None:
                raise AssertionError(f"{what} forward {i} carried no bias")
            n_relu += relu
            linear_err = max(linear_err,
                             check_linear(A, B, bias, relu, what, i))
    del some, A, B, bias
    if n_relu != 2 * 2 * (st.depth + 1):
        raise AssertionError(f"{n_relu} forward layers with a ReLU, not "
                             f"{st.depth + 1} per MLP application")
    for route in ("tf32x3", "fma", "rows", "cols"):
        if route not in route_err:
            raise AssertionError(f"no product of the step took the {route} "
                                 f"route: {sorted(route_err)}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pa, pb = (torch.randn((1024, 1024), generator=gen, device=dev)
              for _ in range(2))
    for mode in ("f32", "bf16"):
        check(pa, pb, mode, "probe_1024")

    # -- the render path: nerf_eval_step, 8192 rays in four chunks ----------
    params = fresh_params()
    n_chunks = EVAL_RAYS // CHUNK_RAYS
    reset_kernel_counts()
    ret = nerf_eval_step(params, eb_dev, settings(CHUNK_RAYS), device=dev)
    torch.cuda.synchronize()
    render_launches = kernel_counts("dense", "dense_sum")
    render_routes = kernel_counts()["routes"]
    if render_launches != (2 * MM_PER_MLP * n_chunks, 0):
        raise AssertionError(f"the NeRF render launched {render_launches}, "
                             f"not ({2 * MM_PER_MLP * n_chunks}, 0)")
    # every layer's bias (and ReLU) rode in its product's launch; the alpha
    # and rgb heads took the rows route, nothing the FMA loop
    want_routes = dict(fma=0, tf32x3=2 * (MM_PER_MLP - 2) * n_chunks,
                       rows=2 * 2 * n_chunks, cols=0,
                       epilogue=2 * MM_PER_MLP * n_chunks)
    if render_routes != want_routes:
        raise AssertionError(f"the NeRF render's routes {render_routes}, "
                             f"not {want_routes}")
    maps = MAPS + ("rgb0", "disp0", "acc0", "z_std")
    for k in maps:
        want = (1, EVAL_RAYS, 3) if k in ("rgb_map", "rgb0") else (
            1, EVAL_RAYS)
        if tuple(ret[k].shape) != want or not torch.isfinite(ret[k]).all():
            raise AssertionError(f"NeRF render {k}: shape "
                                 f"{tuple(ret[k].shape)} or not finite")
    # four one-chunk renders: the same kernels on the same shapes
    for c in range(n_chunks):
        sl = slice(c * CHUNK_RAYS, (c + 1) * CHUNK_RAYS)
        one = nerf_eval_step(params, {k: v[:, sl] for k, v in eb_dev.items()},
                             settings(CHUNK_RAYS), device=dev)
        for k in maps:
            if not torch.equal(one[k], ret[k][:, sl]):
                raise AssertionError(f"NeRF render {k}: chunk {c} of the "
                                     "four-chunk render differs from its "
                                     "one-chunk render")
    t0 = time.perf_counter()
    ref = nerf_eval_step(to_device(params, "cpu"),
                         {k: v[:, :CHUNK_RAYS] for k, v in eb.items()},
                         settings(CHUNK_RAYS), device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {}
    for k in maps:
        errs[k] = (ret[k][:, :CHUNK_RAYS].cpu() - ref[k]).abs().max().item()
        scale = max(1.0, ref[k].abs().max().item())
        if errs[k] > NERF_TOL * scale:
            raise AssertionError(f"NeRF render vs the CPU, {k}: err "
                                 f"{errs[k]} (scale {scale})")
    emit(phase="nerf_render_vs_cpu", rays=EVAL_RAYS, chunks=n_chunks,
         compared_rays=CHUNK_RAYS, mm_launches=render_launches[0],
         routes=render_routes,
         max_abs_err=errs, tol_rel=NERF_TOL,
         mean_acc=ret["acc_map"].mean().item(),
         mean_acc0=ret["acc0"].mean().item(),
         chunks_equal_one_chunk_renders=True, cpu_render_s=cpu_s)
    del ret, ref, one

    # -- the training path ----------------------------------------------------
    # the first step's loss and every gradient leaf against the CPU step,
    # beside the CPU step's own conditioning: the same step with the first
    # layer's weights of both MLPs one f32 ulp apart
    def leaf_errors(grads, ref):
        """{leaf: (max |g - ref| / max |ref|, |g - ref|_2 / |ref|_2)}."""
        out = {}
        for (path, g), (_, c) in zip(leaves(grads), leaves(ref)):
            g = g.cpu()
            if not (torch.isfinite(g).all() and c.abs().max() > 0):
                raise AssertionError(f"NeRF gradient {path}: not finite, or "
                                     "the reference's is zero")
            out[path] = ((g - c).abs().max().item() / c.abs().max().item(),
                         (g - c).norm().item() / c.norm().item())
        return out

    def worst(errs, i):
        path = max(errs, key=lambda k: errs[k][i])
        return [path, errs[path][i]]

    t0 = time.perf_counter()
    tb_cpu = to_device(tb, "cpu")
    cpu_loss, _, cpu_grads = loss_and_grads(fresh_params("cpu"), tb_cpu,
                                            settings(N_RAYS))
    cpu_s = time.perf_counter() - t0
    p_ulp = fresh_params("cpu")
    with torch.no_grad():
        for mlp in p_ulp.values():
            mlp["pts_linears"][0]["w"].mul_(1.0 + 2.0 ** -23)
    _, _, ulp_grads = loss_and_grads(p_ulp, tb_cpu, settings(N_RAYS))
    ulp = leaf_errors(ulp_grads, cpu_grads)
    del p_ulp, ulp_grads
    loss, _, grads = card_step
    # the card's step with every product through the plain version: the same
    # elementwise kernels, only the products' sums in another order
    dk.mm = dk.mm_plain
    try:
        _, _, plain_grads = loss_and_grads(fresh_params(), tb_dev,
                                           settings(N_RAYS))
    finally:
        dk.mm = launch
    order = leaf_errors(grads, to_device(plain_grads, "cpu"))
    emit(phase="nerf_conditioning", cpu_one_ulp_worst_max=worst(ulp, 0),
         cpu_one_ulp_worst_l2=worst(ulp, 1),
         card_kernel_vs_card_plain_worst_max=worst(order, 0),
         card_kernel_vs_card_plain_worst_l2=worst(order, 1))
    del plain_grads
    errs = leaf_errors(grads, cpu_grads)
    loss_rel = abs(loss.item() - cpu_loss.item()) / cpu_loss.item()
    emit(phase="nerf_grads_vs_cpu", loss=loss.item(),
         cpu_loss=cpu_loss.item(), loss_rel_err=loss_rel, leaves=len(errs),
         worst_max_rel_err=worst(errs, 0), worst_l2_rel_err=worst(errs, 1),
         tol_loss=NERF_TOL, tol_max_rel=NERF_GRAD_TOL[0],
         tol_l2_rel=NERF_GRAD_TOL[1], cpu_step_s=cpu_s)
    emit(phase="nerf_grads_per_leaf", max_rel_and_l2_rel=errs)
    if not (loss_rel <= NERF_TOL
            and worst(errs, 0)[1] <= NERF_GRAD_TOL[0]
            and worst(errs, 1)[1] <= NERF_GRAD_TOL[1]):
        raise AssertionError(f"NeRF step vs the CPU step: loss {loss_rel}, "
                             f"worst leaves {worst(errs, 0)}, "
                             f"{worst(errs, 1)}")
    del card_step, cpu_grads, grads, calls, step_calls, chunk_calls

    # ten steps on one batch, the perturbation and the importance draw on
    def schedule():
        return optimizer.make_lr_schedule(LR, "exponential", ep_iter=EP_ITER,
                                          gamma=0.1, decay_epochs=1000)

    tp = fresh_params()
    opt = optimizer.build_optimizer(tp, schedule())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s_train = settings(N_RAYS, perturb=True)
    per_step_want = (sum(n_kind.values()), n_kind["dw"])
    reset_kernel_counts()
    per_step, losses = [], []
    for _ in range(TRAIN_STEPS):
        before = kernel_counts("dense", "dense_sum")
        stats = nerf_train_step(tp, opt, tb_dev, s_train, device=dev,
                                generator=gen)
        losses.append(stats["loss"].item())
        per_step.append(tuple(
            a - b for a, b in zip(kernel_counts("dense", "dense_sum"),
                                  before)))
    torch.cuda.synchronize()
    train_launches = kernel_counts("dense", "dense_sum")
    train_routes = kernel_counts()["routes"]
    finite = all(torch.isfinite(p).all() for _, p in leaves(tp))
    emit(phase="nerf_train", steps=TRAIN_STEPS, lr=LR, losses=losses,
         launches_per_step=per_step[0], launches=train_launches,
         routes=train_routes, products_per_step=n_kind,
         params_finite=bool(finite))
    # per step: 24 forwards with an epilogue; the two heads of each MLP
    # forward on rows and their dW on cols; their dx (K = 1, 3) on the FMA
    # loop; everything else on the tensor cores
    want_routes = {k: TRAIN_STEPS * v for k, v in dict(
        fma=4, tf32x3=sum(n_kind.values()) - 12, rows=4, cols=4,
        epilogue=n_kind["fwd"]).items()}
    if train_routes != want_routes:
        raise AssertionError(f"the NeRF steps' routes {train_routes}, not "
                             f"{want_routes}")
    if any(ps != per_step_want for ps in per_step):
        raise AssertionError(f"NeRF steps launched {per_step}, not "
                             f"{per_step_want} each")
    if not (finite and all(map(math.isfinite, losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"NeRF training: losses {losses}")

    # -- timings ------------------------------------------------------------
    def forced(route, fn):
        """fn() with every f32 product on one main kernel."""
        dk.FORCE_MAIN = route
        try:
            return fn()
        finally:
            dk.FORCE_MAIN = None

    def time_product(A, B, mode, bias=None, runs=5):
        """One product as the wrapper routes it, beside its plain version,
        torch.matmul and its bound. f32 operands also: the same product on
        the FMA loop (the route before the tensor cores), on the main route
        where the wrapper picks a narrow one, and, with a bias, the layer
        with the bias and the ReLU in the epilogue beside torch.addmm +
        relu."""
        a, b = operands(A, B, mode)
        t = dict(route=dk.route_plan(a, b)[0])
        t["kernel_ms"] = median_ms(torch, lambda: dk.mm(a, b), runs=runs,
                                   warmup=2)
        t["plain_ms"] = median_ms(torch, lambda: dk.mm_plain(a, b),
                                  runs=runs, warmup=2)
        # the yardstick: torch.matmul on the operands as they are (a bf16
        # product comes back in bf16)
        t["library_ms"] = median_ms(torch, lambda: torch.matmul(a, b),
                                    runs=runs, warmup=2)
        t.update(mm_bound(a, b, mode))
        if mode == "f32":
            t["fma_ms"] = forced("fma", lambda: median_ms(
                torch, lambda: dk.mm(a, b), runs=runs, warmup=2))
            if t["route"] in ("rows", "cols"):
                t["main_route_ms"] = forced("tf32x3", lambda: median_ms(
                    torch, lambda: dk.mm(a, b), runs=runs, warmup=2))
            if bias is not None:
                t["linear_ms"] = median_ms(
                    torch, lambda: dk.mm(a, b, bias, True), runs=runs,
                    warmup=2)
                t["linear_plain_ms"] = median_ms(
                    torch, lambda: dk.linear_plain(a, b, bias, True),
                    runs=runs, warmup=2)
                t["linear_library_ms"] = median_ms(
                    torch, lambda: torch.relu(torch.addmm(bias, a, b)),
                    runs=runs, warmup=2)
        return t

    # a step's 70 products, each distinct (kind, shape) timed once; and the
    # same layers' forwards at a render chunk's point counts (f32, the
    # family's type; bf16 operands are on no path: the step's kinds only)
    timing = {}
    narrow_timing = {}
    summed = ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
              "bound_fp32_cores_ms", "fma_ms", "linear_ms", "linear_plain_ms",
              "linear_library_ms")
    coarse, fine = N_SAMPLES, N_SAMPLES + N_IMPORTANCE   # points per ray
    step_points = (N_RAYS * coarse, N_RAYS * fine)
    chunk_points = (CHUNK_RAYS * coarse, CHUNK_RAYS * fine)
    for mode in ("f32", "bf16"):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        jobs = [("fwd", step_points), ("dx", step_points),
                ("dw", step_points)]
        if mode == "f32":
            jobs.append(("fwd_chunk", chunk_points))
        for kind, points in jobs:
            tot = dict.fromkeys(summed, 0.0)
            bytes_share = 0.0
            for M in points:
                for K, N, count in nerf_layers(kind):
                    x = torch.randn((M, K), generator=gen, device=dev)
                    w = torch.randn((K, N), generator=gen, device=dev) * 0.1
                    g = torch.randn((M, N), generator=gen, device=dev)
                    bias = (torch.randn(N, generator=gen, device=dev)
                            if kind.startswith("fwd") else None)
                    A, B = {"fwd": (x, w), "fwd_chunk": (x, w),
                            "dx": (g, w.t()), "dw": (x.t(), g)}[kind]
                    t = time_product(A, B, mode, bias,
                                     runs=5 if mode == "f32" else 3)
                    del x, w, g, A, B
                    emit(phase="timing", kernel="dense_mm", what=kind,
                         mode=mode, points=M, K=K, N=N, count=count,
                         card=card, **t)
                    for k in summed:
                        tot[k] += count * t.get(k, 0.0)
                    if t["bound_by"] == "bytes":
                        bytes_share += count * t["bound_ms"]
                    if t["route"] in ("rows", "cols") and kind != "fwd_chunk":
                        nt = narrow_timing.setdefault(
                            t["route"], dict.fromkeys(
                                summed + ("main_route_ms",), 0.0))
                        for k in nt:
                            nt[k] += count * t.get(k, 0.0)
            tot["ms"] = tot.pop("kernel_ms")
            tot["bound_by"] = ("bytes" if bytes_share > 0.5 * tot["bound_ms"]
                               else "operations")
            timing[(kind, mode)] = tot
            emit(phase="timing_sum", kernel="dense_mm", what=kind, mode=mode,
                 card=card, **tot)
        emit(phase="timing_sum", kernel="dense_mm", what="step", mode=mode,
             products=sum(n_kind.values()), card=card,
             **{k: sum(timing[(kind, mode)][k] for kind in
                       ("fwd", "dx", "dw"))
                for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_fp32_cores_ms", "fma_ms")})
    for route, nt in narrow_timing.items():
        emit(phase="timing_sum", kernel="dense_mm", what=f"narrow_{route}",
             mode="f32", card=card, **nt)

    # the probe's own product, and latent_xyzc's decode layers at one chunk
    # of the plan-free render (not routed through the kernel: the numbers a
    # later routing decision needs)
    decode_keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                   "bound_fp32_cores_ms", "linear_ms", "linear_library_ms")
    for mode in ("f32", "bf16"):
        emit(phase="timing", kernel="dense_mm", what="probe_1024", mode=mode,
             card=card, **time_product(pa, pb, mode))
        tot = dict.fromkeys(decode_keys, 0.0)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for K, N in DECODE_LAYERS:
            x = torch.randn((DECODE_POINTS, K), generator=gen, device=dev)
            w = torch.randn((K, N), generator=gen, device=dev) * 0.1
            bias = torch.randn(N, generator=gen, device=dev)
            check(x, w, mode, "decode_layer")
            t = time_product(x, w, mode, bias, runs=3)
            emit(phase="timing", kernel="dense_mm", what="decode_layer",
                 mode=mode, points=DECODE_POINTS, K=K, N=N, card=card, **t)
            for k in tot:
                tot[k] += t.get(k, 0.0)
        emit(phase="timing_sum", kernel="dense_mm", what="decode_chunk",
             mode=mode, points=DECODE_POINTS, layers=len(DECODE_LAYERS),
             card=card, **tot)

    # the render and the step, in alternating rounds
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s_eval = settings(CHUNK_RAYS)

    def run(what):
        if what == "render":
            nerf_eval_step(params, eb_dev, s_eval, device=dev)
        else:
            nerf_train_step(tp, opt, tb_dev, s_train, device=dev,
                            generator=gen)

    times, _ = interleaved_ms(torch, run, ("render", "step"), NERF_ROUNDS,
                              RENDERS_PER_ROUND)
    for what, rays in (("render", EVAL_RAYS), ("step", N_RAYS)):
        med = statistics.median(times[what])
        q1, _, q3 = statistics.quantiles(times[what], n=4)
        torch.cuda.reset_peak_memory_stats()
        run(what)
        torch.cuda.synchronize()
        emit(phase=f"nerf_{what}_timing", rays=rays, ms=med, ms_q1=q1,
             ms_q3=q3, rays_per_s=rays / med * 1e3,
             us_per_ray=1e3 * med / rays, runs=len(times[what]),
             dense_kernel_ms=(
                 n_chunks * timing[("fwd_chunk", "f32")]["linear_ms"]
                 if what == "render" else
                 timing[("fwd", "f32")]["linear_ms"]
                 + sum(timing[(k, "f32")]["ms"] for k in ("dx", "dw"))),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
        profile_step(torch, lambda: run(what), f"nerf_{what}", "f32", med)

    # -- the kernels' entries: one training step's products by kind (f32,
    # the family's type), launches from the render's and the ten steps' runs.
    # bound_ms counts an f32 product as three TF32 products on the tensor
    # cores; bound_fp32_cores_ms is the figure of the f32 CUDA cores.
    source = "neuralbody_tpu_torch/csrc/dense_mm.cu"
    names = {"fwd": "dense_mm", "dx": "dense_mm_dx", "dw": "dense_mm_dw"}
    out = []
    for kind, kname in names.items():
        t = timing[(kind, "f32")]
        n = TRAIN_STEPS * n_kind[kind]
        if kind == "fwd":
            n += render_launches[0]
        out.append({
            "name": f"{kname}[f32]", "route": "cuda", "source": source,
            "replaces": MM_REPLACES, "launches": n,
            "max_abs_err": mm_err[(kind, "f32")],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "bound_fp32_cores_ms": t["bound_fp32_cores_ms"],
            "fma_route_ms": t["fma_ms"]})
    if sum(k["launches"] for k in out) != (render_launches[0]
                                           + train_launches[0]):
        raise AssertionError("the kernel's launches by kind do not add up "
                             f"to the counts {render_launches}, "
                             f"{train_launches}")
    # of those launches: the forwards as the path makes them, with the bias
    # and the ReLU in the epilogue (library: torch.addmm + relu), and the
    # products that took a narrow route (N = 1, 3: the two heads)
    t = timing[("fwd", "f32")]
    out.append({
        "name": "dense_linear[f32]", "route": "cuda", "source": source,
        "replaces": MM_REPLACES,
        "launches": render_routes["epilogue"] + train_routes["epilogue"],
        "max_abs_err": linear_err, "ms": t["linear_ms"],
        "plain_ms": t["linear_plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["linear_library_ms"],
        "bound_fp32_cores_ms": t["bound_fp32_cores_ms"],
        "subset_of": "dense_mm[f32]"})
    for route, parent in (("rows", "dense_mm[f32]"),
                          ("cols", "dense_mm_dw[f32]")):
        nt = narrow_timing[route]
        out.append({
            "name": f"dense_narrow_{route}[f32]", "route": "cuda",
            "source": source, "replaces": MM_REPLACES,
            "launches": render_routes[route] + train_routes[route],
            "max_abs_err": route_err[route], "ms": nt["kernel_ms"],
            "plain_ms": nt["plain_ms"], "bound_ms": nt["bound_ms"],
            "bound_by": "bytes", "library_ms": nt["library_ms"],
            "main_route_ms": nt["main_route_ms"], "subset_of": parent})
    return out


def nerf_layers(kind):
    """(K, N, count) of the dense products of one application of the NeRF
    MLP (D=8, W=256, skip at 4): forward x [M, K] @ w [K, N]; dx and dW
    are listed by the forward layer's (K, N); the first layer has no dx."""
    layers = [(63, 256, 1), (256, 256, 7), (319, 256, 1), (256, 1, 1),
              (283, 128, 1), (128, 3, 1)]   # 6 trunk + feature_linear
    if kind == "dx":
        layers = layers[1:]
    return layers


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neuralbody_tpu_torch.models import latent_xyzc as lx
    from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu_torch.ops import (conv_kernel, dense_kernel,
                                          hat_interp, hat_kernel,
                                          site_sample_kernel, sparse_conv)
    from neuralbody_tpu_torch.renderer.renderer import (RenderSettings,
                                                        render_density_grid)
    from neuralbody_tpu_torch import bench as port_bench
    from neuralbody_tpu_torch.tools import graph_noise
    from neuralbody_tpu_torch.train import optimizer
    from neuralbody_tpu_torch.train.graphs import (WARMUP, RenderGraph,
                                                   StepGraph)
    from neuralbody_tpu_torch.train.step import (eval_step, loss_and_grads,
                                                 scan_slice, train_step,
                                                 train_step_scan, train_steps)
    from neuralbody_tpu_torch.utils import cuda_build
    from neuralbody_tpu_torch.utils.platform import to_device
    from neuralbody_tpu_torch.utils.synthetic import make_batch

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    name = torch.cuda.get_device_name(0)
    emit(phase="card", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    dev = torch.device("cuda")
    modes = ("bf16", "f32")

    # -- 2. build: one nvcc call per source, all started together -----------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for job in [pool.submit(hat_kernel.build),
                    pool.submit(conv_kernel.build),
                    pool.submit(dense_kernel.build),
                    pool.submit(site_sample_kernel.build)]:
            job.result()
    emit(phase="build",
         sources={"neuralbody_tpu_torch/csrc/hat_interp.cu":
                  ["hat_interp_level_cuda (lookup, scan)",
                   "hat_interp_level_bwd_cuda (fixed order: scan, row "
                   "sums)"],
                  "neuralbody_tpu_torch/csrc/sparse_conv.cu":
                  ["sparse_conv_cuda (tensor cores: bf16 mma.sync and "
                   "tf32x3, the reduction split over the blocks of a "
                   "cluster)"],
                  "neuralbody_tpu_torch/csrc/dense_mm.cu":
                  ["dense_mm_cuda (tf32x3, fma, narrow rows, narrow "
                   "columns; bias and ReLU epilogue)"],
                  "neuralbody_tpu_torch/csrc/site_sample.cu":
                  ["site_trilinear_cuda (the four levels' site samples, "
                   "one launch a chunk)"]},
         seconds=time.perf_counter() - t0)
    # the conv kernel's machine code: tensor-core instructions in both modes
    hmma = {}
    for fn, n in sass_counts(cuda_build.library_path(
            "sparse_conv", [conv_kernel.SOURCE]),
            "sparse_conv_mma_kernel").items():
        cout = fn.split("Li")[1].split("E")[0]
        hmma[f"{'bf16' if 'nv_bfloat16' in fn else 'f32'}[Cout={cout}]"] = n
    emit(phase="sass", library="sparse_conv", kernel="sparse_conv_mma_kernel",
         hmma_instructions=hmma)
    if (len(hmma) != 2 * len(conv_kernel._COUTS)
            or not all(hmma.values())):
        raise AssertionError(f"conv kernel's HMMA instructions: {hmma}")

    # -- the full-width batches and weights ---------------------------------
    t0 = time.perf_counter()
    batch, static = make_batch(n_rays=N_RAYS, n_verts=6890, voxel_size=VOX,
                               seed=SEED, hat=True, n_samples=N_SAMPLES,
                               hat_perturb=False)
    hs = static["hat"]
    emit(phase="batch", path="render", host_seconds=time.perf_counter() - t0,
         out_sh=list(static["out_sh"]), site_caps=list(static["site_caps"]),
         n_groups=hs["n_groups"], group_size=hs["group_size"],
         rows_caps=list(hs["rows_caps"]))
    t0 = time.perf_counter()
    # the training batch A, and B (another ray set) for graph_vs_eager
    (tbatch, tbatch2), tstatic = graph_noise.batch_pair(
        N_RAYS, 6890, VOX, N_SAMPLES, SEED)
    ths = tstatic["hat"]
    emit(phase="batch", path="train", host_seconds=time.perf_counter() - t0,
         n_groups=ths["n_groups"], rows_caps=list(ths["rows_caps"]))
    # the plan-free render's batch: rays only, with source views to cull
    # against; and the 1024 rays of the hat render without their plan
    t0 = time.perf_counter()
    ebatch, estatic = make_batch(n_rays=EVAL_RAYS, n_verts=6890,
                                 voxel_size=VOX, seed=SEED, hat=False,
                                 num_views=HULL_VIEWS)
    rbatch, _ = make_batch(n_rays=N_RAYS, n_verts=6890, voxel_size=VOX,
                           seed=SEED, hat=False)
    emit(phase="batch", path="eval", host_seconds=time.perf_counter() - t0,
         rays=EVAL_RAYS, chunk_rays=CHUNK_RAYS, hull_views=HULL_VIEWS,
         out_sh=list(estatic["out_sh"]), site_caps=list(estatic["site_caps"]))

    def fresh_params(device=dev):
        params, stats = lx.init(torch.Generator().manual_seed(SEED),
                                num_train_frame=1, device=device)
        params["alpha_fc"]["b"] += ALPHA_BIAS
        return params, stats

    params, _ = fresh_params()
    batch_dev = to_device(batch, dev)
    tbatch_dev = to_device(tbatch, dev)
    tbatch2_dev = to_device(tbatch2, dev)
    ebatch_dev = to_device(ebatch, dev)
    rbatch_dev = to_device(rbatch, dev)

    def settings(mode, plan=hs):
        return RenderSettings(
            model=lx.ModelStatic(encoder=EncoderStatic(
                out_sh=static["out_sh"], site_caps=static["site_caps"],
                compute_dtype="bfloat16" if mode == "bf16" else "float32")),
            voxel_size=(VOX,) * 3, hat_rows_caps=plan["rows_caps"])

    def eval_settings(mode, site, hull_views=HULL_VIEWS):
        return RenderSettings(
            model=lx.ModelStatic(encoder=EncoderStatic(
                out_sh=estatic["out_sh"], site_caps=estatic["site_caps"],
                compute_dtype="bfloat16" if mode == "bf16" else "float32")),
            voxel_size=(VOX,) * 3, n_samples=N_SAMPLES,
            chunk_rays=CHUNK_RAYS, hull_views=hull_views, site_interp=site)

    def schedule():
        return optimizer.make_lr_schedule(LR, "exponential", ep_iter=EP_ITER,
                                          gamma=0.1, decay_epochs=1000)

    # -- 3. kernels vs plain on the main paths' own level inputs ------------
    # one render per mode records what the renderer hands the forward
    # wrapper; one training step per mode what its backward hands kernel #2
    level_inputs = {mode: [] for mode in modes}
    bwd_inputs = {mode: [] for mode in modes}
    launch, bwd_launch = (hat_interp.hat_interp_level,
                          hat_interp.hat_interp_level_bwd)

    def recorder(feats, sites, rows, pos, out=None):
        level_inputs[mode].append((feats, sites, rows, pos))
        return launch(feats, sites, rows, pos, out=out)

    def bwd_recorder(grad, sites, rows, pos, dtype, sorted_rows=None):
        bwd_inputs[mode].append((grad, sites, rows, pos, dtype))
        return bwd_launch(grad, sites, rows, pos, dtype, sorted_rows)

    # and every conv the encoder hands the conv wrapper: the render's 17
    # forward convs, and the 17 dx convs that the training step's backward
    # runs after its own 17 forward ones
    conv_launch = sparse_conv.sparse_conv
    conv_calls = []

    def conv_recorder(T, idx, W, dx=False):
        conv_calls.append((T, idx, W))
        return conv_launch(T, idx, W, dx=dx)

    card_grads = {}
    conv_inputs = {mode: {} for mode in modes}
    step_fwd_convs = {}  # the training step's forward convs (dW's inputs)
    hat_interp.hat_interp_level = recorder
    sparse_conv.sparse_conv = conv_recorder
    try:
        for mode in modes:
            conv_calls.clear()
            eval_step(params, batch_dev, settings(mode), device=dev)
            conv_inputs[mode]["fwd"] = list(conv_calls)
        hat_interp.hat_interp_level = launch
        hat_interp.hat_interp_level_bwd = bwd_recorder
        for mode in modes:
            p0, _ = fresh_params()
            conv_calls.clear()
            card_grads[mode] = loss_and_grads(p0, tbatch_dev,
                                              settings(mode, ths))
            if len(conv_calls) != 2 * CONV_LAYERS:
                raise AssertionError(
                    f"{mode} step: {len(conv_calls)} convs, not "
                    f"{CONV_LAYERS} forward and {CONV_LAYERS} dx")
            conv_inputs[mode]["dx"] = conv_calls[CONV_LAYERS:]
            step_fwd_convs[mode] = conv_calls[:CONV_LAYERS]
    finally:
        hat_interp.hat_interp_level = launch
        hat_interp.hat_interp_level_bwd = bwd_launch
        sparse_conv.sparse_conv = conv_launch
    conv_calls.clear()
    torch.cuda.synchronize()

    max_err = {}
    for mode, levels in level_inputs.items():
        if len(levels) != 4:
            raise AssertionError(f"{mode}: {len(levels)} levels, not 4")
        max_err[mode] = 0.0
        for lvl, args in enumerate(levels, 1):
            want = torch.bfloat16 if mode == "bf16" else torch.float32
            if args[0].dtype != want:
                raise AssertionError(f"{mode}: features are {args[0].dtype}")
            out = hat_kernel.hat_interp_level(*args)
            ref = hat_kernel.hat_interp_level_plain(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            emit(phase="kernel_vs_plain", kernel="hat_interp_level",
                 mode=mode, level=lvl,
                 shape=dict(ngrp=args[3].shape[0], P=args[3].shape[1],
                            capR=args[2].shape[1], C=args[0].shape[1],
                            capS=args[0].shape[0]),
                 max_abs_err=err, scale=scale, max_rel_err=err / scale,
                 tol_rel=KERNEL_TOL[mode])
            if not (scale > 0 and err <= KERNEL_TOL[mode] * scale):
                raise AssertionError(f"hat kernel {mode} level {lvl}: "
                                     f"err {err} at scale {scale}")
            max_err[mode] = max(max_err[mode], err)

    bwd_err = {}
    for mode, levels in bwd_inputs.items():
        if len(levels) != 4:
            raise AssertionError(f"{mode}: {len(levels)} backward levels")
        bwd_err[mode] = 0.0
        for lvl, (grad, sites, rows, pos, dtype) in enumerate(levels, 1):
            want = torch.bfloat16 if mode == "bf16" else torch.float32
            if dtype != want or grad.is_contiguous():
                raise AssertionError(f"{mode} level {lvl}: {dtype}, the "
                                     "cotangent not a column slice")
            out = hat_kernel.hat_interp_level_bwd(grad, sites, rows, pos,
                                                  dtype)
            ref = hat_kernel.hat_interp_level_bwd_plain(grad, sites, rows,
                                                        pos, dtype)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            emit(phase="kernel_vs_plain", kernel="hat_interp_level_bwd",
                 mode=mode, level=lvl,
                 shape=dict(ngrp=pos.shape[0], P=pos.shape[1],
                            capR=rows.shape[1], C=grad.shape[2],
                            capS=sites.shape[0], row_stride=grad.stride(1)),
                 max_abs_err=err, scale=scale,
                 max_rel_err=err / scale if scale else None,
                 tol_rel=KERNEL_TOL[mode])
            if not (scale > 0 and err <= KERNEL_TOL[mode] * scale):
                raise AssertionError(f"hat backward kernel {mode} level "
                                     f"{lvl}: err {err} at scale {scale}")
            bwd_err[mode] = max(bwd_err[mode], err)

    conv_err = {}
    for mode in modes:
        want = torch.bfloat16 if mode == "bf16" else torch.float32
        for kind, layers in conv_inputs[mode].items():
            if len(layers) != CONV_LAYERS:
                raise AssertionError(f"{mode} {kind}: {len(layers)} convs")
            conv_err[(kind, mode)] = 0.0
            for layer, (T, idx, W) in enumerate(layers):
                if T.dtype != want:
                    raise AssertionError(f"{mode} {kind} {layer}: {T.dtype}")
                out = conv_kernel.sparse_conv(T, idx, W)
                ref = conv_kernel.sparse_conv_plain(T, idx, W)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
                emit(phase="kernel_vs_plain", kernel="sparse_conv",
                     direction=kind, mode=mode, layer=layer,
                     shape=dict(n_rows=T.shape[-2], E=T.shape[-1],
                                K=idx.shape[-2], S=idx.shape[-1],
                                Cout=W.shape[2]),
                     max_abs_err=err, scale=scale,
                     max_rel_err=err / scale if scale else None,
                     tol_rel=CONV_TOL)
                if not (scale > 0 and err <= CONV_TOL * scale):
                    raise AssertionError(f"conv kernel {mode} {kind} layer "
                                         f"{layer}: err {err} at scale "
                                         f"{scale}")
                conv_err[(kind, mode)] = max(conv_err[(kind, mode)], err)

    def check_maps(ret, rays, what):
        for k in MAPS:
            want = (1, rays, 3) if k == "rgb_map" else (1, rays)
            if tuple(ret[k].shape) != want or not torch.isfinite(ret[k]).all():
                raise AssertionError(f"{what} {k}: shape "
                                     f"{tuple(ret[k].shape)} or not finite")
        return {k: ret[k].cpu() for k in MAPS}

    def map_errors(ret, ref, tol, what):
        errs = {}
        for k in ("rgb_map", "acc_map", "depth_map"):
            errs[k] = (ret[k] - ref[k]).abs().max().item()
            scale = max(1.0, ref[k].abs().max().item())
            if errs[k] > tol * scale:
                raise AssertionError(f"{what} {k}: err {errs[k]} (scale "
                                     f"{scale}, tolerance {tol})")
        return errs

    # -- 4. the render path: full-width renders on the card ------------------
    launches, renders = {}, {}
    for mode in modes:
        reset_kernel_counts()
        ret = eval_step(params, batch_dev, settings(mode), device=dev)
        torch.cuda.synchronize()
        launches[("render", mode)] = kernel_counts(*HAT_CONV)
        if launches[("render", mode)] != (4, 0, CONV_LAYERS):
            raise AssertionError(f"{mode} render launched the kernels "
                                 f"{launches[('render', mode)]} times, "
                                 f"not (4, 0, {CONV_LAYERS})")
        renders[mode] = check_maps(ret, N_RAYS, f"{mode} render")

    t0 = time.perf_counter()
    ref = eval_step(to_device(params, "cpu"), batch, settings("f32"),
                    device="cpu")
    cpu_s = time.perf_counter() - t0
    for mode, ret in renders.items():
        emit(phase="render_vs_cpu", mode=mode,
             launches=launches[("render", mode)][0],
             max_abs_err=map_errors(ret, ref, RENDER_TOL[mode],
                                    f"{mode} render vs the CPU"),
             tol_rel=RENDER_TOL[mode],
             mean_acc=ret["acc_map"].mean().item(), cpu_render_s=cpu_s)

    # -- 5. the training path ----------------------------------------------
    # (b) the first step's loss and gradients against the same step run by
    # the port on the CPU (plain versions of both kernels), in f32
    def encoder_leaf(path):
        return path.startswith(("xyzc_net", "vertex_code"))

    def l2_errors(grads, ref):
        """{leaf: |grads - ref| / |ref|} over the leaves of two trees."""
        out = {}
        for (path, g), (_, c) in zip(leaves(grads), leaves(ref)):
            g, c = g.float().cpu(), c.float().cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"gradient {path} not finite")
            out[path] = (g - c).norm().item() / max(c.norm().item(),
                                                    GRAD_FLOOR)
        return out

    def worst(errs):
        return {part: max((v, k) for k, v in errs.items()
                          if encoder_leaf(k) == (part == "encoder"))
                for part in ("decoder", "encoder")}

    t0 = time.perf_counter()
    p_cpu, _ = fresh_params("cpu")
    tbatch_cpu = to_device(tbatch, "cpu")
    cpu_loss, (cpu_ret, _, _), cpu_grads = loss_and_grads(
        p_cpu, tbatch_cpu, settings("f32", ths))
    cpu_s = time.perf_counter() - t0
    # the conditioning: the CPU step with the vertex codes one f32 ulp
    # apart, and the card's f32 step run a second time
    with torch.no_grad():
        p_cpu["vertex_code"].mul_(1.0 + 2.0 ** -23)
    _, _, ulp_grads = loss_and_grads(p_cpu, tbatch_cpu, settings("f32", ths))
    p0, _ = fresh_params()
    _, _, again = loss_and_grads(p0, tbatch_dev, settings("f32", ths))
    emit(phase="conditioning", cpu_one_ulp=worst(l2_errors(ulp_grads,
                                                           cpu_grads)),
         card_run_to_run=worst(l2_errors(again, card_grads["f32"][2])))
    del ulp_grads, again, p0
    for mode in modes:
        loss, (ret, _, _), grads = card_grads[mode]
        errs = l2_errors(grads, cpu_grads)
        w = worst(errs)
        rgb_err = (ret["rgb_map"].float().cpu() - cpu_ret["rgb_map"]).abs()
        loss_diff = loss.double().item() - cpu_loss.double().item()
        target = tbatch_cpu["rgb"].double()
        mse64 = ((ret["rgb_map"].double().cpu() - target) ** 2).mean().item()
        cpu_mse64 = ((cpu_ret["rgb_map"].double() - target) ** 2).mean().item()
        emit(phase="grads_vs_cpu", mode=mode, loss=loss.item(),
             cpu_loss=cpu_loss.item(), loss_diff=loss_diff, mse64=mse64,
             cpu_mse64=cpu_mse64,
             rgb_max_abs_err=rgb_err.max().item(),
             rays_differing=int((rgb_err.amax(-1) > 0).sum()),
             leaves=len(errs), worst_l2_rel=w, tol_l2_rel=GRAD_TOL[mode],
             cpu_step_s=cpu_s)
        emit(phase="grads_per_leaf", mode=mode, l2_rel=errs)
        tol = dict(zip(("decoder", "encoder"), GRAD_TOL[mode]))
        if not (torch.isfinite(loss)
                and abs(loss_diff) <= tol["decoder"] * cpu_loss.item()
                and all(w[k][0] <= tol[k] for k in tol)):
            raise AssertionError(f"{mode} step vs the CPU step: loss "
                                 f"{loss_diff}, worst leaves {w}")
    del card_grads, cpu_grads, p_cpu

    # (a) + (c): the main training path, TRAIN_STEPS steps on one batch per
    # mode from the seeded weights, 4 forward and 4 backward hat launches
    # and 17 forward and 17 dx conv launches per step, the loss falling
    losses, dx_launches = {}, {}
    for mode in modes:
        tp, tbn = fresh_params()
        opt = optimizer.build_optimizer(tp, schedule())
        s = settings(mode, ths)
        reset_kernel_counts()
        per_step, losses[mode] = [], []
        for _ in range(TRAIN_STEPS):
            before = kernel_counts(*HAT_CONV)
            tbn, st = train_step(tp, tbn, opt, tbatch_dev, s, device=dev)
            losses[mode].append(st["loss"].item())
            per_step.append(tuple(
                a - b for a, b in zip(kernel_counts(*HAT_CONV), before)))
        torch.cuda.synchronize()
        launches[("train", mode)] = kernel_counts(*HAT_CONV)
        dx_launches[mode] = kernel_counts()["conv_dx"]
        if dx_launches[mode] != TRAIN_STEPS * CONV_LAYERS:
            raise AssertionError(f"{mode} steps launched "
                                 f"{dx_launches[mode]} dx convs, not "
                                 f"{TRAIN_STEPS * CONV_LAYERS}")
        finite = all(torch.isfinite(p).all() for _, p in leaves(tp))
        emit(phase="train", mode=mode, steps=TRAIN_STEPS, lr=LR,
             losses=losses[mode], launches_per_step=per_step[0],
             launches=launches[("train", mode)], params_finite=bool(finite))
        if any(ps != (4, 4, 2 * CONV_LAYERS) for ps in per_step):
            raise AssertionError(f"{mode} steps launched the kernels "
                                 f"{per_step} times, not (4, 4, "
                                 f"{2 * CONV_LAYERS}) each")
        if not (finite and all(map(math.isfinite, losses[mode]))
                and losses[mode][-1] < losses[mode][0]):
            raise AssertionError(f"{mode} training: losses {losses[mode]}")

    # -- 5a. the graphed paths: train_step_scan's StepGraph, RenderGraph ----
    # four steps, [A, A] then [B, B], as two replays of a two-step graph
    # from the seeded state, against one eager run of the same four steps
    # (tools/graph_noise.check at GRAPH_TOL); the same graph fed A in its
    # second replay (a stale copy) must be over that limit by STALE_MIN;
    # then three more replays of A, the last two in one profile whose
    # second is read (traced_kernels; ten steps in all). The
    # counters count at capture (the warm-up's and the capture's launches),
    # a profiled replay shows what the card runs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def clusters(convs):
        return sum(conv_kernel.split_plan(
            T.shape[0] if T.dim() == 3 else 1, idx.shape[-1], idx.shape[-2],
            T.shape[-1], T.dtype, sms) > 1 for T, idx, _ in convs)

    # what the graphed paths' checks find fails the run at its end, after
    # the phases that do not depend on them have measured
    graph_replay, eager_trace, failed = {}, {}, []
    batches_a = stack_steps(tbatch_dev, GRAPH_G)
    batches_b = stack_steps(tbatch2_dev, GRAPH_G)
    for mode in modes:
        s = settings(mode, ths)
        tp, tbn = fresh_params()
        opt = optimizer.build_optimizer(tp, schedule())
        tbn, st = train_steps(tp, tbn, opt, [tbatch_dev] * GRAPH_G
                              + [tbatch2_dev] * GRAPH_G, s, device=dev)
        eager = graph_noise.run_state(tp, tbn, opt, st["loss"])
        eager_tp, eager_tbn, eager_opt = tp, tbn, opt
        # the stale copy: A in both replays
        tp, tbn = fresh_params()
        opt = optimizer.build_optimizer(tp, schedule())
        graph, stale_losses = StepGraph(dev), []
        for batches in (batches_a, batches_a):
            tbn, st = graph(tp, tbn, opt, batches, s)
            stale_losses.append(st["loss"])
        stale, _ = graph_noise.check(graph_noise.run_state(
            tp, tbn, opt, torch.cat(stale_losses)), eager, GRAPH_TOL)
        stale_ratio = max(g["ratio"] for g in stale.values())
        emit(phase="graph_stale_copy", mode=mode, groups=stale,
             worst_ratio=stale_ratio, required=STALE_MIN)
        if not stale_ratio >= STALE_MIN:
            failed.append(f"{mode} graph fed a stale batch: worst ratio "
                          f"{stale_ratio} to GRAPH_TOL, not {STALE_MIN}")
        del graph
        tp, tbn = fresh_params()
        opt = optimizer.build_optimizer(tp, schedule())
        graph = StepGraph(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        tbn, st = graph(tp, tbn, opt, batches_a, s)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        capture_counts = kernel_counts(*HAT_CONV)
        pool_peak = torch.cuda.max_memory_allocated() - base
        graph_losses = [st["loss"]]
        tbn, st = graph(tp, tbn, opt, batches_b, s)
        graph_losses.append(st["loss"])
        state = graph_noise.run_state(tp, tbn, opt, torch.cat(graph_losses))
        groups, over = graph_noise.check(state, eager, GRAPH_TOL)
        rows = graph_noise.distances(state, eager)
        # the faults the rule must catch, made in this graphed state: mu's
        # largest leaf negated, params' largest leaf at its seeded value
        # (its distance over its own norm beside: what the rule before
        # the group scale read)
        p0, bn0 = fresh_params()
        before = graph_noise.run_state(
            p0, bn0, optimizer.build_optimizer(p0, schedule()), [])
        faults = {}
        for what, (g, path, bad) in graph_noise.mutations(
                state, before).items():
            ratios, _ = graph_noise.check(bad, eager, GRAPH_TOL)
            a = dict(bad[g])[path].double()
            b = dict(eager[g])[path].double()
            faults[what] = dict(
                groups={k: v["ratio"] for k, v in ratios.items()}, leaf=path,
                leaf_ratio=dict(graph_noise.distances(bad, eager)[g])[path]
                / GRAPH_TOL[g],
                leaf_over_own_norm=((a - b).norm()
                                    / max(a.norm(), b.norm())).item())
        del p0, bn0, before
        emit(phase="graph_mutations", mode=mode, tol=GRAPH_TOL, **faults)
        if not faults["mu"]["groups"]["mu"] > 1:
            failed.append(f"{mode} graph with mu's largest leaf negated: "
                          f"within GRAPH_TOL ({faults['mu']})")
        for _ in range(TRAIN_STEPS // GRAPH_G - 4):
            tbn, st = graph(tp, tbn, opt, batches_a, s)
            graph_losses.append(st["loss"])
        last = {"bn": tbn}

        def replay():
            last["bn"], st = graph(tp, last["bn"], opt, batches_a, s)
            graph_losses.append(st["loss"])

        replay = traced_kernels(
            torch, replay,
            os.path.join(cuda_build.BUILD_DIR, f"replay_{mode}.json"))
        tbn = last["bn"]
        graph_losses = torch.cat(graph_losses).tolist()
        eager_step = traced_kernels(
            torch, lambda: train_step(eager_tp, eager_tbn, eager_opt,
                                      tbatch_dev, s, device=dev),
            os.path.join(cuda_build.BUILD_DIR, f"eager_{mode}.json"))
        want_clusters = clusters(step_fwd_convs[mode]) + clusters(
            conv_inputs[mode]["dx"])
        per_step = {k: v / GRAPH_G for k, v in replay.items()
                    if k != "busy_share"}
        graph_replay[mode] = per_step
        eager_trace[mode] = eager_step
        emit(phase="graph_launches", mode=mode, steps_per_replay=GRAPH_G,
             replay=replay, replay_per_step=per_step, eager_step=eager_step,
             cluster_launches_planned_per_step=want_clusters,
             counters_at_capture=capture_counts, capture_s=capture_s,
             pool_peak_gb=pool_peak / 1e9, captures=graph.captures)
        if (capture_counts != tuple((1 + WARMUP) * GRAPH_G * n
                                    for n in (4, 4, 2 * CONV_LAYERS))
                or per_step["hat_fwd"] != 4 or per_step["hat_bwd"] != 4
                or per_step["conv"] != 2 * CONV_LAYERS
                or per_step["conv_cluster"] != want_clusters
                or want_clusters == 0
                or per_step["products"] != eager_step["products"]
                or eager_step["hat_fwd"] != 4 or eager_step["conv"] != 34
                or graph.captures != 1):
            failed.append(
                f"{mode} graph: counters {capture_counts}, a replay's "
                f"kernels per step {per_step}, an eager step's {eager_step}, "
                f"{want_clusters} cluster launches planned a step, "
                f"{graph.captures} captures")
        emit(phase="graph_vs_eager", mode=mode, steps=2 * GRAPH_G,
             graph_losses=graph_losses[:2 * GRAPH_G],
             eager_losses=eager["loss"][0][1].tolist(), tol=GRAPH_TOL,
             groups=groups, over=len(over))
        emit(phase="graph_vs_eager_leaves", mode=mode,
             rows={g: [(p, d) for p, d in r] for g, r in rows.items()})
        if over or not (all(map(math.isfinite, graph_losses))
                        and graph_losses[-1] < graph_losses[0]):
            failed.append(f"{mode} graph against eager steps: {over[:5]}, "
                          f"losses {graph_losses}")
        del graph, eager_tp, eager_tbn, eager_opt
        torch.cuda.empty_cache()

    render_graphs, render_replay = {}, {}
    for mode in modes:
        render_graphs[mode] = RenderGraph(dev)
        reset_kernel_counts()
        ret = render_graphs[mode](params, batch_dev, settings(mode))
        torch.cuda.synchronize()
        capture_counts = kernel_counts(*HAT_CONV)
        got = check_maps(ret, N_RAYS, f"{mode} graphed render")
        render_replay[mode] = traced_kernels(
            torch, lambda: render_graphs[mode](params, batch_dev,
                                               settings(mode)),
            os.path.join(cuda_build.BUILD_DIR, f"render_replay_{mode}.json"))
        emit(phase="graph_render_vs_eager", mode=mode,
             max_abs_err=map_errors(got, renders[mode], RENDER_TOL[mode],
                                    f"{mode} graphed render vs eval_step"),
             tol_rel=RENDER_TOL[mode], counters_at_capture=capture_counts,
             replay=render_replay[mode])
        r = render_replay[mode]
        if (capture_counts != tuple((1 + WARMUP) * n
                                    for n in (4, 0, CONV_LAYERS))
                or r["hat_fwd"] != 4
                or r["hat_bwd"] != 0 or r["conv"] != CONV_LAYERS):
            failed.append(f"{mode} graphed render: counters "
                          f"{capture_counts}, replay {r}")

    # -- 5b. the plan-free eval render: rays only, chunked, hull culling on --
    # the site branch's renders record what each chunk hands the site
    # sampler's wrapper: one kernel launch a chunk, no plain call
    branches = ("site", "dense")
    eval_renders = {}
    site_inputs = {mode: [] for mode in modes}
    site_launches = {}
    site_launch = site_sample_kernel.site_trilinear

    def site_recorder(feats, ivols, dhw, out_sh, caps):
        site_inputs[mode].append(([f.clone() for f in feats],
                                  [v.clone() for v in ivols], dhw.clone(),
                                  tuple(out_sh), tuple(caps)))
        return site_launch(feats, ivols, dhw, out_sh, caps)

    for branch in branches:
        for mode in modes:
            reset_kernel_counts()
            if branch == "site":
                site_sample_kernel.site_trilinear = site_recorder
            try:
                ret = eval_step(params, ebatch_dev,
                                eval_settings(mode, branch == "site"),
                                device=dev)
            finally:
                site_sample_kernel.site_trilinear = site_launch
            torch.cuda.synchronize()
            launches[(f"eval_{branch}", mode)] = kernel_counts(*HAT_CONV)
            if launches[(f"eval_{branch}", mode)] != (0, 0, CONV_LAYERS):
                raise AssertionError(
                    f"{mode} {branch} render launched the kernels "
                    f"{launches[(f'eval_{branch}', mode)]} times, not "
                    f"(0, 0, {CONV_LAYERS})")
            site_launches[(branch, mode)] = kernel_counts("site",
                                                          "site_plain")
            want = (EVAL_RAYS // CHUNK_RAYS if branch == "site" else 0, 0)
            if (site_launches[(branch, mode)] != want
                    or branch == "site"
                    and len(site_inputs[mode]) != want[0]):
                raise AssertionError(
                    f"{mode} {branch} render: site sampler (kernel, plain) "
                    f"{site_launches[(branch, mode)]}, recorded "
                    f"{len(site_inputs[mode])} chunks, not {want}")
            eval_renders[(branch, mode)] = check_maps(
                ret, EVAL_RAYS, f"{mode} {branch} render")
    # the kernel against its plain version on the render's own chunks
    site_err = {}
    for mode in modes:
        worst, equal = 0.0, True
        for feats, ivols, dhw, out_sh, caps in site_inputs[mode]:
            got = site_launch(feats, ivols, dhw, out_sh, caps)
            ref = site_sample_kernel.site_trilinear_plain(
                feats, ivols, dhw, out_sh, caps)
            scale = max(1.0, ref.abs().max().item())
            worst = max(worst, (got - ref).abs().max().item() / scale)
            equal = equal and torch.equal(got.view(torch.int32),
                                          ref.view(torch.int32))
        site_err[mode] = worst
        emit(phase="site_sampler_vs_plain", mode=mode,
             feature_dtype=str(site_inputs[mode][0][0][0].dtype),
             chunks=len(site_inputs[mode]),
             points=[c[2].shape[0] for c in site_inputs[mode]],
             max_rel_err=worst, tol_rel=SITE_TOL, equal_bits=equal,
             launches=site_launches[("site", mode)])
        if not worst <= SITE_TOL:
            raise AssertionError(f"{mode} site sampler kernel vs plain: "
                                 f"{worst} of scale, over {SITE_TOL}")
    params_cpu = to_device(params, "cpu")
    for branch in branches:
        t0 = time.perf_counter()
        ref = eval_step(params_cpu, ebatch,
                        eval_settings("f32", branch == "site"), device="cpu")
        cpu_s = time.perf_counter() - t0
        for mode in modes:
            ret = eval_renders[(branch, mode)]
            emit(phase="eval_render_vs_cpu", branch=branch, mode=mode,
                 rays=EVAL_RAYS, chunks=EVAL_RAYS // CHUNK_RAYS,
                 hull_views=HULL_VIEWS,
                 conv_launches=launches[(f"eval_{branch}", mode)][2],
                 max_abs_err=map_errors(ret, ref, RENDER_TOL[mode],
                                        f"{mode} {branch} render vs the CPU"),
                 tol_rel=RENDER_TOL[mode],
                 mean_acc=ret["acc_map"].mean().item(), cpu_render_s=cpu_s)
    emit(phase="site_vs_dense", mode="f32", tol_rel=SITE_DENSE_TOL,
         max_abs_err=map_errors(eval_renders[("site", "f32")],
                                eval_renders[("dense", "f32")],
                                SITE_DENSE_TOL, "site vs dense render"))
    # the hat render's 1024 rays through the site branch, no hull: the two
    # interpolations are the same function of the same unperturbed depths
    ret = check_maps(eval_step(params, rbatch_dev,
                               eval_settings("f32", True, hull_views=0),
                               device=dev), N_RAYS, "site render")
    emit(phase="site_vs_hat", mode="f32", rays=N_RAYS,
         tol_rel=RENDER_TOL["f32"],
         max_abs_err=map_errors(ret, renders["f32"], RENDER_TOL["f32"],
                                "site vs hat render"))

    # render_density_grid on one chunk of the render's own sample points
    z = torch.linspace(0.0, 1.0, N_SAMPLES)
    near, far = (torch.from_numpy(ebatch[k][0, :CHUNK_RAYS, None])
                 for k in ("near", "far"))
    pts = (torch.from_numpy(ebatch["ray_o"][0, :CHUNK_RAYS, None])
           + torch.from_numpy(ebatch["ray_d"][0, :CHUNK_RAYS, None])
           * (near * (1.0 - z) + far * z)[..., None]).reshape(1, -1, 3)
    gbatch = dict(to_device(ebatch, "cpu"), pts=pts)
    s = eval_settings("f32", False)
    with torch.no_grad():
        reset_kernel_counts()
        alpha = render_density_grid(params, to_device(gbatch, dev), s,
                                    pt_chunk=pts.shape[1])
        torch.cuda.synchronize()
        launches[("density_grid", "f32")] = kernel_counts(*HAT_CONV)
        t0 = time.perf_counter()
        ref = render_density_grid(params_cpu, gbatch, s,
                                  pt_chunk=pts.shape[1])
        cpu_s = time.perf_counter() - t0
    err = (alpha.cpu() - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    emit(phase="density_grid_vs_cpu", points=pts.shape[1], max_abs_err=err,
         scale=scale, tol_rel=RENDER_TOL["f32"],
         conv_launches=launches[("density_grid", "f32")][2],
         cpu_seconds=cpu_s)
    if (tuple(alpha.shape) != (1, pts.shape[1])
            or not torch.isfinite(alpha).all()
            or err > RENDER_TOL["f32"] * scale
            or launches[("density_grid", "f32")] != (0, 0, CONV_LAYERS)):
        raise AssertionError(f"density grid: shape {tuple(alpha.shape)}, "
                             f"err {err} at scale {scale}, launches "
                             f"{launches[('density_grid', 'f32')]}")
    del gbatch, alpha, ref, params_cpu
    emit(phase="launches", **{f"{p}_{m}": v for (p, m), v in
                              launches.items()})

    # -- 6. timings -----------------------------------------------------------
    timing = {}
    for mode, levels in level_inputs.items():
        tot = dict(ms=0.0, scan_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bound_ms=0.0)
        bound_by = set()
        c0 = 0
        buf = torch.empty((*levels[0][3].shape[:2],
                           sum(lv[0].shape[1] for lv in levels)), device=dev)
        for lvl, (feats, sites, rows, pos) in enumerate(levels, 1):
            ngrp, P, _ = pos.shape
            C = feats.shape[1]
            # the level's column slice of the [ngrp, P, 352] buffer, as the
            # path hands it over
            out = buf[..., c0:c0 + C]
            c0 += C
            k_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level(
                feats, sites, rows, pos, out=out))
            # the same kernel finding a point's rows by its scan
            hat_kernel.LOOKUP = False
            try:
                s_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level(
                    feats, sites, rows, pos, out=out))
                scan_out = out.clone()
            finally:
                hat_kernel.LOOKUP = True
            hat_kernel.hat_interp_level(feats, sites, rows, pos, out=out)
            scan_err = (scan_out - out).abs().max().item()
            scale = out.abs().max().item()
            if not scan_err <= KERNEL_TOL[mode] * scale:
                raise AssertionError(f"hat kernel {mode} level {lvl}: scan "
                                     f"and lookup differ by {scan_err} at "
                                     f"scale {scale}")
            p_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level_plain(
                feats, sites, rows, pos), runs=10)
            # yardstick: the contraction alone on materialized operands
            fpad = torch.cat([feats, feats.new_zeros((1, C))])
            rf = fpad[rows.long()]
            hat = materialized_hat(torch, sites, rows, pos).to(feats.dtype)
            l_ms = median_ms(torch, lambda: torch.bmm(hat, rf))
            del fpad, rf, hat
            b_ms, by, nbytes, ops = hat_bound(
                torch, rows, pos, C, feats.shape[0], feats.element_size(),
                hat_nonzeros(torch, sites, rows, pos), mode, 4 * ngrp * P * C)
            bound_by.add(by)
            emit(phase="timing", kernel="hat_interp_level", mode=mode,
                 level=lvl, capR=rows.shape[1], C=C, kernel_ms=k_ms,
                 scan_ms=s_ms, scan_vs_lookup_max_abs=scan_err,
                 mean_listed_rows=(rows < feats.shape[0]).sum(1).float()
                 .mean().item(), plain_ms=p_ms, library_ms=l_ms,
                 bound_ms=b_ms, bound_by=by, bytes=nbytes, ops=ops,
                 card=card)
            for k, v in (("ms", k_ms), ("scan_ms", s_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bound_ms", b_ms)):
                tot[k] += v
        tot["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "bytes"
        timing[("fwd", mode)] = tot
        emit(phase="timing_sum", kernel="hat_interp_level", mode=mode,
             levels=len(levels), card=card, **tot)

    # the backward as a step runs it: one sort of the four levels' row ids
    # (sort_ms), then the level's two kernels; ms is their sum
    for mode, levels in bwd_inputs.items():
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        bound_by = set()
        plan = [(rows, sites.shape[0]) for _, sites, rows, _, _ in levels]
        srt = hat_kernel.sort_rows(plan)
        tot["sort_ms"] = median_ms(torch, lambda: hat_kernel.sort_rows(plan))
        tot["ms"] += tot["sort_ms"]
        for lvl, ((grad, sites, rows, pos, dtype), srt_l) in enumerate(
                zip(levels, srt), 1):
            ngrp, P, C = grad.shape
            capS = sites.shape[0]
            k_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level_bwd(
                grad, sites, rows, pos, dtype, srt_l))
            p_ms = median_ms(torch, lambda: (
                hat_kernel.hat_interp_level_bwd_plain(grad, sites, rows, pos,
                                                      dtype)), runs=10)
            # yardstick: the contraction alone, hat^T @ grad per group, on a
            # materialized hat (bf16-rounded in bf16 mode) and a contiguous
            # cotangent; no scatter into the rows
            hat = materialized_hat(torch, sites, rows, pos)
            if dtype == torch.bfloat16:
                hat = hat.bfloat16().float()
            hat_t, g = hat.transpose(1, 2), grad.contiguous()
            l_ms = median_ms(torch, lambda: torch.bmm(hat_t, g))
            del hat, hat_t, g
            # reads the f32 cotangent and no features (element bytes 0),
            # writes the whole [capS, C] f32 output once
            b_ms, by, nbytes, ops = hat_bound(
                torch, rows, pos, C, capS, 0,
                hat_nonzeros(torch, sites, rows, pos), mode,
                4 * (ngrp * P * C + capS * C))
            bound_by.add(by)
            emit(phase="timing", kernel="hat_interp_level_bwd", mode=mode,
                 level=lvl, capR=rows.shape[1], C=C, kernel_ms=k_ms,
                 plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=by,
                 bytes=nbytes, ops=ops, card=card)
            for k, v in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bound_ms", b_ms)):
                tot[k] += v
        tot["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "bytes"
        timing[("bwd", mode)] = tot
        emit(phase="timing_sum", kernel="hat_interp_level_bwd", mode=mode,
             levels=len(levels), card=card, **tot)

    # the conv kernel, per layer, forward and dx; the sums are one encode's
    # (and one backward's) convs. With dx goes the rest of the convs'
    # backward as the port computes it, outside any kernel: the weight
    # gradient, a gather of the cotangent's table ([K, S, E]) and an einsum
    # against the forward conv's input
    for mode in modes:
        for kind, layers in conv_inputs[mode].items():
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bound_ms=0.0, bound_fp32_cores_ms=0.0)
            if kind == "dx":
                tot["weight_grad_ms"] = 0.0
            bound_share = {"bytes": 0.0, "operations": 0.0}
            for layer, (T, idx, W) in enumerate(layers):
                k_ms = median_ms(torch, lambda: conv_kernel.sparse_conv(
                    T, idx, W), runs=15)
                p_ms = median_ms(torch, lambda: conv_kernel.sparse_conv_plain(
                    T, idx, W), runs=8)
                l_ms = median_ms(torch, lambda: library_conv(torch, T, idx, W),
                                 runs=8)
                bound = conv_bound(torch, T, idx, W, mode)
                bound_share[bound["bound_by"]] += bound["bound_ms"]
                skipped, named = conv_tiles(torch, idx, T.shape[-2],
                                            conv_kernel.TILE_SITES)
                extra = {}
                if kind == "dx":
                    # the backward walks the layers in reverse; a packed
                    # conv's input is the middle third of its table's rows
                    Tf, idx_f, _ = step_fwd_convs[mode][CONV_LAYERS - 1 - layer]
                    S_in = idx.shape[-1]
                    x = (Tf if idx_f.shape[-2] == 27 else
                         Tf[..., :S_in, Tf.shape[-1] // 3:
                            2 * Tf.shape[-1] // 3])
                    if x.shape[-2] != S_in or idx_f.shape[-2] != idx.shape[-2]:
                        raise AssertionError(f"{mode} dW of layer {layer}: x "
                                             f"{tuple(x.shape)}, S {S_in}")
                    extra["weight_grad_ms"] = median_ms(
                        torch, lambda: sparse_conv._weight_grad(
                            x, conv_kernel.gather_rows(T, idx)), runs=8)
                    tot["weight_grad_ms"] += extra["weight_grad_ms"]
                emit(phase="timing", kernel="sparse_conv", direction=kind,
                     mode=mode, layer=layer, E=T.shape[-1], K=idx.shape[-2],
                     S=idx.shape[-1], Cout=W.shape[2],
                     splits=conv_kernel.split_plan(
                         T.shape[0] if T.dim() == 3 else 1, idx.shape[-1],
                         idx.shape[-2], T.shape[-1], T.dtype, sms),
                     taps_skipped=skipped, named_share=named,
                     kernel_ms=k_ms, plain_ms=p_ms,
                     library_ms=l_ms, **bound, **extra, card=card)
                for k, v in (("ms", k_ms), ("plain_ms", p_ms),
                             ("library_ms", l_ms),
                             ("bound_ms", bound["bound_ms"]),
                             ("bound_fp32_cores_ms",
                              bound["bound_fp32_cores_ms"])):
                    tot[k] += v
            tot["bound_by"] = max(bound_share, key=bound_share.get)
            timing[(f"conv_{kind}", mode)] = tot
            emit(phase="timing_sum", kernel="sparse_conv", direction=kind,
                 mode=mode, layers=len(layers), card=card, **tot)

    # the site sampler on the plan-free render's chunks: its bound is
    # writing the [N, 352] f32 output once
    for mode in modes:
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, points=0)
        for feats, ivols, dhw, out_sh, caps in site_inputs[mode]:
            args = (feats, ivols, dhw, out_sh, caps)
            tot["ms"] += median_ms(torch, lambda: site_launch(*args))
            tot["plain_ms"] += median_ms(
                torch, lambda: site_sample_kernel.site_trilinear_plain(*args))
            tot["bound_ms"] += 1e3 * (dhw.shape[0] * 4 * sum(
                site_sample_kernel.CHANNELS) / HBM_BYTES_PER_S)
            tot["points"] += dhw.shape[0]
        tot.update(chunks=len(site_inputs[mode]), bound_by="bytes",
                   library_ms=None)
        timing[("site", mode)] = tot
        emit(phase="timing_sum", kernel="site_trilinear", mode=mode,
             feature_dtype=str(site_inputs[mode][0][0][0].dtype),
             out_sh=list(site_inputs[mode][0][3]),
             caps=list(site_inputs[mode][0][4]), card=card, **tot)
    del site_inputs

    # renders, the two modes interleaved
    render_ms, gaps = interleaved_ms(
        torch, lambda m: eval_step(params, batch_dev, settings(m), device=dev),
        modes, RENDER_ROUNDS, RENDERS_PER_ROUND)
    emit(phase="render_pairs", rounds=RENDER_ROUNDS,
         renders_per_round=RENDERS_PER_ROUND, bf16_minus_f32_ms=gaps,
         bf16_slower_rounds=sum(g > 0 for g in gaps), card=card)
    for mode in modes:
        s = settings(mode)
        times = render_ms[mode]
        med = statistics.median(times)
        enc = []
        for _ in range(20):
            t0 = time.perf_counter()
            lx.encode_sparse_voxels(params, batch_dev["geom"], s.model,
                                    densify=False)
            torch.cuda.synchronize()
            enc.append(time.perf_counter() - t0)
        q1, _, q3 = statistics.quantiles(times, n=4)
        emit(phase="render_timing", mode=mode, render_ms=med,
             render_ms_q1=q1, render_ms_q3=q3, rays_per_s=N_RAYS / med * 1e3,
             encoder_ms=1e3 * statistics.median(enc),
             hat_kernel_ms=timing[("fwd", mode)]["ms"],
             conv_kernel_ms=timing[("conv_fwd", mode)]["ms"],
             runs=len(times), card=card)
        profile_step(torch, lambda: eval_step(params, batch_dev, s,
                                              device=dev), "render", mode, med)

    # the plan-free renders: per branch, the two modes interleaved
    for branch in branches:
        site = branch == "site"
        eval_ms, gaps = interleaved_ms(
            torch, lambda m: eval_step(params, ebatch_dev,
                                       eval_settings(m, site), device=dev),
            modes, EVAL_ROUNDS, RENDERS_PER_ROUND)
        emit(phase="eval_render_pairs", branch=branch, rounds=EVAL_ROUNDS,
             renders_per_round=RENDERS_PER_ROUND, bf16_minus_f32_ms=gaps,
             bf16_slower_rounds=sum(g > 0 for g in gaps), card=card)
        for mode in modes:
            times = eval_ms[mode]
            med = statistics.median(times)
            q1, _, q3 = statistics.quantiles(times, n=4)
            torch.cuda.reset_peak_memory_stats()
            eval_step(params, ebatch_dev, eval_settings(mode, site),
                      device=dev)
            torch.cuda.synchronize()
            emit(phase="eval_render_timing", branch=branch, mode=mode,
                 rays=EVAL_RAYS, render_ms=med, render_ms_q1=q1,
                 render_ms_q3=q3, us_per_ray=1e3 * med / EVAL_RAYS,
                 rays_per_s=EVAL_RAYS / med * 1e3,
                 conv_kernel_ms=timing[("conv_fwd", mode)]["ms"],
                 runs=len(times),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 card=card)
            if mode == "bf16":
                profile_step(
                    torch, lambda: eval_step(params, ebatch_dev,
                                             eval_settings(mode, site),
                                             device=dev),
                    f"eval_{branch}", mode, med)

    # training steps, the two modes interleaved, each on its own weights
    state = {}
    for mode in modes:
        tp, tbn = fresh_params()
        state[mode] = [tp, tbn, optimizer.build_optimizer(tp, schedule()),
                       settings(mode, ths)]

    def one_step(mode):
        tp, tbn, opt, s = state[mode]
        state[mode][1], _ = train_step(tp, tbn, opt, tbatch_dev, s,
                                       device=dev)

    step_ms, gaps = interleaved_ms(torch, one_step, modes, TRAIN_ROUNDS,
                                   STEPS_PER_ROUND)
    emit(phase="train_pairs", rounds=TRAIN_ROUNDS,
         steps_per_round=STEPS_PER_ROUND, bf16_minus_f32_ms=gaps,
         bf16_slower_rounds=sum(g > 0 for g in gaps), card=card)
    for mode in modes:
        times = step_ms[mode]
        med = statistics.median(times)
        q1, _, q3 = statistics.quantiles(times, n=4)
        torch.cuda.reset_peak_memory_stats()
        one_step(mode)
        torch.cuda.synchronize()
        emit(phase="train_timing", mode=mode, step_ms=med, step_ms_q1=q1,
             step_ms_q3=q3, train_rays_per_s=N_RAYS / med * 1e3,
             hat_fwd_ms=timing[("fwd", mode)]["ms"],
             hat_bwd_ms=timing[("bwd", mode)]["ms"],
             conv_fwd_ms=timing[("conv_fwd", mode)]["ms"],
             conv_dx_ms=timing[("conv_dx", mode)]["ms"],
             conv_weight_grad_ms=timing[("conv_dx", mode)]["weight_grad_ms"],
             runs=len(times),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
        profile_step(torch, lambda: one_step(mode), "train", mode, med)

    # -- 6a. the graphed paths' times, each beside its eager loop in ABBA
    # rounds on one state: train_step_scan (one dispatch of SCAN_G steps, a
    # replay) against train_steps (SCAN_G eager steps), RenderGraph against
    # eval_step
    del state
    for mode in modes:
        tp, tbn = fresh_params()
        opt = optimizer.build_optimizer(tp, schedule())
        s = settings(mode, ths)
        batches = stack_steps(tbatch_dev, SCAN_G)
        steps = [scan_slice(batches, i) for i in range(SCAN_G)]
        box = {"bn": tbn}

        def dispatch(way):
            if way == "graph":
                box["bn"], _ = train_step_scan(tp, box["bn"], opt, batches, s,
                                               device=dev)
            else:
                box["bn"], _ = train_steps(tp, box["bn"], opt, steps, s,
                                           device=dev)

        times, gaps = interleaved_ms(torch, dispatch, ("graph", "eager"),
                                     SCAN_ROUNDS, 1)
        # busy time and launches a step from the traces of "graph_launches"
        # (a replay) and of one eager step
        row = {}
        for way, trace in (("graph", graph_replay[mode]),
                           ("eager", eager_trace[mode])):
            med = statistics.median(times[way])
            row[way] = dict(
                dispatch_ms=med, step_ms=med / SCAN_G,
                train_rays_per_s=N_RAYS * SCAN_G / med * 1e3,
                busy_ms_per_step=trace["busy_ms"],
                busy_share=trace["busy_ms"] * SCAN_G / med,
                kernels_per_step=trace["kernels"],
                dispatch_ms_all=times[way])
        emit(phase="scan_timing", mode=mode, steps_per_dispatch=SCAN_G,
             rounds=SCAN_ROUNDS, graph_minus_eager_ms=gaps,
             captures=opt.step_graph.captures, card=card, **row)
        del tp, tbn, opt, batches, steps, box
        torch.cuda.empty_cache()

    for mode in modes:
        s = settings(mode)

        def render(way):
            if way == "graph":
                render_graphs[mode](params, batch_dev, s)
            else:
                eval_step(params, batch_dev, s, device=dev)

        times, gaps = interleaved_ms(torch, render, ("graph", "eager"),
                                     RENDER_ROUNDS, RENDERS_PER_ROUND)
        row = {}
        for way in ("graph", "eager"):
            med = statistics.median(times[way])
            busy, n = profile_step(torch, lambda: render(way),
                                   f"render_{way}", mode, med)
            row[way] = dict(render_ms=med, rays_per_s=N_RAYS / med * 1e3,
                            busy_ms=busy, busy_share=busy / med, launches=n)
        emit(phase="graph_render_timing", mode=mode, rounds=RENDER_ROUNDS,
             renders_per_round=RENDERS_PER_ROUND, graph_minus_eager_ms=gaps,
             captures=render_graphs[mode].captures, card=card, **row)
    del render_graphs
    torch.cuda.empty_cache()

    # where an eager step's host time goes: torch.profiler with the CPU
    # activity on, host operations by their own (self) time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for mode in modes:
        tp, tbn = fresh_params()
        opt = optimizer.build_optimizer(tp, schedule())
        s = settings(mode, ths)
        for _ in range(2):
            tbn, _ = train_step(tp, tbn, opt, tbatch_dev, s, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tbn, _ = train_step(tp, tbn, opt, tbatch_dev, s, device=dev)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.self_cpu_time_total]
        ops.sort(key=lambda e: -e.self_cpu_time_total)
        host_ms = sum(e.self_cpu_time_total for e in ops) / 1e3
        emit(phase="host_profile", mode=mode, profiled_step_ms=wall_ms,
             host_ops_self_ms=host_ms, outside_ops_ms=wall_ms - host_ms,
             host_ops=len(ops), host_calls=sum(e.count for e in ops),
             top=[{"name": e.key[:90], "self_ms": e.self_cpu_time_total / 1e3,
                   "count": e.count, "share": e.self_cpu_time_total / 1e3
                   / wall_ms} for e in ops[:HOST_TOP]], card=card)
        del tp, tbn, opt, prof

    # -- 6a. the config path: config, factories, loader workers, the bank,
    # the prefetcher, the banked graph; then the bench's fresh half on the
    # same pool ------------------------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, ds = graph_noise.config_case("full", "bfloat16", CONFIG_G,
                                      CONFIG_WARM * CONFIG_G)
    dataset_s = time.perf_counter() - t0
    pool, pool_start_s = start_pool(ds)
    try:
        emit(phase="config_pool", dataset_s=dataset_s,
             pool_start_s=pool_start_s, workers=CONFIG_WORKERS)
        config_counts, config_replay = config_path(
            torch, dev, card, cfg, ds, pool, failed)
        fresh = fresh_bench(torch, card, pool)
        # the hat plan built on the card, on the same pool
        plan_counts = device_plan(torch, dev, card, rbatch, static, ds, pool,
                                  failed)
    finally:
        pool.shutdown()

    # the port's bench, as `python -m neuralbody_tpu_torch.bench` runs it
    # (its fresh half measured above, on the config path's pool)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line = port_bench.summary(
        port_bench.measure_broadcast(),
        port_bench.measure_broadcast(n_rays=4096, n_iters=6, extras=False),
        card, fresh)
    emit(phase="bench", seconds=time.perf_counter() - t0, **line)
    shares = [line[k] for k in ("device_busy_share",
                                "fresh_device_busy_share")]
    if (set(port_bench.BENCH_KEYS) - line.keys()
            or any(line[k] is None for k in port_bench.BENCH_KEYS)
            or not line["broadcast_rays_per_s"] > 0
            or not line["broadcast_4096_rays_per_s"] > 0
            or not all(0 < x <= 1 for x in shares)):
        raise AssertionError(f"bench line: {line}")

    # -- 6b. the NeRF baseline family and the dense product ------------------
    torch.cuda.empty_cache()
    nerf_kernels = nerf_family(torch, dev, card, ebatch, rbatch)

    # -- 6c. the training harness: Trainer.fit / validate / resume on a fake
    # ZJU sequence, latent_xyzc (graphed, bf16) and the NeRF baseline (eager,
    # f32) --------------------------------------------------------------------
    from neuralbody_tpu_torch.utils.fake_zju import make_fake_zju
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    harness = os.path.join(cuda_build.BUILD_DIR, "harness")
    root = make_fake_zju(os.path.join(harness, "zju", "CoreView_999"),
                         n_frames=TRAINER_FRAMES, n_cams=TRAINER_CAMS,
                         hw=TRAINER_HW, n_verts=TRAINER_VERTS, shaded=True)
    emit(phase="trainer_data", frames=TRAINER_FRAMES, cams=TRAINER_CAMS,
         hw=TRAINER_HW, vertices=TRAINER_VERTS,
         seconds=time.perf_counter() - t0)
    fit_counts, val_counts = trainer_fit(
        torch, dev, card, root, os.path.join(harness, "fit"), failed, fresh)
    torch.cuda.empty_cache()
    nerf_fit, nerf_val = trainer_nerf(torch, dev, card, root,
                                      os.path.join(harness, "nerf"), failed)

    # -- 6d. the first trained model (the convergence tool cut to two
    # epochs, the novel-pose tool), then every runner of run.py over its
    # checkpoint and over trainer_nerf's ----------------------------------
    torch.cuda.empty_cache()
    quality = os.path.join(harness, "quality")
    conv, quality_counts = quality_short(torch, dev, card, quality, failed)
    torch.cuda.empty_cache()
    eval_counts, mesh_counts = run_entry(torch, dev, card, quality, conv,
                                         failed)
    torch.cuda.empty_cache()
    nerf_eval, nerf_mesh = run_nerf(torch, dev, card, root,
                                    os.path.join(harness, "nerf"), harness,
                                    failed)

    # -- 6e. graphed bf16 steps from quality_short's trained state against
    # eager ones (TRAINED_TOL), then the T-pose variant at full width ------
    torch.cuda.empty_cache()
    graph_vs_eager_trained(torch, dev, card, conv, failed)
    torch.cuda.empty_cache()
    tpose = tpose_family(torch, dev, card, root,
                         os.path.join(harness, "tpose"), failed)

    # -- 6f. the multi-process layer: two ranks on the one card against one
    # process, then train_net's bootstrap under torchrun's variables -------
    torch.cuda.empty_cache()
    dist_counts = dist_two_ranks(torch, card, failed)
    dist_entry(torch, card, root, harness, failed)

    # -- 7. the kernels ---------------------------------------------------
    kernels = []
    for kind, kname, line in (("fwd", "hat_interp_level", 44),
                              ("bwd", "hat_interp_level_bwd", 50)):
        for mode in modes:
            t = timing[(kind, mode)]
            i = 0 if kind == "fwd" else 1
            kernels.append({
                "name": f"{kname}[{mode}]", "route": "cuda",
                "source": "neuralbody_tpu_torch/csrc/hat_interp.cu",
                "replaces": f"neuralbody_tpu/ops/pallas_hat.py:{line}",
                "launches": (launches[("render", mode)][i]
                             + launches[("train", mode)][i]),
                "max_abs_err": (max_err if kind == "fwd" else bwd_err)[mode],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "scan_ms": t.get("scan_ms"),
                "sort_ms": t.get("sort_ms"),
                "replay_launches_per_step": graph_replay[mode][
                    "hat_fwd" if kind == "fwd" else "hat_bwd"],
                "replay_launches_per_render": render_replay[mode][
                    "hat_fwd" if kind == "fwd" else "hat_bwd"],
                # the config path runs in bf16 only
                "config_path_launches": (
                    config_counts[i] if mode == "bf16" else None),
                "config_path_replay_launches_per_step": (
                    config_replay["hat_fwd" if kind == "fwd" else "hat_bwd"]
                    if mode == "bf16" else None)})
    # the conv kernel's launches by the wrapper's counters: its dx launches
    # (CONV_DX_LAUNCHES: 17 per training step), its forward ones (the rest:
    # 17 per encode in every forward path and in each training step). A
    # trace names one kernel for both: its counts stand on the forward row,
    # and the dx row's are null.
    fwd_paths = [k for k in launches if k[0] != "train"]
    for kind, kname in (("fwd", "sparse_conv"), ("dx", "sparse_conv_dx")):
        for mode in modes:
            t = timing[(f"conv_{kind}", mode)]
            dx = dx_launches[mode]
            n = launches[("train", mode)][2] - dx if kind == "fwd" else dx
            if kind == "fwd":
                n += sum(launches[k][2] for k in fwd_paths if k[1] == mode)
            config = None
            if mode == "bf16":   # the config path runs in bf16 only
                config = (config_counts[2] - config_counts[3]
                          if kind == "fwd" else config_counts[3])
            traced = kind == "fwd"
            kernels.append({
                "name": f"{kname}[{mode}]", "route": "cuda",
                "source": "neuralbody_tpu_torch/csrc/sparse_conv.cu",
                "replaces": CONV_REPLACES, "launches": n,
                "max_abs_err": conv_err[(kind, mode)],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "bound_fp32_cores_ms": t["bound_fp32_cores_ms"],
                "replay_launches_counted": "forward and dx together",
                "replay_launches_per_step": (
                    graph_replay[mode]["conv"] if traced else None),
                "replay_launches_per_render": (
                    render_replay[mode]["conv"] if traced else None),
                "config_path_launches": config,
                "config_path_replay_launches_per_step": (
                    config_replay["conv"] if traced and mode == "bf16"
                    else None)})
    # the site sampler's kernel (no Pallas kernel: the JAX package leaves
    # the function to XLA), timed over the plan-free render's four chunks
    for mode in modes:
        t = timing[("site", mode)]
        kernels.append({
            "name": f"site_trilinear[{mode}]", "route": "cuda",
            "source": "neuralbody_tpu_torch/csrc/site_sample.cu",
            "replaces": None, "launches": site_launches[("site", mode)][0],
            "max_abs_err": site_err[mode],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "chunks": t["chunks"],
            "points": t["points"]})
    for k in nerf_kernels:   # the config path trains latent_xyzc only
        k.update(config_path_launches=None,
                 config_path_replay_launches_per_step=None)
    kernels += nerf_kernels
    # the training harness's launches (counted from 0 over fit and over
    # validate): latent_xyzc's in bf16, the NeRF baseline's products (every
    # kind and route together, on dense_mm's entry)
    harness_counts = {
        "hat_interp_level[bf16]": ("hat_fwd", fit_counts, val_counts),
        "hat_interp_level_bwd[bf16]": ("hat_bwd", fit_counts, val_counts),
        "sparse_conv_dx[bf16]": ("conv_dx", fit_counts, val_counts),
        "dense_mm[f32]": ("dense", nerf_fit, nerf_val),
        "site_trilinear[bf16]": ("site", fit_counts, val_counts)}
    for k in kernels:
        key, fit, val = harness_counts.get(k["name"], (None, None, None))
        if k["name"] == "sparse_conv[bf16]":
            fit = {"n": fit_counts["conv"] - fit_counts["conv_dx"]}
            val = {"n": val_counts["conv"] - val_counts["conv_dx"]}
            key = "n"
        k.update(trainer_fit_launches=None if key is None else fit[key],
                 trainer_validate_launches=None if key is None else val[key])
    # the trained model's paths (f32; counted from 0 over each): the
    # convergence tool's two epochs, run.py's evaluate and vis_mesh
    # (latent_xyzc's, the NeRF baseline's on dense_mm's entry)
    new_paths = {
        "hat_interp_level[f32]": ("hat_fwd", quality_counts, eval_counts,
                                  mesh_counts),
        "hat_interp_level_bwd[f32]": ("hat_bwd", quality_counts,
                                      eval_counts, mesh_counts),
        "sparse_conv_dx[f32]": ("conv_dx", quality_counts, eval_counts,
                                mesh_counts),
        "dense_mm[f32]": ("dense", None, nerf_eval, nerf_mesh),
        "site_trilinear[f32]": ("site", quality_counts, eval_counts,
                                mesh_counts)}
    for k in kernels:
        row = new_paths.get(k["name"])
        if k["name"] == "sparse_conv[f32]":
            row = ("n",) + tuple(
                {"n": c["conv"] - c["conv_dx"]}
                for c in (quality_counts, eval_counts, mesh_counts))
        key, quality_c, eval_c, mesh_c = row or (None,) * 4
        k.update(quality_short_launches=(
                     None if quality_c is None else quality_c[key]),
                 run_evaluate_launches=None if key is None else eval_c[key],
                 mesh_launches=None if key is None else mesh_c[key])
    # the T-pose path (f32, eager): its conv kernel's numbers at the T-pose
    # encoder's shapes, and its launches over Trainer fit and validate
    for k in kernels:
        kind = {"sparse_conv[f32]": "fwd",
                "sparse_conv_dx[f32]": "dx"}.get(k["name"])
        t = tpose["conv"].get(kind, {})
        fit = (tpose["fit"]["conv"] - tpose["fit"]["conv_dx"]
               if kind == "fwd" else tpose["fit"]["conv_dx"])
        val = (tpose["validate"]["conv"] - tpose["validate"]["conv_dx"]
               if kind == "fwd" else tpose["validate"]["conv_dx"])
        k.update(tpose_fit_launches=fit if kind else None,
                 tpose_validate_launches=val if kind else None,
                 **{f"tpose_{x}": t.get(x) for x in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "max_abs_err")})
    # this slice's paths: both ranks' sharded steps (dist_two_ranks), and
    # the config path's runs with the plan built on the card (bf16)
    slice_counts = {"hat_interp_level": "hat_fwd",
                    "hat_interp_level_bwd": "hat_bwd",
                    "sparse_conv": "conv", "sparse_conv_dx": "conv_dx"}
    for k in kernels:
        base, _, mode = k["name"].partition("[")
        key, mode = slice_counts.get(base), mode.rstrip("]")
        dist_n = plan_n = None
        if key is not None:
            dist_n = dist_counts[mode][key]
            if key == "conv":      # the conv counter holds its dx too
                dist_n -= dist_counts[mode]["conv_dx"]
            if mode == "bf16":
                i = ("hat_fwd", "hat_bwd", "conv", "conv_dx").index(key)
                plan_n = plan_counts[i] - (plan_counts[3] if i == 2 else 0)
        k.update(dist_two_ranks_launches=dist_n,
                 device_plan_launches=plan_n)
    if failed:
        raise AssertionError("; ".join(failed))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
