#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neuralbody_tpu_torch) on one NVIDIA
GPU. It builds the port's CUDA kernels from the checkout and drives the
port's two main paths at full width through their entry points:

  * the forward render (eval_step), bf16 and f32, held against the port's
    own CPU render;
  * the training step (train_step: encode, hat interpolation, decode,
    composite, masked MSE, backward, value-clip + Adam, BN EMA), bf16 and
    f32: the first step's loss and gradients held against the same step
    run by the port on the CPU, then ten steps on one batch whose loss must
    fall.

Each hat kernel (forward and backward) is held against its plain PyTorch
version on the inputs the main paths hand it, and timed beside its plain
version, a library yardstick and its bound; the render and the training
step are timed and profiled.

    python3 chip_smoke.py

The full-width batch is the reference working point: 6890 vertices, 5 mm
voxels, 1024 rays x 64 samples, encoder channels 16/32/64/128/128, decoder
352 -> 256 -> ... -> 3, random weights from a seeded torch.Generator.

Every phase raises on failure. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels.
Exits non-zero with no result line when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import os
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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def median_ms(torch, fn, runs=25, warmup=3):
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
    (torch.profiler), and the share of the unprofiled step time the device
    is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # the device's own events (kernels, copies, memsets), not the host ops
    # that launched them, which carry the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit(phase="profile", path=what, mode=mode, device_busy_ms=busy,
         busy_share=busy / step_ms, kernels=len(rows),
         launches=sum(r[2] for r in rows),
         top=[{"name": k[:90], "ms": ms, "count": n}
              for k, ms, n in rows[:top]])


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neuralbody_tpu_torch.models import latent_xyzc as lx
    from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu_torch.ops import hat_interp, hat_kernel
    from neuralbody_tpu_torch.renderer.renderer import RenderSettings
    from neuralbody_tpu_torch.train import optimizer
    from neuralbody_tpu_torch.train.step import (eval_step, loss_and_grads,
                                                 train_step)
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

    # -- 2. build: one nvcc call for the one source of both kernels ---------
    t0 = time.perf_counter()
    hat_kernel.build()
    emit(phase="build", source="neuralbody_tpu_torch/csrc/hat_interp.cu",
         entry_points=["hat_interp_level_cuda", "hat_interp_level_bwd_cuda"],
         seconds=time.perf_counter() - t0)

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
    tbatch, tstatic = make_batch(n_rays=N_RAYS, n_verts=6890, voxel_size=VOX,
                                 seed=SEED, hat=True, n_samples=N_SAMPLES,
                                 hat_perturb=True)
    ths = tstatic["hat"]
    emit(phase="batch", path="train", host_seconds=time.perf_counter() - t0,
         n_groups=ths["n_groups"], rows_caps=list(ths["rows_caps"]))

    def fresh_params(device=dev):
        params, stats = lx.init(torch.Generator().manual_seed(SEED),
                                num_train_frame=1, device=device)
        params["alpha_fc"]["b"] += ALPHA_BIAS
        return params, stats

    params, _ = fresh_params()
    batch_dev = to_device(batch, dev)
    tbatch_dev = to_device(tbatch, dev)

    def settings(mode, plan=hs):
        return RenderSettings(
            model=lx.ModelStatic(encoder=EncoderStatic(
                out_sh=static["out_sh"], site_caps=static["site_caps"],
                compute_dtype="bfloat16" if mode == "bf16" else "float32")),
            voxel_size=(VOX,) * 3, hat_rows_caps=plan["rows_caps"])

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

    def bwd_recorder(grad, sites, rows, pos, dtype):
        bwd_inputs[mode].append((grad, sites, rows, pos, dtype))
        return bwd_launch(grad, sites, rows, pos, dtype)

    card_grads = {}
    hat_interp.hat_interp_level = recorder
    try:
        for mode in modes:
            eval_step(params, batch_dev, settings(mode), device=dev)
        hat_interp.hat_interp_level = launch
        hat_interp.hat_interp_level_bwd = bwd_recorder
        for mode in modes:
            p0, _ = fresh_params()
            card_grads[mode] = loss_and_grads(p0, tbatch_dev,
                                              settings(mode, ths))
    finally:
        hat_interp.hat_interp_level = launch
        hat_interp.hat_interp_level_bwd = bwd_launch
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

    # -- 4. the render path: full-width renders on the card ------------------
    launches, renders = {}, {}
    for mode in modes:
        hat_kernel.LAUNCHES = hat_kernel.BWD_LAUNCHES = 0
        ret = eval_step(params, batch_dev, settings(mode), device=dev)
        torch.cuda.synchronize()
        launches[("render", mode)] = (hat_kernel.LAUNCHES,
                                      hat_kernel.BWD_LAUNCHES)
        if launches[("render", mode)] != (4, 0):
            raise AssertionError(f"{mode} render launched the hat kernels "
                                 f"{launches[('render', mode)]} times, "
                                 "not (4, 0)")
        for k in MAPS:
            want = (1, N_RAYS, 3) if k == "rgb_map" else (1, N_RAYS)
            if tuple(ret[k].shape) != want or not torch.isfinite(ret[k]).all():
                raise AssertionError(f"{mode} {k}: shape "
                                     f"{tuple(ret[k].shape)} or not finite")
        renders[mode] = {k: ret[k].cpu() for k in MAPS}

    t0 = time.perf_counter()
    ref = eval_step(to_device(params, "cpu"), batch, settings("f32"),
                    device="cpu")
    cpu_s = time.perf_counter() - t0
    for mode, ret in renders.items():
        errs = {}
        for k in ("rgb_map", "acc_map", "depth_map"):
            err = (ret[k] - ref[k]).abs().max().item()
            scale = max(1.0, ref[k].abs().max().item())
            errs[k] = err
            if err > RENDER_TOL[mode] * scale:
                raise AssertionError(f"{mode} render {k}: err {err} vs the "
                                     f"CPU render (scale {scale})")
        emit(phase="render_vs_cpu", mode=mode,
             launches=launches[("render", mode)][0], max_abs_err=errs,
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
    # per step, the loss falling
    losses = {}
    for mode in modes:
        tp, tbn = fresh_params()
        opt = optimizer.make_optimizer(tp, schedule())
        s = settings(mode, ths)
        hat_kernel.LAUNCHES = hat_kernel.BWD_LAUNCHES = 0
        per_step, losses[mode] = [], []
        for _ in range(TRAIN_STEPS):
            f0, b0 = hat_kernel.LAUNCHES, hat_kernel.BWD_LAUNCHES
            tbn, st = train_step(tp, tbn, opt, tbatch_dev, s, device=dev)
            losses[mode].append(st["loss"].item())
            per_step.append((hat_kernel.LAUNCHES - f0,
                             hat_kernel.BWD_LAUNCHES - b0))
        torch.cuda.synchronize()
        launches[("train", mode)] = (hat_kernel.LAUNCHES,
                                     hat_kernel.BWD_LAUNCHES)
        finite = all(torch.isfinite(p).all() for _, p in leaves(tp))
        emit(phase="train", mode=mode, steps=TRAIN_STEPS, lr=LR,
             losses=losses[mode], launches_per_step=per_step[0],
             launches=launches[("train", mode)], params_finite=bool(finite))
        if any(ps != (4, 4) for ps in per_step):
            raise AssertionError(f"{mode} steps launched the hat kernels "
                                 f"{per_step} times, not (4, 4) each")
        if not (finite and all(map(math.isfinite, losses[mode]))
                and losses[mode][-1] < losses[mode][0]):
            raise AssertionError(f"{mode} training: losses {losses[mode]}")
    emit(phase="launches", **{f"{p}_{m}": v for (p, m), v in
                              launches.items()})

    # -- 6. timings -----------------------------------------------------------
    timing = {}
    for mode, levels in level_inputs.items():
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        bound_by = set()
        for lvl, (feats, sites, rows, pos) in enumerate(levels, 1):
            ngrp, P, _ = pos.shape
            C = feats.shape[1]
            out = torch.empty((ngrp, P, C), device=dev)
            k_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level(
                feats, sites, rows, pos, out=out))
            p_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level_plain(
                feats, sites, rows, pos), runs=20)
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
                 level=lvl, kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                 bound_ms=b_ms, bound_by=by, bytes=nbytes, ops=ops,
                 card=card)
            for k, v in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bound_ms", b_ms)):
                tot[k] += v
        tot["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "bytes"
        timing[("fwd", mode)] = tot

    for mode, levels in bwd_inputs.items():
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        bound_by = set()
        for lvl, (grad, sites, rows, pos, dtype) in enumerate(levels, 1):
            ngrp, P, C = grad.shape
            capS = sites.shape[0]
            k_ms = median_ms(torch, lambda: hat_kernel.hat_interp_level_bwd(
                grad, sites, rows, pos, dtype))
            p_ms = median_ms(torch, lambda: (
                hat_kernel.hat_interp_level_bwd_plain(grad, sites, rows, pos,
                                                      dtype)), runs=20)
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
                 level=lvl, kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                 bound_ms=b_ms, bound_by=by, bytes=nbytes, ops=ops,
                 card=card)
            for k, v in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bound_ms", b_ms)):
                tot[k] += v
        tot["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "bytes"
        timing[("bwd", mode)] = tot

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
            lx.encode_sparse_voxels(params, batch_dev["geom"], s.model)
            torch.cuda.synchronize()
            enc.append(time.perf_counter() - t0)
        q1, _, q3 = statistics.quantiles(times, n=4)
        emit(phase="render_timing", mode=mode, render_ms=med,
             render_ms_q1=q1, render_ms_q3=q3, rays_per_s=N_RAYS / med * 1e3,
             encoder_ms=1e3 * statistics.median(enc),
             hat_kernel_ms=timing[("fwd", mode)]["ms"], runs=len(times),
             card=card)
        profile_step(torch, lambda: eval_step(params, batch_dev, s,
                                              device=dev), "render", mode, med)

    # training steps, the two modes interleaved, each on its own weights
    state = {}
    for mode in modes:
        tp, tbn = fresh_params()
        state[mode] = [tp, tbn, optimizer.make_optimizer(tp, schedule()),
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
             hat_bwd_ms=timing[("bwd", mode)]["ms"], runs=len(times),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
        profile_step(torch, lambda: one_step(mode), "train", mode, med)

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
                "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
