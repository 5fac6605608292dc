"""Where the time of the tensor-core sparse-conv kernel goes, and how many
blocks should share a tile's reduction: builds variants of
csrc/sparse_conv.cu that leave one part of its main loop out (or change
it), and times each, and the kernel itself at every split count, on the 34
convs (17 forward, 17 dx) of one full-width latent_xyzc training step in
bf16 and in f32. Needs an NVIDIA GPU and nvcc.

    python -m neuralbody_tpu_torch.tools.conv_variants

A variant is a textual patch of the source (the script raises if a patch no
longer applies) built into its own library under build/; nothing here is on
a path of the port. Variants that leave work out compute wrong outputs by
design and are timed only; the others are held against the plain version.
Prints one JSON line per measurement, each with the card's name and power
limit, then the split plan's modelled choice against the fastest count.

Variants (each at the split count ops/conv_kernel.split_plan gives):
  as_is           the source as it is
  no_products     no mma: the copies, the barriers and the loop alone
  no_copies       only the ring's first stages are ever copied: the
                  products, the barriers and the loop alone
  four_stages     a ring of four stages in place of three
  chains_of_64    the tensor core's sums join the master sums every 64 of
                  the reduction in place of every 256
  one_block_a_sm  launch bounds for one resident block an SM (more
                  registers a thread)
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import conv_kernel as ck
from ..ops import sparse_conv
from ..utils import cuda_build

LAYERS = 17          # convs of an encode
SEED = 0
TOL = 1e-5           # of the layer's scale, as the card tests hold it
# candidates of the plan's two constants, held against the measured times
SETUPS = (0, 1, 2, 3, 4, 6, 8, 12)
RATES = (1.0, 1.25, 1.5, 1.75, 2.0)


def _patch(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"patch no longer applies: {old[:60]!r}")
    return text.replace(old, new)


def variants():
    """{name: source text} of the variants, from csrc/sparse_conv.cu."""
    src = ck.SOURCE.read_text()
    products = ("    stage_products<CO>(acc, sa, sa + BM * L::LDA, wm, wn, "
                "lane);\n")
    refill = "    if (t + STAGES - 1 < n_stages) load(t + STAGES - 1);\n"
    return {
        "as_is": src,
        "no_products": _patch(src, products, ""),
        "no_copies": _patch(src, refill, ""),
        "four_stages": _patch(src, "constexpr int STAGES = 3;",
                              "constexpr int STAGES = 4;"),
        "chains_of_64": _patch(src, "constexpr int CHAIN = 256;",
                               "constexpr int CHAIN = 64;"),
        "one_block_a_sm": _patch(src, "constexpr int MIN_BLOCKS = 2;",
                                 "constexpr int MIN_BLOCKS = 1;"),
    }


TIMED_ONLY = ("no_products", "no_copies")


def _nvcc(name, text):
    out_dir = cuda_build.BUILD_DIR / "conv_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"{name}.so"
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    fn = ctypes.CDLL(str(lib)).sparse_conv_cuda
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, p, i, i, i, i, i, i, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


def _median_ms(fn, runs=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)   # the host enqueues behind a spin
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def step_convs(dev):
    """{mode: [(T, idx, W)] * 34}: the forward convs of one full-width
    training step, then its dx convs, as the encoder hands them to the
    wrapper (the smoke run's training batch and weights)."""
    from ..models import latent_xyzc as lx
    from ..models.sparse_conv_net import EncoderStatic
    from ..renderer.renderer import RenderSettings
    from ..train.step import loss_and_grads
    from ..utils.platform import to_device
    from ..utils.synthetic import make_batch

    batch, static = make_batch(n_rays=1024, n_verts=6890, voxel_size=0.005,
                               seed=SEED, hat=True, n_samples=64,
                               hat_perturb=True)
    batch = to_device(batch, dev)
    params, _ = lx.init(torch.Generator().manual_seed(SEED),
                        num_train_frame=1, device=dev)
    params["alpha_fc"]["b"] += 1.0
    launch, calls, out = sparse_conv.sparse_conv, [], {}

    def recorder(T, idx, W, dx=False):
        calls.append((T, idx, W))
        return launch(T, idx, W, dx=dx)

    sparse_conv.sparse_conv = recorder
    try:
        for mode in ("bf16", "f32"):
            settings = RenderSettings(
                model=lx.ModelStatic(encoder=EncoderStatic(
                    out_sh=static["out_sh"], site_caps=static["site_caps"],
                    compute_dtype="bfloat16" if mode == "bf16"
                    else "float32")),
                voxel_size=(0.005,) * 3,
                hat_rows_caps=static["hat"]["rows_caps"])
            calls.clear()
            loss_and_grads(params, batch, settings)
            if len(calls) != 2 * LAYERS:
                raise RuntimeError(f"{mode}: {len(calls)} convs a step")
            out[mode] = list(calls)
    finally:
        sparse_conv.sparse_conv = launch
    torch.cuda.synchronize()
    return out


def main():
    if not torch.cuda.is_available():
        print("conv_variants: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def emit(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    texts = variants()
    with ThreadPoolExecutor(len(texts)) as pool:
        fns = dict(zip(texts, pool.map(_nvcc, texts, texts.values())))
    convs = step_convs(dev)
    stream = torch.cuda.current_stream().cuda_stream

    sweep = []   # (mode, tiles, steps, {splits: ms})
    totals = {}
    for mode, layers in convs.items():
        for j, (T, idx, W) in enumerate(layers):
            kind, layer = ("fwd", j) if j < LAYERS else ("dx", j - LAYERS)
            B = T.shape[0] if T.dim() == 3 else 1
            n_rows, E = T.shape[-2:]
            K, S = idx.shape[-2:]
            Cout = W.shape[2]
            w = W.to(T.dtype).contiguous()
            out = torch.empty((*idx.shape[:-2], S, Cout), device=dev)
            ref = ck.sparse_conv_plain(T, idx, W)
            scale = ref.abs().max().item()
            plan = ck.split_plan(B, S, K, E, T.dtype, sms)

            def call(fn, splits):
                err = fn(T.data_ptr(), int(T.dtype == torch.bfloat16),
                         idx.data_ptr(), w.data_ptr(), out.data_ptr(), B,
                         n_rows, E, K, S, Cout,
                         T.stride(0) if T.dim() == 3 else 0, splits, stream)
                if err != 0:
                    raise RuntimeError(f"CUDA error {err}")

            row = dict(mode=mode, kind=kind, layer=layer, S=S, K=K, E=E,
                       Cout=Cout, splits=plan)
            for name, fn in fns.items():
                ms = _median_ms(lambda: call(fn, plan))
                if name not in TIMED_ONLY:
                    call(fn, plan)
                    err = (out - ref).abs().max().item() / scale
                    if not err <= TOL:
                        raise AssertionError(f"{name} {mode} {kind} "
                                             f"{layer}: {err} of scale")
                row[name] = ms
                totals[(mode, kind, name)] = (
                    totals.get((mode, kind, name), 0.0) + ms)
            emit(phase="variants", **row)

            tiles = B * -(-S // ck.TILE_SITES)
            steps = -(-K * E // ck.STAGE_DEPTH[T.dtype])
            by_split = {s: _median_ms(lambda: call(fns["as_is"], s))
                        for s in range(1, min(ck.MAX_SPLITS, steps) + 1)}
            best = min(by_split, key=by_split.get)
            sweep.append((mode, kind, B, S, K, E, T.dtype, by_split))
            emit(phase="splits", mode=mode, kind=kind, layer=layer, S=S, K=K,
                 E=E, Cout=Cout, tiles=tiles, steps=steps, plan=plan,
                 best=best, ms_by_splits=by_split)
    for (mode, kind, name), ms in sorted(totals.items()):
        emit(phase="variants_sum", mode=mode, kind=kind, variant=name,
             layers=LAYERS, ms=ms)

    def plan_total(mode, kind):
        return sum(t[ck.split_plan(B, S, K, E, dt, sms)]
                   for m, k, B, S, K, E, dt, t in sweep
                   if m == mode and k == kind)

    for mode, kind in itertools.product(("bf16", "f32"), ("fwd", "dx")):
        rows = [r for r in sweep if r[0] == mode and r[1] == kind]
        emit(phase="splits_sum", mode=mode, kind=kind, layers=len(rows),
             plan_ms=plan_total(mode, kind),
             unsplit_ms=sum(r[-1][1] for r in rows),
             best_ms=sum(min(r[-1].values()) for r in rows))
    # the plan's two constants: the measured time of what each pair picks
    kept = (ck._SETUP_STEPS, ck._FULL_RATE)
    fits = []
    try:
        for setup, rate in itertools.product(SETUPS, RATES):
            ck._SETUP_STEPS, ck._FULL_RATE = setup, rate
            fits.append((sum(plan_total(m, k) for m, k in itertools.product(
                ("bf16", "f32"), ("fwd", "dx"))), setup, rate))
    finally:
        ck._SETUP_STEPS, ck._FULL_RATE = kept
    for total, setup, rate in sorted(fits)[:8]:
        emit(phase="plan_fit", setup_steps=setup, full_rate=rate,
             step_ms=total, as_set=(setup, rate) == kept)
    emit(phase="plan_fit", setup_steps=kept[0], full_rate=kept[1],
         step_ms=next(t for t, s, r in fits if (s, r) == kept), as_set=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
