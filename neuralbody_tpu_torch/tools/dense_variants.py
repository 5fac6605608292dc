"""Where the time of the tensor-core dense kernel goes: builds variants of
csrc/dense_mm.cu that leave one part of its main loop out (or swap it for
the alternative that was tried), times each beside the kernel as it is and
torch.matmul, and measures what mma.sync itself sustains in the kernel's
pattern of operations. Needs an NVIDIA GPU and nvcc.

    python -m neuralbody_tpu_torch.tools.dense_variants

A variant is a textual patch of the source (the script raises if a patch no
longer applies) built into its own library under build/; nothing here is on
a path of the port. Variants that leave work out compute wrong products by
design: "one_product" and "no_copies" are timed only, the others are held
against an f64 product. Prints one JSON line per measurement, each with the card's name
and power limit.

Variants:
  as_is            the source as it is: reductions up to 320 chain in the
                   tensor core, longer ones round their sums
  rounded_sums     every reduction rounds: the three products of a k-step
                   chained from zero, joined by f32 adds
  chained_sums     every reduction chains: what the rounded adds cost, and
                   the error they prevent
  one_product      hi x hi only, no split, chained: one third of the mma
  no_copies        only the first two tiles are ever copied from device
                   memory: what the copies and their address arithmetic cost
  cvt_split        cvt.rna.tf32 in place of the masks
  one_block_a_sm   255 registers a thread, one block a SM
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import dense_kernel as dk
from ..utils import cuda_build

POINTS = 196608   # the fine pass of a 1024-ray NeRF step
SHAPES = ((256, 256), (319, 256))   # (K, N) of the layers timed

CHAINED = '''#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], al, bh[ni], acc[mi][ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], ah, bl[ni], acc[mi][ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], ah, bh[ni], acc[mi][ni]);
'''
ONE_PRODUCT = '''#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], ah, bh[ni], acc[mi][ni]);
'''
SPLIT = '''  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
'''
CVT_SPLIT = '''  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));
'''
NO_SPLIT = '''  hi = __float_as_uint(x);
  lo = 0u;
'''

# The kernel's own pattern of mma with operands that never leave the
# registers: 16 tiles a warp (4 A x 4 B fragments), 16 warps a SM.
MMA_RATE_SOURCE = r'''
#include <cuda_runtime.h>
#include <cstdint>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2],
                                    const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}
// MODE 0: one mma a tile; 1: three chained into the accumulator; 2: three
// chained from zero into a partial that joins the accumulator by f32 adds
template <int MODE>
__global__ void __launch_bounds__(256, 2)
rate_kernel(float* out, int iters, uint32_t seed) {
  float acc[4][4][4];
  uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
      ah[i][j] = seed * (threadIdx.x + i * 4 + j);
      al[i][j] = ah[i][j] >> 3;
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) {
      bh[i][j] = seed * (threadIdx.x + 77 + i * 2 + j);
      bl[i][j] = bh[i][j] >> 5;
    }
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (MODE == 0) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], ah[mi], bh[ni], acc[mi][ni]);
      } else if (MODE == 1) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], al[mi], bh[ni], acc[mi][ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], ah[mi], bl[ni], acc[mi][ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], ah[mi], bh[ni], acc[mi][ni]);
      } else {
        float part[4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(part[ni], al[mi], bh[ni], zero);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(part[ni], ah[mi], bl[ni], part[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(part[ni], ah[mi], bh[ni], part[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[ni][r];
      }
    }
    ah[it & 3][0] ^= it;  // nothing is loop invariant
    bh[it & 3][1] += it;
  }
  float s = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) s += acc[i][j][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of `iters` iterations on `blocks` blocks of 8 warps
extern "C" float mma_rate_ms(int mode, int blocks, int iters, float* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int pass = 0; pass < 2; ++pass) {
    const int n = pass ? iters : 100;
    if (pass) cudaEventRecord(e0);
    if (mode == 0) rate_kernel<0><<<blocks, 256>>>(out, n, 3u);
    if (mode == 1) rate_kernel<1><<<blocks, 256>>>(out, n, 3u);
    if (mode == 2) rate_kernel<2><<<blocks, 256>>>(out, n, 3u);
  }
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
'''


def _patch(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"patch no longer applies: {old[:60]!r}")
    return text.replace(old, new)


def variants():
    """{name: source text} of the variants, from csrc/dense_mm.cu."""
    src = dk.SOURCE.read_text()
    limit = "constexpr int CHAIN_MAX_K = 320;"
    chained = _patch(src, limit, "constexpr int CHAIN_MAX_K = 1 << 30;")
    refill = "    if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);\n"
    stage_a = "s_a + (t % STAGES) * TILE_FLOATS + a_off"
    stage_b = "s_b + (t % STAGES) * TILE_FLOATS + b_off"
    no_copies = _patch(src, refill, refill.replace(
        "n_tiles)", "n_tiles && K < 0)"))
    no_copies = _patch(no_copies, stage_a, stage_a.replace(
        "% STAGES", "% (STAGES - 1)"))
    no_copies = _patch(no_copies, stage_b, stage_b.replace(
        "% STAGES", "% (STAGES - 1)"))
    bounds = ("template <bool AK, bool BKC, bool ROUNDED>\n"
              "__global__ void __launch_bounds__(THREADS, 2)")
    return {
        "as_is": src,
        "rounded_sums": _patch(src, limit, "constexpr int CHAIN_MAX_K = 0;"),
        "chained_sums": chained,
        "one_product": _patch(_patch(chained, CHAINED, ONE_PRODUCT), SPLIT,
                              NO_SPLIT),
        "no_copies": no_copies,
        "cvt_split": _patch(src, SPLIT, CVT_SPLIT),
        "one_block_a_sm": _patch(src, bounds, bounds.replace(", 2)", ", 1)")),
    }


def _nvcc(name, text, suffix=".cu"):
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}{suffix}"
    src.write_text(text)
    lib = out_dir / f"{name}.so"
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    return ctypes.CDLL(str(lib))


def _median_ms(fn, runs=15):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)   # the host enqueues behind a spin
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main():
    if not torch.cuda.is_available():
        print("dense_variants: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    texts = variants()
    with ThreadPoolExecutor(len(texts) + 1) as pool:
        rate_job = pool.submit(_nvcc, "mma_rate", MMA_RATE_SOURCE)
        libs = dict(zip(texts, pool.map(_nvcc, texts, texts.values())))
        rate = rate_job.result().mma_rate_ms

    # what mma.sync sustains: 2 blocks of 8 warps on each of the SMs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
    rate.restype = ctypes.c_float
    sink = torch.empty(2 * sms * 256, device=dev)
    iters = 4000
    for mode, what in enumerate(("one mma a tile", "three chained",
                                 "three chained from zero + f32 adds")):
        ms = rate(mode, 2 * sms, iters, sink.data_ptr())
        mmas = 2 * sms * 8 * iters * 16 * (1 if mode == 0 else 3)
        emit(phase="mma_rate", pattern=what, ms=ms,
             tf32_tflops=2 * 1024 * mmas / ms / 1e9,
             ns_per_mma_per_subpartition=1e6 * ms / (mmas / (4 * sms)))

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    gen = torch.Generator(device=dev).manual_seed(0)
    checked = ("as_is", "rounded_sums", "chained_sums", "cvt_split",
               "one_block_a_sm")
    for K, N in SHAPES:
        x = torch.randn((POINTS, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.1
        g = torch.randn((POINTS, N), generator=gen, device=dev)
        for kind, A, B in (("fwd", x, w), ("dx", g, w.t()),
                           ("dw", x.t(), g)):
            M, Kk = A.shape
            Nn = B.shape[1]
            splits, chunk = dk.split_plan(M, Nn, Kk)
            out = torch.empty((M, Nn), device=dev)
            scratch = (torch.empty((splits, M, Nn), device=dev)
                       if splits > 1 else None)
            ref = torch.matmul(A.double(), B.double())
            lib_ms = _median_ms(lambda: torch.matmul(A, B))
            lib_err = ((torch.matmul(A, B) - ref).abs().max()
                       / ref.abs().max()).item()
            emit(phase="variant", variant="torch.matmul", what=kind, K=K,
                 N=N, points=POINTS, ms=lib_ms, err_vs_f64=lib_err)
            for name, lib in libs.items():
                fn = lib.dense_mm_cuda
                fn.argtypes = [p, p, i, p, i, p, p, i, i, i, ll, ll, ll, ll,
                               i, i, i, p]
                fn.restype = i

                def run():
                    err = fn(A.data_ptr(), B.data_ptr(), 0, None, 0,
                             out.data_ptr(),
                             scratch.data_ptr() if splits > 1 else None,
                             M, Nn, Kk, A.stride(0), A.stride(1),
                             B.stride(0), B.stride(1), splits, chunk,
                             dk.ROUTES["tf32x3"],
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                ms = _median_ms(run)
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                emit(phase="variant", variant=name, what=kind, K=K, N=N,
                     points=POINTS, splits=splits, ms=ms,
                     err_vs_f64=err if name in checked else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
