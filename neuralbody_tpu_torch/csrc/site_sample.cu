// The plan-free render's site-feature sampler, all four levels in one
// launch, for Hopper (sm_90a): site_trilinear_kernel.
//
// Replaces no Pallas kernel. The JAX package's site_trilinear_sample
// (neuralbody_tpu/ops/sparse_conv.py) is plain jnp, left to XLA to fuse.
// The port's plain version (ops/sparse_conv.site_trilinear_sample, once a
// level, then a concatenation of the levels) runs on the card as ~110 small
// launches a level: three passes of floor, clamp, compare and mask over the
// axes, eight two-step gathers, eight multiply-adds over the whole [N, C]
// f32 tensor in device memory and a copy of the feature table to add its
// zero row. Over the 32 chunks of a 512^2 image of the latent_xyzc_313
// render (2048 rays x 64 samples a chunk, ~4.2M points) that is ~14k
// launches and on the order of 150-200 ms of device time an image (about
// half of it), where the function's one unavoidable cost, writing the
// [N, 352] f32 output, is 5.9 GB an image: ~1.8 ms at 3.35 TB/s, 0.055 ms a
// chunk.
//
// For each point n and level l (C_l = 32, 64, 128, 128 channels):
//
//   pos_a = dhw[n, a] * ((size_l[a] - 1) / out_sh[a])         (a = d, h, w)
//   out[n, off_l + c] = sum over the 8 corners k of  w_k * feats_l[row_k, c]
//   w_k   = (w_d * w_h) * w_w,  each axis weight (1 - t) or t, t the
//           fraction of pos_a, and 0 for a corner outside the volume
//   row_k = index_vol_l[corner], a row of feats_l; cap_l (an empty voxel)
//           reads a zero row
//
// with the plain version's f32 arithmetic, operation for operation: the
// floor clipped in float to [-2, size] before the cast (so far-off points
// stay defined), the weights multiplied in that order, the corners summed
// z, then y, then x, low corner first, from +0, with __fmul_rn / __fadd_rn
// (no contraction into FMA). A corner of weight zero skips its loads and
// adds +0, where the plain version adds w * f = +-0: the same bits unless
// the feature is not finite. bf16 features are read as stored and upcast,
// which is exact, as the plain version's type promotion does.
//
// What bounds it on an H100: writing the output, 1408 bytes a point. The
// four levels' tables and index volumes of a frame are ~9 MB at the 313
// configuration's shapes (int32 volumes 48x176x64 down to 6x22x8, caps
// 16128 / 9472 / 2816 / 768 rows), so they stay in the 50 MB L2 and each
// point's 32 index reads and up to 32 row reads (11 KB) come from L2 or L1.
//
// Design. A warp owns a point; eight warps of a block own eight
// consecutive points, which are neighbouring samples of one ray and share
// most corners at the coarse levels (L1 hits). Lane j computes corner j % 8
// of level j / 8: its three axis weights, its weight and, where that is not
// zero, its index-volume read: the 32 (row, weight) pairs of a point come
// from one round of loads, each computed once. Then, a level at a time,
// every lane takes the level's 8 pairs by shuffles (warp-uniform, no
// divergence), starts the 8 row loads at once (C / 32 = 1, 2, 4, 4
// channels a lane: one 4- to 16-byte load a row) and sums them in order.
// The warp writes the point's 352 channels as one contiguous 1408-byte run,
// the four levels' columns side by side (a float, float2, float4 and float4
// a lane; streaming stores, so the tables keep their place in L2): no
// concatenation of levels and no padded copy of a table. 32 registers a
// thread in f32, 56 in bf16, no spills.
//
// Measured on an H100 80GB HBM3 at 700 W, one 2048-ray chunk (131,072
// points) at the 313 cell's level shapes: 0.115 ms with f32 features and
// 0.143 ms with bf16 ones, 2.1x and 2.6x the output write's 0.055 ms,
// against 6.9 / 7.3 ms for the plain version; equal bits to it in both
// (tools/site_sample_cost.py; PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LEVELS = 4;
constexpr int OUT_C = 352;                  // 32 + 64 + 128 + 128
constexpr int THREADS = 256;                // 8 warps: 8 points a block

struct Level {
  const void* feats;     // [cap, C] f32 or bf16, rows 16-byte aligned
  const int* ivol;       // [D, H, W] int32 rows of feats, cap = empty
  int size[3];           // D, H, W
  int cap;
  float scale[3];        // (size - 1) / out_sh, rounded to f32
};

struct Args {
  Level lv[LEVELS];
  const float* dhw;      // [n, 3]
  float* out;            // [n, OUT_C]
  long long n;
};

// CPL channels of row r, lane `lane`, as f32; zeros when skip
template <int CPL>
__device__ __forceinline__ void load_row(float (&v)[CPL], const float* f,
                                         long long r, int lane, bool skip) {
  const float* p = f + r * (32 * CPL) + lane * CPL;
  if constexpr (CPL == 4) {
    const float4 x = skip ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (CPL == 2) {
    const float2 x =
        skip ? make_float2(0.f, 0.f) : __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = skip ? 0.f : __ldg(p);
  }
}
template <int CPL>
__device__ __forceinline__ void load_row(float (&v)[CPL],
                                         const __nv_bfloat16* f, long long r,
                                         int lane, bool skip) {
  const __nv_bfloat16* p = f + r * (32 * CPL) + lane * CPL;
  if constexpr (CPL == 4) {
    const uint2 u =
        skip ? make_uint2(0u, 0u) : __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else if constexpr (CPL == 2) {
    const unsigned u =
        skip ? 0u : __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    v[0] = a.x, v[1] = a.y;
  } else {
    const unsigned short u =
        skip ? static_cast<unsigned short>(0)
             : __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&u));
  }
}

template <int CPL>
__device__ __forceinline__ void store_run(float* o, const float (&a)[CPL]) {
  if constexpr (CPL == 4) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (CPL == 2) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(a[0], a[1]));
  } else {
    __stcs(o, a[0]);
  }
}

// One level's 8 corners, whose (row, weight) lanes 8 L .. 8 L + 7 hold,
// summed into this lane's CPL channels and written at column `off`.
template <typename T, int L, int CPL>
__device__ __forceinline__ void level_sum(const void* feats_l, int cap,
                                          int row, float w, int lane,
                                          float* out_row, int off) {
  const T* feats = static_cast<const T*>(feats_l);
  int rk[8];
  float wk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    rk[k] = __shfl_sync(0xffffffffu, row, 8 * L + k);
    wk[k] = __shfl_sync(0xffffffffu, w, 8 * L + k);
  }
  float v[8][CPL];
#pragma unroll
  for (int k = 0; k < 8; ++k)   // all 8 loads in flight before the sum
    load_row<CPL>(v[k], feats, rk[k], lane,
                  wk[k] == 0.f || static_cast<unsigned>(rk[k]) >=
                                      static_cast<unsigned>(cap));
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(v[k][c], wk[k]));
  store_run<CPL>(out_row + off + lane * CPL, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    site_trilinear_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long n =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (n >= a.n) return;   // warp-uniform

  // this lane's corner: level lane / 8, corner bits (z, y, x) = lane % 8
  const int lvl = lane >> 3;
  Level lv = a.lv[0];
#pragma unroll
  for (int l = 1; l < LEVELS; ++l)
    if (l == lvl) lv = a.lv[l];
  float wa[3];
  int ia[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float f = __fmul_rn(__ldg(a.dhw + 3 * n + ax), lv.scale[ax]);
    const float f0 = floorf(f);
    const float t = __fsub_rn(f, f0);
    const int size = lv.size[ax];
    const int bit = (lane >> (2 - ax)) & 1;
    const int i = static_cast<int>(fminf(fmaxf(f0, -2.f),
                                         static_cast<float>(size))) + bit;
    const bool valid = i >= 0 && i < size;
    wa[ax] = __fmul_rn(bit ? t : __fsub_rn(1.f, t), valid ? 1.f : 0.f);
    ia[ax] = min(max(i, 0), size - 1);
  }
  const float w = __fmul_rn(__fmul_rn(wa[0], wa[1]), wa[2]);
  const int row =
      w == 0.f ? lv.cap
               : __ldg(lv.ivol + (ia[0] * lv.size[1] + ia[1]) * lv.size[2] +
                       ia[2]);

  float* out_row = a.out + n * OUT_C;
  level_sum<T, 0, 1>(a.lv[0].feats, a.lv[0].cap, row, w, lane, out_row, 0);
  level_sum<T, 1, 2>(a.lv[1].feats, a.lv[1].cap, row, w, lane, out_row, 32);
  level_sum<T, 2, 4>(a.lv[2].feats, a.lv[2].cap, row, w, lane, out_row, 96);
  level_sum<T, 3, 4>(a.lv[3].feats, a.lv[3].cap, row, w, lane, out_row, 224);
}

}  // namespace

// dhw [n, 3] f32, out [n, 352] f32, both contiguous and 16-byte aligned;
// per level l (0..3): feats[l] [caps[l], C_l] (C = 32, 64, 128, 128), f32
// or (bf16 != 0) bf16, contiguous, 16-byte aligned; ivols[l] [sizes[3 l ..
// 3 l + 2]] int32, contiguous, entries in [0, caps[l]]; out_sh the
// full-resolution grid (D, H, W). Launches on `stream`; returns the launch's
// cudaGetLastError (cudaErrorInvalidValue for arguments it refuses).
extern "C" int site_trilinear_cuda(const void* dhw, long long n,
                                   const void* const* feats, int bf16,
                                   const void* const* ivols, const int* sizes,
                                   const int* caps, const int* out_sh,
                                   void* out, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  for (int l = 0; l < LEVELS; ++l) {
    if (reinterpret_cast<uintptr_t>(feats[l]) % 16 != 0 || caps[l] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    a.lv[l].feats = feats[l];
    a.lv[l].ivol = static_cast<const int*>(ivols[l]);
    a.lv[l].cap = caps[l];
    for (int ax = 0; ax < 3; ++ax) {
      const int s = sizes[3 * l + ax];
      if (s <= 0 || out_sh[ax] <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
      a.lv[l].size[ax] = s;
      // as torch multiplies by the Python float (size - 1) / out_sh: the
      // double's quotient rounded to f32
      a.lv[l].scale[ax] = static_cast<float>(static_cast<double>(s - 1) /
                                             static_cast<double>(out_sh[ax]));
    }
  }
  a.dhw = static_cast<const float*>(dhw);
  a.out = static_cast<float*>(out);
  a.n = n;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    site_trilinear_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(a);
  else
    site_trilinear_kernel<float>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
