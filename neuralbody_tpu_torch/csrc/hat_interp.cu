// Fused hat-basis interpolation of one level, forward and backward, for
// Hopper (sm_90a).
//
// ---- forward: hat_interp_level_cuda --------------------------------------
//
// Replaces neuralbody_tpu/ops/pallas_hat.py:_fwd_kernel, and goes further:
// it computes the whole of hat_interp_level (neuralbody_tpu/ops/
// hat_interp.py), the row gathers included. For each group g and point p:
//
//   out[g, p, :] = sum_r  w(g, p, r) * feats[rows[g, r], :]
//   w(g, p, r)   = prod_a max(0, 1 - |pos[g, p, a] - sites[rows[g, r], a]|)
//
// A row equal to capS is the sentinel: it contributes exactly 0 (the JAX
// side reads a zero feature row at coordinate 1e9), so it is skipped.
//
// Two modes, chosen by the features' type:
//   bf16 features: w is rounded to bf16 and multiplied by the bf16 feature,
//                  summed in f32 (the product of two bf16 values is exact in
//                  f32, so this is the TPU's bf16 x bf16 -> f32 contraction);
//   f32 features:  exact f32 weights, f32 FMA.
//
// What bounds it on an H100: writing the f32 output, 118.4 MB per render
// over the four levels at the reference working point (657 groups x 128
// points x 352 channels x 4 bytes), ~35 us at 3.35 TB/s. The tensor-core
// work of the dense contraction, ~10 GFLOP, is ~10 us at 989 TFLOP/s bf16.
//
// Design (simple first): one block per group; a thread owns one point and
// CPT consecutive channels, so C = 128 splits over C/CPT threads and the
// sum stays in registers without spilling. The group's rows stream through
// shared memory in tiles of TILE_R rows (gathered coordinates and
// features), so neither the gathered features nor the weights ever reach
// device memory. A row whose weight is 0 for every point of a warp costs
// only the weight; most rows are, since a point touches at most 8 cells.
// The output may be a column slice of a wider row (out_stride), so the
// four levels fill one [ngrp, P, 352] buffer without a concatenation.
//
// ---- backward: hat_interp_level_bwd_cuda ---------------------------------
//
// Replaces neuralbody_tpu/ops/pallas_hat.py:_bwd_kernel, and goes further:
// it computes the whole gradient of hat_interp_level with respect to the
// features, the scatter of d_rf back through the row lists included:
//
//   d_feats[rows[g, r], :] += sum_p  w(g, p, r) * grad[g, p, :]
//
// with the same w as the forward (bf16-rounded in bf16 mode, then
// multiplied in f32 by the f32 cotangent with f32 accumulation, as
// _bwd_kernel does; exact f32 w in f32 mode). Sentinel and out-of-range
// rows are skipped: in the reference they scatter into the dropped pad row.
// Neither the gathered d_rf nor the [ngrp, P, capR] weights reach device
// memory. Rows repeat across groups, so each (row, 32 channels) sum lands
// with one coalesced run of 32 float atomicAdds; their order changes from
// run to run, the only nondeterminism (f32 rounding of the sum).
//
// What bounds it on an H100: reading the f32 cotangent, 118.4 MB per step
// over the four levels at the reference working point (10.8 / 21.5 / 43.1 /
// 43.1 MB), plus pos, rows and the used sites, and writing the [capS, C]
// f32 output: ~132 MB, ~39 us at 3.35 TB/s.
//
// Design (simple first): one block per (group, 32-channel slice). The
// group's positions and its 32-channel slice of the cotangent are staged
// in shared memory (P x 32 floats, read through the row stride, so the
// cotangent may be a column slice of the [ngrp, P, 352] gradient). Each
// warp takes a run of rows; for a row, lane l builds the weight of points
// l, l+32, ..., a ballot finds the nonzero ones (warp-uniform), and each
// nonzero weight is broadcast to the lanes, which own one channel each.
// A point touches at most 8 cells, so most rows cost only their weights.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_R = 32;
constexpr int CPT = 32;  // channels per thread; every level's C is a multiple

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The weight as the contraction's operand: bf16-rounded in bf16 mode.
__device__ __forceinline__ float weight_operand(float w, const float*) {
  return w;
}
__device__ __forceinline__ float weight_operand(float w,
                                                const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

template <typename T>
__global__ void hat_interp_kernel(const T* __restrict__ feats,
                                  const int* __restrict__ sites,
                                  const int* __restrict__ rows,
                                  const float* __restrict__ pos,
                                  float* __restrict__ out, int P, int capR,
                                  int capS, int C, long long out_stride) {
  extern __shared__ float smem[];
  float* s_feat = smem;                          // [TILE_R][C]
  float* s_coord = smem + TILE_R * C;            // [TILE_R][3]
  int* s_row = reinterpret_cast<int*>(s_coord + TILE_R * 3);  // [TILE_R]

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = tid % P;
  const int c0 = (tid / P) * CPT;
  const bool active = tid < P * (C / CPT);

  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float* pp = pos + (g * P + p) * 3;
    px = pp[0];
    py = pp[1];
    pz = pp[2];
  }
  float acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0.f;

  const int* grow = rows + g * capR;
  for (int r0 = 0; r0 < capR; r0 += TILE_R) {
    const int nr = min(TILE_R, capR - r0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < TILE_R; i += blockDim.x) {
      const int r = i < nr ? grow[r0 + i] : capS;
      const bool valid = r >= 0 && r < capS;
      s_row[i] = valid ? r : -1;
      const int* sc = sites + 3LL * (valid ? r : 0);
      s_coord[i * 3 + 0] = valid ? static_cast<float>(sc[0]) : 1e9f;
      s_coord[i * 3 + 1] = valid ? static_cast<float>(sc[1]) : 1e9f;
      s_coord[i * 3 + 2] = valid ? static_cast<float>(sc[2]) : 1e9f;
    }
    __syncthreads();
    for (int i = tid; i < TILE_R * C; i += blockDim.x) {
      const int r = s_row[i / C];
      s_feat[i] = r >= 0 ? to_f32(feats[static_cast<long long>(r) * C + i % C])
                         : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < nr; ++i) {
        if (s_row[i] < 0) continue;  // sentinel: contributes exactly 0
        float w = fmaxf(0.f, 1.f - fabsf(px - s_coord[i * 3 + 0]));
        w = w * fmaxf(0.f, 1.f - fabsf(py - s_coord[i * 3 + 1]));
        w = w * fmaxf(0.f, 1.f - fabsf(pz - s_coord[i * 3 + 2]));
        if (w != 0.f) {
          const float wo = weight_operand(w, feats);
          const float* f = s_feat + i * C + c0;
#pragma unroll
          for (int k = 0; k < CPT; ++k) acc[k] = fmaf(wo, f[k], acc[k]);
        }
      }
    }
  }
  if (active) {
    float* o = out + (g * P + p) * out_stride + c0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) o[k] = acc[k];
  }
}

template <typename T>
void launch(const void* feats, const void* sites, const void* rows,
            const void* pos, void* out, int ngrp, int P, int capR, int capS,
            int C, long long out_stride, cudaStream_t stream) {
  const int threads = (P * (C / CPT) + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (TILE_R * C + TILE_R * 3) +
                      sizeof(int) * TILE_R;
  hat_interp_kernel<T><<<ngrp, threads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(sites),
      static_cast<const int*>(rows), static_cast<const float*>(pos),
      static_cast<float*>(out), P, capR, capS, C, out_stride);
}

constexpr int BWD_THREADS = 256;

template <bool BF16>
__global__ void hat_interp_bwd_kernel(const float* __restrict__ grad,
                                      long long grad_stride,
                                      const int* __restrict__ sites,
                                      const int* __restrict__ rows,
                                      const float* __restrict__ pos,
                                      float* __restrict__ d_feats, int P,
                                      int capR, int capS, int C) {
  extern __shared__ float smem[];
  float* s_grad = smem;            // [P][32]
  float* s_pos = smem + P * 32;    // [P][3]

  const long long g = blockIdx.x;
  const int c0 = blockIdx.y * 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < P * 32; i += blockDim.x) {
    const int p = i >> 5;
    s_grad[i] = grad[(g * P + p) * grad_stride + c0 + (i & 31)];
  }
  for (int i = tid; i < P * 3; i += blockDim.x) s_pos[i] = pos[g * P * 3 + i];
  __syncthreads();

  const int* grow = rows + g * capR;
  for (int r = warp; r < capR; r += nwarps) {
    const int row = grow[r];
    if (row < 0 || row >= capS) continue;  // sentinel: no feature row
    const float sx = static_cast<float>(sites[3LL * row + 0]);
    const float sy = static_cast<float>(sites[3LL * row + 1]);
    const float sz = static_cast<float>(sites[3LL * row + 2]);
    float acc = 0.f;
    bool touched = false;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + lane;
      float w = 0.f;
      if (p < P) {
        const float* pp = s_pos + p * 3;
        w = fmaxf(0.f, 1.f - fabsf(pp[0] - sx));
        w = w * fmaxf(0.f, 1.f - fabsf(pp[1] - sy));
        w = w * fmaxf(0.f, 1.f - fabsf(pp[2] - sz));
        if (BF16) w = __bfloat162float(__float2bfloat16_rn(w));
      }
      unsigned nz = __ballot_sync(0xffffffffu, w != 0.f);
      touched |= nz != 0u;
      while (nz) {
        const int src = __ffs(nz) - 1;
        nz &= nz - 1u;
        const float wv = __shfl_sync(0xffffffffu, w, src);
        acc = fmaf(wv, s_grad[(p0 + src) * 32 + lane], acc);
      }
    }
    if (touched)
      atomicAdd(d_feats + static_cast<long long>(row) * C + c0 + lane, acc);
  }
}

}  // namespace

// feats [capS, C] (bf16 if feats_bf16 else f32), sites [capS, 3] int32,
// rows [ngrp, capR] int32, pos [ngrp, P, 3] f32 -> out rows of out_stride
// floats, [ngrp, P, C] in the first C of each. All contiguous except out.
// C is a multiple of CPT and P * C / CPT <= 1024.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hat_interp_level_cuda(const void* feats, int feats_bf16,
                                     const void* sites, const void* rows,
                                     const void* pos, void* out, int ngrp,
                                     int P, int capR, int capS, int C,
                                     long long out_stride, void* stream) {
  if (C <= 0 || C % CPT != 0 || ngrp <= 0 || P <= 0 || capR <= 0 ||
      P * (C / CPT) > 1024 || out_stride < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16)
    launch<__nv_bfloat16>(feats, sites, rows, pos, out, ngrp, P, capR, capS,
                          C, out_stride, s);
  else
    launch<float>(feats, sites, rows, pos, out, ngrp, P, capR, capS, C,
                  out_stride, s);
  return static_cast<int>(cudaGetLastError());
}

// grad rows of grad_stride floats, [ngrp, P, C] in the first C of each;
// sites [capS, 3] int32, rows [ngrp, capR] int32, pos [ngrp, P, 3] f32, all
// contiguous -> d_feats [capS, C] f32, contiguous and zeroed by the caller,
// which this ADDS into. bf16 selects bf16-rounded weights. C is a multiple
// of 32 and P * 35 floats fit the default 48 KB of shared memory.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hat_interp_level_bwd_cuda(const void* grad,
                                         long long grad_stride, int bf16,
                                         const void* sites, const void* rows,
                                         const void* pos, void* d_feats,
                                         int ngrp, int P, int capR, int capS,
                                         int C, void* stream) {
  const size_t smem = sizeof(float) * P * (32 + 3);
  if (C <= 0 || C % 32 != 0 || ngrp <= 0 || P <= 0 || capR <= 0 ||
      capS <= 0 || grad_stride < C || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ngrp, C / 32);
  const float* g = static_cast<const float*>(grad);
  const int* si = static_cast<const int*>(sites);
  const int* ro = static_cast<const int*>(rows);
  const float* po = static_cast<const float*>(pos);
  float* out = static_cast<float*>(d_feats);
  if (bf16)
    hat_interp_bwd_kernel<true><<<grid, BWD_THREADS, smem, s>>>(
        g, grad_stride, si, ro, po, out, P, capR, capS, C);
  else
    hat_interp_bwd_kernel<false><<<grid, BWD_THREADS, smem, s>>>(
        g, grad_stride, si, ro, po, out, P, capR, capS, C);
  return static_cast<int>(cudaGetLastError());
}
