// Gather-fused sparse convolution for Hopper (sm_90a).
//
// Replaces the three TPU probe kernels that compute a sparse conv with the
// row gather inside the kernel:
//   tools/probes/pallas_gather.py:25          pallas_conv
//   tools/probes/indexed_ops.py:122           probe_pallas.pallas_conv
//   tools/probes/pallas_dconv_scatter.py:50   probe_pgather.pconv
// and, in the port, the index_select + bmm + tap-sum of every conv of the
// encoder (submanifold, w-triple packed and strided, forward and dx).
//
// For one batch element:
//
//   out[s, :] = sum_{k < K}  T[idx[k, s], :] @ W[k]
//
// T [n_rows, E] f32 or bf16, idx [K, S] int32 tap-major, W [K, E, Cout] f32
// (already rounded to T's type by the caller), out [S, Cout] f32, the sum
// in f32. An index outside [0, n_rows) reads a row of zeros: the zero row
// the tables point missing neighbours at is never materialized. A leading
// batch dimension is grid.z with per-element strides.
//
// The probes gather the [BLK, 27 C] block into fast memory and hand one
// [BLK, 27 C] x [27 C, Cout] product to the matrix unit. Here the same
// product is a loop over (tap, 16-deep chunk of E) inside the block: the
// gathered chunk and the matching slice of W[k] are staged in shared
// memory and multiplied out of registers, so the [K, S, E] gather never
// reaches device memory.
//
// What bounds it on an H100: one full-width encode (17 layers, site caps
// 6656 / 16128 / 9984 / 3072 / 1024, channels 16..128) is ~23 GFLOP if
// every tap is counted and ~16.5 GFLOP at the indices that name a row,
// over under 0.1 GB of compulsory bytes. With f32 operands on the CUDA
// cores (67 TFLOP/s) that is operations, ~0.25 ms; with bf16 operands the
// tensor-core rate (989 TFLOP/s) would make it bytes, ~0.03 ms. This
// kernel multiplies in f32 in both modes (a bf16 value and the product of
// two are exact in f32), so the f32 figure is the one it can approach.
//
// Design: the encoder's deep levels have few sites (3072 and 1024) and a
// long reduction (K E = 3456), so a block that walks the reduction alone
// leaves most of the card waiting on one chain of dependent loads. Here a
// block of 8 warps owns a small tile, 32 sites x CT channels (CT = 16 for
// Cout = 16, else 32, the channel blocks in grid.y), and splits the
// reduction inside the block: the (tap, 16-deep chunk of E) steps go round
// robin to the warps, each warp stages its own chunk in its own shared
// memory (no block barrier in the loop), keeps a partial sum of the whole
// tile in registers (a lane 4 sites x CT/4 channels), and the eight
// partials are summed through shared memory in warp order at the end. The
// order of every sum is fixed, so the result is deterministic.
// Per step a warp reads its tile's 32 indices of the tap in one coalesced
// load (the table is tap-major) and hands them round by shuffle; a tap
// that no site of the tile has is skipped whole; each
// gathered row piece is one 16-byte (f32) or 8-byte (bf16) load, four
// lanes to a row, stored transposed ([e][site], padded) so that the inner
// loop reads one float4 of four sites and CT/16 float4 of channels per
// CT FMAs. wgmma, TMA and bf16 tensor-core products are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int EK = 16;        // depth of one staged chunk; E is a multiple
constexpr int TS = 32;        // sites per block
constexpr int TSP = TS + 4;   // padded row of the transposed chunk
constexpr int SPT = 4;        // sites per lane (8 lanes across the sites)
constexpr unsigned FULL = 0xffffffffu;

// Four consecutive elements of a table row, as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 value is the high half of the f32 of the same value
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

template <typename T, int CT>
__global__ void __launch_bounds__(THREADS)
sparse_conv_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out,
                   int n_rows, int E, int K, int S, int Cout,
                   long long table_bstride) {
  constexpr int CPT = CT / 4;              // channels per lane (4 lanes across)
  constexpr int STAGE = EK * TSP + EK * CT;  // one warp's chunk: rows, weights
  static_assert(WARPS * STAGE >= WARPS * TS * CT, "partials reuse the stages");
  __shared__ __align__(16) float smem[WARPS * STAGE];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sg = lane / 4;   // sites 4 sg .. 4 sg + 3
  const int cg = lane % 4;   // channels cg CPT .. cg CPT + CPT - 1
  const int s0 = blockIdx.x * TS;
  const int c0 = blockIdx.y * CT;
  const long long b = blockIdx.z;
  table += b * table_bstride;
  idx += b * K * S;
  out += b * S * Cout;
  float* s_a = smem + warp * STAGE;   // [EK][TSP] gathered rows, [e][site]
  float* s_w = s_a + EK * TSP;        // [EK][CT]  W[k][e0 + e][c0 + c]

  float acc[SPT][CPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int chunks = E / EK;
  for (int step = warp; step < K * chunks; step += WARPS) {
    const int k = step / chunks;
    const int e0 = (step % chunks) * EK;
    const int my_row =
        s0 + lane < S ? idx[static_cast<long long>(k) * S + s0 + lane] : -1;
    // a tap that none of the tile's sites has adds nothing (warp-uniform)
    if (!__any_sync(FULL, my_row >= 0 && my_row < n_rows)) continue;
    const float* kw = w + (static_cast<long long>(k) * E + e0) * Cout + c0;
    __syncwarp();  // the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < TS * (EK / 4) / 32; ++j) {
      const int item = j * 32 + lane;
      const int site = item / (EK / 4);
      const int q = item % (EK / 4);
      const int row = __shfl_sync(FULL, my_row, site);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row >= 0 && row < n_rows)
        v = load4(table + static_cast<long long>(row) * E + e0 + 4 * q);
      s_a[(4 * q + 0) * TSP + site] = v.x;
      s_a[(4 * q + 1) * TSP + site] = v.y;
      s_a[(4 * q + 2) * TSP + site] = v.z;
      s_a[(4 * q + 3) * TSP + site] = v.w;
    }
#pragma unroll
    for (int j = 0; j < EK * (CT / 4) / 32; ++j) {
      const int item = j * 32 + lane;
      const int e = item / (CT / 4);
      const int c = (item % (CT / 4)) * 4;
      *reinterpret_cast<float4*>(&s_w[e * CT + c]) =
          *reinterpret_cast<const float4*>(
              kw + static_cast<long long>(e) * Cout + c);
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < EK; ++e) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(&s_a[e * TSP + sg * SPT]);
      const float a[SPT] = {a4.x, a4.y, a4.z, a4.w};
      float ww[CPT];
#pragma unroll
      for (int m = 0; m < CPT / 4; ++m) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            &s_w[e * CT + cg * CPT + 4 * m]);
        ww[4 * m + 0] = w4.x;
        ww[4 * m + 1] = w4.y;
        ww[4 * m + 2] = w4.z;
        ww[4 * m + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < SPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = fmaf(a[i], ww[j], acc[i][j]);
    }
  }

  // The warps' partial tiles, [warp][site][channel], over the stages.
  __syncthreads();  // every warp is done with its stage
  float* red = smem + warp * (TS * CT);
#pragma unroll
  for (int i = 0; i < SPT; ++i)
#pragma unroll
    for (int m = 0; m < CPT / 4; ++m)
      *reinterpret_cast<float4*>(
          &red[(sg * SPT + i) * CT + cg * CPT + 4 * m]) =
          make_float4(acc[i][4 * m], acc[i][4 * m + 1], acc[i][4 * m + 2],
                      acc[i][4 * m + 3]);
  __syncthreads();
  for (int o = threadIdx.x * 4; o < TS * CT; o += THREADS * 4) {
    float4 sum = *reinterpret_cast<const float4*>(&smem[o]);
#pragma unroll
    for (int wp = 1; wp < WARPS; ++wp) {
      const float4 p =
          *reinterpret_cast<const float4*>(&smem[wp * (TS * CT) + o]);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const int s = s0 + o / CT;
    if (s < S)
      *reinterpret_cast<float4*>(out + static_cast<long long>(s) * Cout + c0 +
                                 o % CT) = sum;
  }
}

template <typename T, int CT>
void launch_ct(const void* table, const void* idx, const void* w, void* out,
               int B, int n_rows, int E, int K, int S, int Cout,
               long long table_bstride, cudaStream_t stream) {
  const dim3 grid((S + TS - 1) / TS, Cout / CT, B);
  sparse_conv_kernel<T, CT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), n_rows, E, K, S,
      Cout, table_bstride);
}

template <typename T>
void launch(const void* table, const void* idx, const void* w, void* out,
            int B, int n_rows, int E, int K, int S, int Cout,
            long long table_bstride, cudaStream_t stream) {
  if (Cout == 16)
    launch_ct<T, 16>(table, idx, w, out, B, n_rows, E, K, S, Cout,
                     table_bstride, stream);
  else
    launch_ct<T, 32>(table, idx, w, out, B, n_rows, E, K, S, Cout,
                     table_bstride, stream);
}

}  // namespace

// table: B tables of [n_rows, E] (bf16 if table_bf16 else f32), element b
// at table + b * table_bstride elements, rows contiguous, 16-byte aligned;
// idx [B, K, S] int32; w [K, E, Cout] f32; out [B, S, Cout] f32; the last
// three contiguous and 16-byte aligned. E is a multiple of 16, Cout one of
// 16, 32, 64, 128, B at most 65535.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sparse_conv_cuda(const void* table, int table_bf16,
                                const void* idx, const void* w, void* out,
                                int B, int n_rows, int E, int K, int S,
                                int Cout, long long table_bstride,
                                void* stream) {
  if (B <= 0 || B > 65535 || n_rows < 0 || E <= 0 || E % EK != 0 || K <= 0 ||
      S <= 0 ||
      !(Cout == 16 || Cout == 32 || Cout == 64 || Cout == 128) ||
      table_bstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    launch<__nv_bfloat16>(table, idx, w, out, B, n_rows, E, K, S, Cout,
                          table_bstride, s);
  else
    launch<float>(table, idx, w, out, B, n_rows, E, K, S, Cout, table_bstride,
                  s);
  return static_cast<int>(cudaGetLastError());
}
