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
// over the four levels at the reference working point (658 groups x 128
// points x 352 channels x 4 bytes), ~35 us at 3.35 TB/s. The feature tables
// (3.4 MB in bf16) live in L2. Under 2% of the (group, point, row) weights
// are nonzero: a point touches at most 8 rows, so the contraction is sparse
// and its arithmetic (~0.5 GFLOP) does not count.
//
// Design. The TPU kernel multiplies a dense [P, capR] hat tile into the
// gathered rows on the matrix unit; here the zeros are never multiplied.
//  * One block of 8 warps per group stages the group's whole row set once:
//    the row ids, the three coordinates of each row (as floats, one array
//    per axis) and the feature rows in their storage type, gathered with
//    16-byte cp.async (a feature row is 64 to 512 bytes). Two barriers per
//    block, none in the loop. A row set that does not fit 200 KB of shared
//    memory goes in several passes, the later ones adding into the output.
//    f32 features at C = 128 need more than the default 48 KB (80 KB at 160
//    rows), which the launch asks for.
//  * A warp owns a point. Its lanes find the rows with a nonzero weight,
//    a ballot collects them (it is warp-uniform: no divergence), each
//    weight and row is broadcast by a shuffle, and the lanes, which own
//    C / 32 neighbouring channels each (one 2- to 16-byte shared load a
//    row), accumulate. The weights of a point are computed once, not once
//    per 32 channels.
//  * The warp writes the point's C channels as one contiguous run of 128 to
//    512 bytes (a float, float2 or float4 a lane). The output may be a
//    column slice of a wider row (out_stride), 16-byte aligned, so the four
//    levels fill one [ngrp, P, 352] buffer without a concatenation.
//  * Finding the rows. "scan": the lanes evaluate the tent weight of 32
//    staged rows at a time, up to the last row that is not a sentinel (800
//    rows a point over the four levels; the sum runs in row order).
//    "lookup": the sites are integer cells, so the only rows with a nonzero
//    weight are those at floor(pos) + {0, 1}^3. The block builds a hash
//    table from cell to staged row in shared memory (open addressing, twice
//    as many slots as rows), and eight lanes look the eight corners of a
//    point up, four points to a warp at once. Two staged rows with the
//    same cell (a row listed twice) cannot be told apart by the table: the
//    block that finds such a pair while building falls back to the scan,
//    so the result is the same function for any input.
//
// Measured on an H100 80GB HBM3 at 700 W, the four levels of a full-width
// render (C = 32 / 64 / 128 / 128, caps of 256 / 288 / 160 / 96 rows, of
// which a group lists 42 to 68 on average): 0.097 ms with bf16 features and
// 0.110 ms with f32 ones, 2.5x and 2.8x the bytes bound (0.038, 0.039 ms),
// against 0.125 / 0.332 ms for torch.bmm of the contraction alone. With the
// scan in place of the lookup: 0.113 / 0.126 ms; the lookup wins at levels
// 1 and 2 (0.019 against 0.024 ms, 0.022 against 0.031) and ties at levels
// 3 and 4, whose groups list fewer rows per point. Each level still takes
// 0.019 ms or more, five times level 1's bound: a block's chain of
// dependent loads (row id, then coordinates and features, then the table)
// is not hidden by the 1.25 waves of blocks; one launch for the four levels
// is untried.
//
// The earlier design (a thread per point and 32 channels, rows in tiles of
// 32 through shared memory in f32, three barriers a tile) wrote 4 bytes a
// lane to 32 different output rows per store, recomputed the weights C / 32
// times and diverged on w != 0; it took 0.67 ms for the four levels, 17.7x
// the bound. The dense contraction on the tensor cores (a hat tile built in
// shared memory for mma.sync) was not built: it does the same scan and 50
// times the arithmetic to save no bytes, and the sparse form met its aim.
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
// memory. Rows repeat across groups; their sums run in one fixed order, so
// two runs give equal bits (float atomics, in an order that changes from
// run to run, let a trained state's bf16 training runs drift apart: the
// graph-vs-eager check's fault 3.2).
//
// What bounds it on an H100: reading the f32 cotangent, 118.4 MB per step
// over the four levels at the reference working point (10.8 / 21.5 / 43.1 /
// 43.1 MB), plus pos, rows and the used sites, and writing the [capS, C]
// f32 output: ~132 MB, ~39 us at 3.35 TB/s.
//
// Design, in two kernels. One block of 8 warps per group, all C channels,
// copies the group's cotangent [P, C] into shared memory once (cp.async; it
// may be a column slice of the [ngrp, P, 352] gradient) and stages the
// group's row ids and coordinates; a warp per staged row weighs every point
// of the group in order (ballot over the nonzero weights; lane l holds
// channels l, l + 32, ...) and writes the row's sum to that (group, slot)'s
// row of a scratch [ngrp * capR, C]. Rows that do not fit 200 KB of shared
// memory beside the cotangent go in several passes; P * (4 C + 12) bytes
// must leave room for four rows. The second kernel, a warp per site, finds
// the slots that list the site in the row ids sorted by one stable sort
// (ops/hat_kernel.sort_rows, all four levels at once) and adds their
// scratch rows in the order of their flat index into d_feats.
// Earlier designs: a block per (group, 32 channels) in which each warp
// walked its rows and weighed every point for each took 0.256 ms for the
// four levels, 6.5x the bound; a block per group that added each corner's
// w * grad into an f32 accumulator [rows, C] in shared memory took 0.158
// ms, its float atomicAdds compare-and-swap loops; a block per group that
// found each point's rows through the forward's cell table, listed them
// per row with integer atomics and added each row into d_feats with float
// atomics took 0.124 ms in both modes on an H100 80GB HBM3 at 700 W (3.2x
// the bound), in an order that changed from run to run. This design: the
// two kernels 0.30 ms and the sort 0.10 ms for the four levels of a step
// (tools: neuralbody_tpu_torch's chip_smoke.py timings; PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The weight as the contraction's operand: bf16-rounded in bf16 mode.
__device__ __forceinline__ float weight_operand(float w, const float*) {
  return w;
}
__device__ __forceinline__ float weight_operand(float w,
                                                const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float tent(float p, float s) {
  return fmaxf(0.f, 1.f - fabsf(p - s));
}

constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_SMEM_BUDGET = 200 * 1024;

// acc += w * f[0 .. CPL), f 4 * CPL (f32) or 2 * CPL (bf16) byte aligned
template <int CPL>
__device__ __forceinline__ void axpy(float (&acc)[CPL], float w,
                                     const float* f) {
  if constexpr (CPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(f);
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  } else if constexpr (CPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(f);
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
  } else {
    acc[0] = fmaf(w, f[0], acc[0]);
  }
}
template <int CPL>
__device__ __forceinline__ void axpy(float (&acc)[CPL], float w,
                                     const __nv_bfloat16* f) {
  if constexpr (CPL == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(f);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    acc[0] = fmaf(w, a.x, acc[0]);
    acc[1] = fmaf(w, a.y, acc[1]);
    acc[2] = fmaf(w, b.x, acc[2]);
    acc[3] = fmaf(w, b.y, acc[3]);
  } else if constexpr (CPL == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f));
    acc[0] = fmaf(w, a.x, acc[0]);
    acc[1] = fmaf(w, a.y, acc[1]);
  } else {
    acc[0] = fmaf(w, __bfloat162float(f[0]), acc[0]);
  }
}

template <int CPL>
__device__ __forceinline__ void load_out(float (&acc)[CPL], const float* o) {
  if constexpr (CPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(o);
    acc[0] = v.x, acc[1] = v.y, acc[2] = v.z, acc[3] = v.w;
  } else if constexpr (CPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(o);
    acc[0] = v.x, acc[1] = v.y;
  } else {
    acc[0] = o[0];
  }
}
template <int CPL>
__device__ __forceinline__ void store_out(const float (&acc)[CPL], float* o) {
  if constexpr (CPL == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (CPL == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    o[0] = acc[0];
  }
}

__device__ __forceinline__ unsigned cell_hash(int x, int y, int z) {
  return static_cast<unsigned>(x) * 73856093u ^
         static_cast<unsigned>(y) * 19349663u ^
         static_cast<unsigned>(z) * 83492791u;
}

// Enters the valid staged rows [0, nr) into the cell -> staged-row table
// (open addressing, table_size = mask + 1 slots, -1 empty); sets *dup when
// two staged rows share a cell, which the table cannot tell apart.
__device__ __forceinline__ void insert_cells(const float* s_x, const float* s_y,
                                             const float* s_z,
                                             const int* s_row, int* s_tab,
                                             unsigned mask, int nr, int* dup) {
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    if (s_row[i] < 0) continue;
    const float x = s_x[i], y = s_y[i], z = s_z[i];
    unsigned h = cell_hash(static_cast<int>(x), static_cast<int>(y),
                           static_cast<int>(z)) & mask;
    while (true) {
      const int old = atomicCAS(&s_tab[h], -1, i);
      if (old == -1) break;
      if (s_x[old] == x && s_y[old] == y && s_z[old] == z) {
        *dup = 1;
        break;
      }
      h = (h + 1) & mask;
    }
  }
}

// Corner c (0..7) of the point (px, py, pz), the cell floor(p) + the bits
// of c: its weight as the contraction's operand (T: the features' type) and
// its staged row, or weight 0 and row -1 where no staged row has that cell.
template <typename T>
__device__ __forceinline__ float corner_weight(float px, float py, float pz,
                                               int c, const float* s_x,
                                               const float* s_y,
                                               const float* s_z,
                                               const int* s_tab,
                                               unsigned mask, int& row) {
  row = -1;
  if (!(fabsf(px) < 1e9f && fabsf(py) < 1e9f && fabsf(pz) < 1e9f)) return 0.f;
  const float cx = floorf(px) + (c & 1);
  const float cy = floorf(py) + ((c >> 1) & 1);
  const float cz = floorf(pz) + (c >> 2);
  float w = tent(px, cx);
  w = w * tent(py, cy);
  w = w * tent(pz, cz);
  if (w == 0.f) return 0.f;
  unsigned h = cell_hash(static_cast<int>(cx), static_cast<int>(cy),
                         static_cast<int>(cz)) & mask;
  while (true) {
    const int t = s_tab[h];
    if (t < 0) return 0.f;  // no staged row at this cell
    if (s_x[t] == cx && s_y[t] == cy && s_z[t] == cz) {
      row = t;
      return weight_operand(w, static_cast<const T*>(nullptr));
    }
    h = (h + 1) & mask;
  }
}

// CPL = C / 32 channels per lane. tile_rows (a multiple of 4) rows are
// staged per pass; table_size is a power of two >= 2 * tile_rows.
template <typename T, int CPL>
__global__ void __launch_bounds__(FWD_THREADS)
hat_interp_kernel(const T* __restrict__ feats, const int* __restrict__ sites,
                  const int* __restrict__ rows, const float* __restrict__ pos,
                  float* __restrict__ out, int P, int capR, int capS,
                  long long out_stride, int tile_rows, int table_size,
                  int lookup) {
  constexpr int C = 32 * CPL;
  constexpr int PIECES = C * sizeof(T) / 16;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_feat = reinterpret_cast<T*>(smem_raw);             // [tile_rows][C]
  float* s_x = reinterpret_cast<float*>(s_feat + tile_rows * C);
  float* s_y = s_x + tile_rows;
  float* s_z = s_y + tile_rows;
  int* s_row = reinterpret_cast<int*>(s_z + tile_rows);   // [tile_rows]
  float* s_pos = reinterpret_cast<float*>(s_row + tile_rows);  // [P][3]
  int* s_tab = reinterpret_cast<int*>(s_pos + 3 * P);     // [table_size]
  int* s_flag = s_tab + table_size;  // [0] rows to scan, [1] duplicate cell

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* grow = rows + g * capR;
  const unsigned mask = table_size - 1;

  for (int i = tid; i < 3 * P; i += FWD_THREADS) s_pos[i] = pos[g * P * 3 + i];

  for (int r0 = 0; r0 < capR; r0 += tile_rows) {
    const int nr = min(tile_rows, capR - r0);
    __syncthreads();  // the previous pass is consumed
    if (tid < 2) s_flag[tid] = 0;
    if (lookup)
      for (int i = tid; i < table_size; i += FWD_THREADS) s_tab[i] = -1;
    __syncthreads();
    for (int i = tid; i < nr; i += FWD_THREADS) {
      const int r = grow[r0 + i];
      const bool valid = r >= 0 && r < capS;
      s_row[i] = valid ? r : -1;
      const int* sc = sites + 3LL * (valid ? r : 0);
      s_x[i] = valid ? static_cast<float>(sc[0]) : 1e9f;
      s_y[i] = valid ? static_cast<float>(sc[1]) : 1e9f;
      s_z[i] = valid ? static_cast<float>(sc[2]) : 1e9f;
      if (valid) atomicMax(&s_flag[0], i + 1);
    }
    __syncthreads();
    // the feature rows, 16 bytes a copy; a sentinel's slot is never read
    for (int i = tid; i < nr * PIECES; i += FWD_THREADS) {
      const int r = s_row[i / PIECES];
      if (r >= 0) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
            reinterpret_cast<unsigned char*>(s_feat) + 16 * i));
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(feats) +
            (static_cast<long long>(r) * PIECES + i % PIECES) * 16;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(src));
      }
    }
    if (lookup) insert_cells(s_x, s_y, s_z, s_row, s_tab, mask, nr, &s_flag[1]);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    const bool first = r0 == 0;
    if (lookup && !s_flag[1]) {
      // eight lanes per point, four points at once
      const int q = lane >> 3, c = lane & 7;
      for (int pb = 4 * warp; pb < P; pb += 4 * FWD_WARPS) {
        const int p = pb + q;
        float w = 0.f;
        int row = -1;
        if (p < P)
          w = corner_weight<T>(s_pos[3 * p], s_pos[3 * p + 1], s_pos[3 * p + 2],
                               c, s_x, s_y, s_z, s_tab, mask, row);
        const unsigned found = __ballot_sync(0xffffffffu, w != 0.f);
        for (int qq = 0; qq < 4 && pb + qq < P; ++qq) {
          float* o = out + (g * P + pb + qq) * out_stride + lane * CPL;
          float acc[CPL];
#pragma unroll
          for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
          if (!first) load_out<CPL>(acc, o);
          unsigned nz = (found >> (8 * qq)) & 0xffu;
          while (nz) {
            const int src = 8 * qq + __ffs(nz) - 1;
            nz &= nz - 1u;
            const float wv = __shfl_sync(0xffffffffu, w, src);
            const int rv = __shfl_sync(0xffffffffu, row, src);
            axpy<CPL>(acc, wv, s_feat + rv * C + lane * CPL);
          }
          store_out<CPL>(acc, o);
        }
      }
    } else {
      const int n = s_flag[0];  // rows past the last valid one weigh 0
      for (int p = warp; p < P; p += FWD_WARPS) {
        const float px = s_pos[3 * p], py = s_pos[3 * p + 1],
                    pz = s_pos[3 * p + 2];
        float* o = out + (g * P + p) * out_stride + lane * CPL;
        float acc[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
        if (!first) load_out<CPL>(acc, o);
        for (int i0 = 0; i0 < n; i0 += 32) {
          const int i = i0 + lane;
          float w = 0.f;
          if (i < n) {
            w = tent(px, s_x[i]);
            w = w * tent(py, s_y[i]);
            w = w * tent(pz, s_z[i]);
            w = weight_operand(w, feats);
          }
          unsigned nz = __ballot_sync(0xffffffffu, w != 0.f);
          while (nz) {
            const int src = __ffs(nz) - 1;
            nz &= nz - 1u;
            const float wv = __shfl_sync(0xffffffffu, w, src);
            axpy<CPL>(acc, wv, s_feat + (i0 + src) * C + lane * CPL);
          }
        }
        store_out<CPL>(acc, o);
      }
    }
  }
}

// Lets `kernel` use up to FWD_SMEM_BUDGET bytes of dynamic shared memory
// (every launch of both directions stays within it), asked for once per
// device: `done` is the caller's own flag array for this kernel. The call
// is not allowed while a stream is being captured into a CUDA graph, so a
// captured launch must find it made by an earlier, eager one.
template <typename Kernel>
int allow_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BUDGET);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64) done[dev] = true;
  return 0;
}

template <typename T, int CPL>
int launch(const void* feats, const void* sites, const void* rows,
           const void* pos, void* out, int ngrp, int P, int capR, int capS,
           long long out_stride, int lookup, cudaStream_t stream) {
  constexpr int C = 32 * CPL;
  // per staged row: its features, three coordinates, its id, and (twice as
  // many slots as rows, rounded up to a power of two) at most 16 bytes of
  // the table; per block: the positions and two flags
  const long long per_row = C * sizeof(T) + 16 + 16;
  const long long fixed = 12LL * P + 16;
  const long long fit = (FWD_SMEM_BUDGET - fixed) / per_row / 4 * 4;
  if (fit < 4) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_rows =
      static_cast<int>(min(static_cast<long long>((capR + 3) / 4 * 4), fit));
  int table_size = 32;
  while (table_size < 2 * tile_rows) table_size *= 2;
  const size_t smem = static_cast<size_t>(tile_rows) * (C * sizeof(T) + 16) +
                      12 * P + 4 * table_size + 8;
  auto kernel = hat_interp_kernel<T, CPL>;
  static bool done[64] = {};  // one per instantiation of this function
  const int err = allow_smem(kernel, done);
  if (err != 0) return err;
  kernel<<<ngrp, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(sites),
      static_cast<const int*>(rows), static_cast<const float*>(pos),
      static_cast<float*>(out), P, capR, capS, out_stride, tile_rows,
      table_size, lookup);
  return 0;
}

template <typename T>
int launch_c(int C, const void* feats, const void* sites, const void* rows,
             const void* pos, void* out, int ngrp, int P, int capR, int capS,
             long long out_stride, int lookup, cudaStream_t stream) {
  switch (C) {
    case 32:
      return launch<T, 1>(feats, sites, rows, pos, out, ngrp, P, capR, capS,
                          out_stride, lookup, stream);
    case 64:
      return launch<T, 2>(feats, sites, rows, pos, out, ngrp, P, capR, capS,
                          out_stride, lookup, stream);
    case 128:
      return launch<T, 4>(feats, sites, rows, pos, out, ngrp, P, capR, capS,
                          out_stride, lookup, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// CPL = C / 32 channels a lane, lane l holding channels l + 32 j. tile_rows
// (a multiple of 4) rows are staged per pass. T: the features' type, for
// the weights' rounding. vec: the cotangent's rows are 16-byte aligned
// (16-byte copies, else 4-byte). Writes each (group, slot)'s sum to its row
// of partial [ngrp * capR, C], zeros where no point reaches the row; the
// slots of sentinel rows are left unwritten (the second pass reads none).
template <typename T, int CPL>
__global__ void __launch_bounds__(FWD_THREADS)
hat_interp_bwd_kernel(const float* __restrict__ grad, long long grad_stride,
                      const int* __restrict__ sites,
                      const int* __restrict__ rows,
                      const float* __restrict__ pos,
                      float* __restrict__ partial, int P, int capR, int capS,
                      int tile_rows, int vec) {
  constexpr int C = 32 * CPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_grad = reinterpret_cast<float*>(smem_raw);  // [P][C]
  float* s_x = s_grad + P * C;                          // [tile_rows] each
  float* s_y = s_x + tile_rows;
  float* s_z = s_y + tile_rows;
  int* s_row = reinterpret_cast<int*>(s_z + tile_rows);
  float* s_pos = reinterpret_cast<float*>(s_row + tile_rows);  // [P][3]
  int* s_flag = reinterpret_cast<int*>(s_pos + 3 * P);  // rows to scan

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* grow = rows + g * capR;

  // the group's cotangent, read once: [P][C] into shared memory
  const float* gg = grad + g * P * grad_stride;
  if (vec) {
    for (int i = tid; i < P * C / 4; i += FWD_THREADS) {
      const int p = i / (C / 4), q = i % (C / 4);
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(s_grad + p * C + 4 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(gg + p * grad_stride + 4 * q));
    }
  } else {
    for (int i = tid; i < P * C; i += FWD_THREADS) {
      const int p = i / C, c = i % C;
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(s_grad + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(gg + p * grad_stride + c));
    }
  }
  for (int i = tid; i < 3 * P; i += FWD_THREADS) s_pos[i] = pos[g * P * 3 + i];

  for (int r0 = 0; r0 < capR; r0 += tile_rows) {
    const int nr = min(tile_rows, capR - r0);
    __syncthreads();  // the previous pass is written out
    if (tid == 0) s_flag[0] = 0;
    __syncthreads();
    for (int i = tid; i < nr; i += FWD_THREADS) {
      const int r = grow[r0 + i];
      const bool valid = r >= 0 && r < capS;
      s_row[i] = valid ? r : -1;
      const int* sc = sites + 3LL * (valid ? r : 0);
      s_x[i] = valid ? static_cast<float>(sc[0]) : 1e9f;
      s_y[i] = valid ? static_cast<float>(sc[1]) : 1e9f;
      s_z[i] = valid ? static_cast<float>(sc[2]) : 1e9f;
      if (valid) atomicMax(&s_flag[0], i + 1);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    const int n = s_flag[0];  // rows past the last valid one weigh 0

    // a warp per staged row weighs every point of the group, in order
    for (int i = warp; i < n; i += FWD_WARPS) {
      if (s_row[i] < 0) continue;
      const float sx = s_x[i], sy = s_y[i], sz = s_z[i];
      float acc[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
      for (int p0 = 0; p0 < P; p0 += 32) {
        const int p = p0 + lane;
        float w = 0.f;
        if (p < P) {
          w = tent(s_pos[3 * p], sx);
          w = w * tent(s_pos[3 * p + 1], sy);
          w = w * tent(s_pos[3 * p + 2], sz);
          w = weight_operand(w, static_cast<const T*>(nullptr));
        }
        unsigned nz = __ballot_sync(0xffffffffu, w != 0.f);
        while (nz) {
          const int src = __ffs(nz) - 1;
          nz &= nz - 1u;
          const float wv = __shfl_sync(0xffffffffu, w, src);
          const float* gr = s_grad + (p0 + src) * C + lane;
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[j] = fmaf(wv, gr[32 * j], acc[j]);
        }
      }
      float* dst = partial + (g * capR + r0 + i) * C + lane;
#pragma unroll
      for (int j = 0; j < CPL; ++j) dst[32 * j] = acc[j];
    }
  }
}

// The fixed-order mode's second pass: d_feats[s, :] = the sum of the
// partial rows of the (group, slot) pairs that list site s, in the order of
// their flat index g * capR + r. keys: rows' ids plus key_base, sorted (a
// stable sort, which keeps that order among equal ids), order: each key's
// flat index plus order_base (several levels' rows may share one sort:
// ops/hat_kernel.sort_rows). A warp per site finds its run of keys by
// binary search and adds the run's partial rows one after the other; every
// site row is written (zeros where no group lists it), so d_feats needs no
// zeroing.
template <int CPL>
__global__ void __launch_bounds__(FWD_THREADS)
hat_row_sum_kernel(const float* __restrict__ partial,
                   const int* __restrict__ keys,
                   const long long* __restrict__ order, long long n_keys,
                   int key_base, long long order_base, int capS,
                   float* __restrict__ d_feats) {
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  if (s >= capS) return;
  const int key = s + key_base;
  long long lo = 0, hi = n_keys;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  const long long first = lo;
  hi = n_keys;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] <= key) lo = mid + 1; else hi = mid;
  }
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  for (long long k = first; k < lo; ++k) {
    const float* src = partial + (order[k] - order_base) * C + lane;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] += src[32 * j];
  }
  float* dst = d_feats + static_cast<long long>(s) * C + lane;
#pragma unroll
  for (int j = 0; j < CPL; ++j) dst[32 * j] = acc[j];
}

template <typename T, int CPL>
int launch_bwd(const void* grad, long long grad_stride, const void* sites,
               const void* rows, const void* pos, void* d_feats, int ngrp,
               int P, int capR, int capS, void* partial, const void* keys,
               const void* order, int key_base, long long order_base,
               cudaStream_t stream) {
  constexpr int C = 32 * CPL;
  // per staged row: three coordinates and its id; per block: the
  // cotangent, the positions and a flag
  const long long per_row = 16;
  const long long fixed = static_cast<long long>(P) * (4 * C + 12) + 16;
  const long long fit = (FWD_SMEM_BUDGET - fixed) / per_row / 4 * 4;
  if (fit < 4) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_rows =
      static_cast<int>(min(static_cast<long long>((capR + 3) / 4 * 4), fit));
  const size_t smem = static_cast<size_t>(P) * (4 * C + 12) +
                      static_cast<size_t>(tile_rows) * per_row + 16;
  auto kernel = hat_interp_bwd_kernel<T, CPL>;
  static bool done[64] = {};  // one per instantiation of this function
  const int err = allow_smem(kernel, done);
  if (err != 0) return err;
  const int vec = reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                  grad_stride % 4 == 0;
  kernel<<<ngrp, FWD_THREADS, smem, stream>>>(
      static_cast<const float*>(grad), grad_stride,
      static_cast<const int*>(sites), static_cast<const int*>(rows),
      static_cast<const float*>(pos), static_cast<float*>(partial), P, capR,
      capS, tile_rows, vec);
  hat_row_sum_kernel<CPL><<<(capS + FWD_WARPS - 1) / FWD_WARPS, FWD_THREADS,
                            0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int*>(keys),
      static_cast<const long long*>(order),
      static_cast<long long>(ngrp) * capR, key_base, order_base, capS,
      static_cast<float*>(d_feats));
  return 0;
}

template <typename T>
int launch_bwd_c(int C, const void* grad, long long grad_stride,
                 const void* sites, const void* rows, const void* pos,
                 void* d_feats, int ngrp, int P, int capR, int capS,
                 void* partial, const void* keys, const void* order,
                 int key_base, long long order_base, cudaStream_t stream) {
  switch (C) {
    case 32:
      return launch_bwd<T, 1>(grad, grad_stride, sites, rows, pos, d_feats,
                              ngrp, P, capR, capS, partial, keys, order,
                              key_base, order_base, stream);
    case 64:
      return launch_bwd<T, 2>(grad, grad_stride, sites, rows, pos, d_feats,
                              ngrp, P, capR, capS, partial, keys, order,
                              key_base, order_base, stream);
    case 96:
      return launch_bwd<T, 3>(grad, grad_stride, sites, rows, pos, d_feats,
                              ngrp, P, capR, capS, partial, keys, order,
                              key_base, order_base, stream);
    case 128:
      return launch_bwd<T, 4>(grad, grad_stride, sites, rows, pos, d_feats,
                              ngrp, P, capR, capS, partial, keys, order,
                              key_base, order_base, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// feats [capS, C] (bf16 if feats_bf16 else f32), sites [capS, 3] int32,
// rows [ngrp, capR] int32, pos [ngrp, P, 3] f32 -> out rows of out_stride
// floats, [ngrp, P, C] in the first C of each. All contiguous except out;
// feats and out 16-byte aligned, out_stride a multiple of 4. C is 32, 64 or
// 128 and P at most 4096. lookup: 1 finds a point's rows through the cell
// table (the scan where a group lists a cell twice), 0 always scans.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hat_interp_level_cuda(const void* feats, int feats_bf16,
                                     const void* sites, const void* rows,
                                     const void* pos, void* out, int ngrp,
                                     int P, int capR, int capS, int C,
                                     long long out_stride, int lookup,
                                     void* stream) {
  if (ngrp <= 0 || P <= 0 || P > 4096 || capR <= 0 || out_stride < C ||
      out_stride % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(feats) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      feats_bf16 ? launch_c<__nv_bfloat16>(C, feats, sites, rows, pos, out,
                                           ngrp, P, capR, capS, out_stride,
                                           lookup, s)
                 : launch_c<float>(C, feats, sites, rows, pos, out, ngrp, P,
                                   capR, capS, out_stride, lookup, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// grad rows of grad_stride floats, [ngrp, P, C] in the first C of each;
// sites [capS, 3] int32, rows [ngrp, capR] int32, pos [ngrp, P, 3] f32, all
// contiguous -> d_feats [capS, C] f32, contiguous, every row written.
// partial: scratch [ngrp * capR, C] f32; keys (int32) and order (int64):
// the level's run of ops/hat_kernel.sort_rows, whose keys are rows' ids
// plus key_base and whose order entries are flat indices plus order_base.
// bf16 selects bf16-rounded weights. C is 32, 64, 96 or 128, and a group's
// cotangent and positions, P (4 C + 12) bytes, leave room in
// FWD_SMEM_BUDGET for four staged rows (else cudaErrorInvalidValue). The
// sums run in one fixed order: two calls give equal bits.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int hat_interp_level_bwd_cuda(const void* grad,
                                         long long grad_stride, int bf16,
                                         const void* sites, const void* rows,
                                         const void* pos, void* d_feats,
                                         int ngrp, int P, int capR, int capS,
                                         int C, void* partial,
                                         const void* keys, const void* order,
                                         int key_base, long long order_base,
                                         void* stream) {
  if (ngrp <= 0 || P <= 0 || capR <= 0 || capS <= 0 || grad_stride < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      bf16 ? launch_bwd_c<__nv_bfloat16>(C, grad, grad_stride, sites, rows,
                                         pos, d_feats, ngrp, P, capR, capS,
                                         partial, keys, order, key_base,
                                         order_base, s)
           : launch_bwd_c<float>(C, grad, grad_stride, sites, rows, pos,
                                 d_feats, ngrp, P, capR, capS, partial, keys,
                                 order, key_base, order_base, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
