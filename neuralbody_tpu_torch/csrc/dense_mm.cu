// Dense matrix product for Hopper (sm_90a).
//
// Replaces the TPU probe kernel
//   tools/probes/pallas_enc_interp.py:22  mm
// (o = a @ b with f32 accumulation, a [1024, 1024] f32 in 256-row blocks, b
// whole in fast memory) and, in the port, every dense layer of the NeRF
// baseline's MLPs: the forward x @ W, and in training dx = g @ W^T and
// dW = x^T @ g, all three through this one function:
//
//   out[m, n] = sum_{k < K}  A[m, k] * B[k, n]
//
// A [M, K] and B [K, N] are both f32 or both bf16, each with its own row
// and column stride in elements (so a transposed view or a column slice is
// read in place, never copied); out [M, N] is f32, contiguous; the products
// are summed in f32. M, N and K are arbitrary: the kernel masks the ragged
// edges of all three itself (the MLPs have K = 63, 319, 283 and N = 1, 3).
//
// What bounds it on an H100: operations. One full-width NeRF forward (1024
// rays, 64 coarse + 192 fine points, D = 8, W = 256) is ~311 GFLOP over
// ~4 GB of activations: 4.6 ms at the 67 TFLOP/s of the f32 CUDA cores
// against 1.2 ms of bytes at 3.35 TB/s. This kernel multiplies in f32 in
// both modes (a bf16 value and the product of two are exact in f32), so
// the f32 figure is the one it can approach; with bf16 operands on the
// tensor cores (989 TFLOP/s) the bound would become bytes.
//
// Design. The TPU kernel keeps all of b in fast memory and hands a
// [256, K] x [K, N] product to the matrix unit. Here a block of 256 threads
// owns a 128 x 128 output tile and walks K in chunks of 16 through two
// shared-memory stages: while the FMAs run on one stage, the next chunk's
// global loads are in flight into registers and are stored to the other
// stage afterwards, one barrier per chunk. A thread keeps an 8 x 8
// micro-tile in registers, cut in four 4 x 4 quadrants 64 apart so that
// the shared-memory reads are float4 and free of bank conflicts: 64 FMAs
// for four 16-byte shared loads. The A chunk is stored transposed
// ([k][m]), whatever A's strides are; which of a tile's two indices runs
// fastest across the threads of a global load is chosen from the operand's
// strides (the unit-stride one), so x, W, W^T and x^T are all read in
// coalesced runs. Loads are scalar: rows of 63, 319 or 283 elements are not
// 16-byte aligned.
// Blocks are numbered with the N tiles fastest, so the blocks that share a
// row block of A run together and A comes from device memory once.
// dW is [K, N] <= 319 x 256 with a reduction over all the points
// (196,608 in the fine pass): six output tiles, each a chain of 12,288
// dependent chunks. The reduction is therefore split over grid.z: block z
// walks its own range of K and writes its partial tile into scratch
// [splits, M, N]; a second small kernel sums the partials in split order.
// No atomics: the result is deterministic. The caller chooses the split
// count from the shapes alone (ops/dense_kernel.py).
// The N = 1 and N = 3 layers use one column of a 128-wide tile; they cost
// what a 128-wide layer costs. wgmma, TMA and bf16 tensor-core products are
// left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // output tile rows
constexpr int BN = 128;       // output tile columns
constexpr int BK = 16;        // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int LDS = BM + 4;   // padded row of a stage ([k][m] or [k][n])
constexpr int PER = BM * BK / THREADS;  // elements a thread loads per tile

static_assert(BM == BN, "one load pattern serves both operands");

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// How a thread's PER elements of a [128 x BK] operand tile are laid out:
// element i is at (outer0 + i * d_outer, k0 + i * d_k), where "outer" is
// the tile's M (for A) or N (for B) index. k_fast: the 16 k of a row go to
// 16 neighbouring threads (the operand is contiguous along k); otherwise
// 128 neighbouring threads take 128 neighbouring outer indices.
struct LoadMap {
  int outer0, k0, d_outer, d_k;
};
__device__ __forceinline__ LoadMap load_map(bool k_fast) {
  const int t = threadIdx.x;
  if (k_fast) return {t / BK, t % BK, THREADS / BK, 0};
  return {t % BM, t / BM, 0, THREADS / BM};
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dense_mm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                float* __restrict__ out, int M, int N, int K, long long sam,
                long long sak, long long sbk, long long sbn, int tiles_n,
                int chunk) {
  __shared__ __align__(16) float s_a[2][BK][LDS];
  __shared__ __align__(16) float s_b[2][BK][LDS];

  const int tile_m = blockIdx.x / tiles_n;
  const int tile_n = blockIdx.x % tiles_n;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;
  // this block's range of the reduction, and where its tile goes
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  out += static_cast<long long>(blockIdx.z) * M * N;

  const LoadMap la = load_map(sak == 1 || sam != 1);
  const LoadMap lb = load_map(sbk == 1 && sbn != 1);
  const T* a_ptr = A + (m0 + la.outer0) * sam + (k_begin + la.k0) * sak;
  const T* b_ptr = B + (n0 + lb.outer0) * sbn + (k_begin + lb.k0) * sbk;
  const long long a_inc = la.d_outer * sam + la.d_k * sak;
  const long long b_inc = lb.d_outer * sbn + lb.d_k * sbk;

  // which of a thread's PER elements lie inside the operand's outer edge
  // (the same for every chunk), one bit each: a tile off the edges loads
  // whole chunks unmasked
  unsigned a_ok = 0, b_ok = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    a_ok |= (m0 + la.outer0 + i * la.d_outer < M ? 1u : 0u) << i;
    b_ok |= (n0 + lb.outer0 + i * lb.d_outer < N ? 1u : 0u) << i;
  }
  const bool interior = a_ok == (1u << PER) - 1 && b_ok == (1u << PER) - 1;

  float ra[PER], rb[PER];
  auto fetch = [&](int kt) {  // the chunk at kt, into registers
    if (interior && kt + BK <= k_end) {  // no edge in this chunk
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        ra[i] = as_f32(a_ptr[i * a_inc]);
        rb[i] = as_f32(b_ptr[i * b_inc]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const bool a_in = (a_ok >> i & 1u) && kt + la.k0 + i * la.d_k < k_end;
        ra[i] = a_in ? as_f32(a_ptr[i * a_inc]) : 0.f;
        const bool b_in = (b_ok >> i & 1u) && kt + lb.k0 + i * lb.d_k < k_end;
        rb[i] = b_in ? as_f32(b_ptr[i * b_inc]) : 0.f;
      }
    }
    a_ptr += BK * sak;
    b_ptr += BK * sbk;
  };
  auto stage = [&](int s) {  // registers into stage s
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      s_a[s][la.k0 + i * la.d_k][la.outer0 + i * la.d_outer] = ra[i];
      s_b[s][lb.k0 + i * lb.d_k][lb.outer0 + i * lb.d_outer] = rb[i];
    }
  };

  const int tx = threadIdx.x % 16;  // columns 4 tx .. + 3 and 64 + 4 tx .. + 3
  const int ty = threadIdx.x / 16;  // rows    4 ty .. + 3 and 64 + 4 ty .. + 3
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int cur = 0;
  if (k_begin < k_end) {
    fetch(k_begin);
    stage(0);
  }
  __syncthreads();
  for (int kt = k_begin; kt < k_end; kt += BK) {
    const bool more = kt + BK < k_end;
    if (more) fetch(kt + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&s_a[cur][k][4 * ty]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&s_a[cur][k][64 + 4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&s_b[cur][k][4 * tx]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&s_b[cur][k][64 + 4 * tx]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stage(cur ^ 1);
    __syncthreads();
    cur ^= 1;
  }

  // rows of N floats are 16-byte aligned when N is a multiple of 4 (out is
  // a fresh allocation); otherwise, and on the ragged edge, scalar stores
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
    float* row = out + static_cast<long long>(m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (vec && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][4 * h + j];
      }
    }
  }
}

// out[i] = sum over the splits, in split order, of part[s][i].
__global__ void __launch_bounds__(THREADS)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  long long count, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < count; i += stride) {
    float sum = part[i];
    for (int s = 1; s < splits; ++s) sum += part[s * count + i];
    out[i] = sum;
  }
}

template <typename T>
void launch(const void* a, const void* b, float* dst, int M, int N, int K,
            long long sam, long long sak, long long sbk, long long sbn,
            int tiles_m, int tiles_n, int splits, int chunk,
            cudaStream_t stream) {
  const dim3 grid(tiles_m * tiles_n, 1, splits);
  dense_mm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), dst, M, N, K, sam,
      sak, sbk, sbn, tiles_n, chunk);
}

}  // namespace

// a: [M, K] and b: [K, N], both bf16 if bf16 else f32, element (i, j) at
// a + i * sam + j * sak (b: sbk, sbn), strides in elements, none negative;
// out [M, N] f32 contiguous, 16-byte aligned. The reduction is cut into
// `splits` ranges of `chunk` (a multiple of 16 when splits > 1, with
// splits * chunk >= K); with splits > 1, scratch holds [splits, M, N] f32
// and a second launch sums it into out. M, N, K > 0, splits <= 65535.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int dense_mm_cuda(const void* a, const void* b, int bf16,
                             void* out, void* scratch, int M, int N, int K,
                             long long sam, long long sak, long long sbk,
                             long long sbn, int splits, int chunk,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || sam < 0 || sak < 0 || sbk < 0 ||
      sbn < 0 || splits < 1 || splits > 65535 || chunk <= 0 ||
      static_cast<long long>(splits) * chunk < K ||
      (splits > 1 && (chunk % BK != 0 || scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_m = (M + BM - 1) / BM;
  const long long tiles_n = (N + BN - 1) / BN;
  if (tiles_m * tiles_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  if (bf16)
    launch<__nv_bfloat16>(a, b, dst, M, N, K, sam, sak, sbk, sbn,
                          static_cast<int>(tiles_m), static_cast<int>(tiles_n),
                          splits, chunk, s);
  else
    launch<float>(a, b, dst, M, N, K, sam, sak, sbk, sbn,
                  static_cast<int>(tiles_m), static_cast<int>(tiles_n), splits,
                  chunk, s);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long count = static_cast<long long>(M) * N;
  const int blocks =
      static_cast<int>(min((count + THREADS - 1) / THREADS, 4096LL));
  sum_splits_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), count,
      splits);
  return static_cast<int>(cudaGetLastError());
}
