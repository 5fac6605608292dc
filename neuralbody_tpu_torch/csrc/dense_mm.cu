// Dense layer for Hopper (sm_90a): a matrix product with the bias and the
// ReLU in its epilogue.
//
// Replaces the TPU probe kernel
//   tools/probes/pallas_enc_interp.py:22  mm
// (o = a @ b with f32 accumulation, a [1024, 1024] f32 in 256-row blocks, b
// whole in fast memory) and, in the port, every dense layer of the NeRF
// baseline's MLPs: the forward act(x @ W + b), and in training
// dx = g @ W^T and dW = x^T @ g, all through this one function:
//
//   out[m, n] = act( sum_{k < K} A[m, k] * B[k, n]  + bias[n] )
//
// A [M, K] and B [K, N] are both f32 or both bf16, each with its own row
// and column stride in elements (so a transposed view or a column slice is
// read in place, never copied); bias [N] f32 or absent; act is ReLU or the
// identity; out [M, N] is f32, contiguous; the products are summed in f32.
// M, N and K are arbitrary: the kernels mask the ragged edges themselves
// (the MLPs have K = 63, 319, 283 and N = 1, 3).
//
// What bounds it on an H100: operations. One full-width NeRF step (1024
// rays, 64 coarse + 192 fine points, D = 8, W = 256) is ~950 GFLOP in 70
// products: 14.2 ms at the 67 TFLOP/s of the f32 CUDA cores. The tensor
// cores take no f32 operands, but they take TF32 ones (10 mantissa bits) at
// 495 TFLOP/s and sum in f32, so an f32 product is three TF32 products:
// 6.1 ms for the same step (mma.sync, which this kernel uses, reaches
// 305 of the 495 TFLOP/s in a loop of nothing else: 9.9 ms). The narrow
// layers (N = 1, 3) are bound by the bytes of their input, 0.06 ms at
// 196,608 x 256.
//
// Four routes, chosen by the caller from the operands' type, shapes and
// strides (ops/dense_kernel.py: route_plan):
//
// 1. tf32x3 (f32 operands, the main route). Each f32 value x is split into
//    hi = x cut to TF32 and lo = x - hi, and a tile is accumulated in f32 as
//    a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first) with
//    mma.sync.m16n8k8 tf32; the dropped a_lo b_lo term is 2^-22 of the
//    product. A block of 256 threads owns a 128 x 128 output tile; its 8
//    warps (2 x 4) own 64 x 32 each: 16 mma tiles, 64 accumulators a thread.
//    Operand tiles of depth 32 arrive by cp.async through a ring of three
//    stages (108 KB of dynamic shared memory, two blocks a SM), one barrier
//    per tile. A tile is kept in shared memory in the operand's own
//    orientation ([outer][k] when k is the unit stride, else [k][outer]), so
//    x, W, W^T and x^T all copy in 16-byte pieces when the other stride and
//    the base are 16-byte aligned; the ragged edges are zero-filled by the
//    copy's source size. An operand that is not aligned (rows of 63, 319,
//    283 floats, a slice at an odd column) copies element by element (4-byte
//    cp.async), through the same ring: those layers run up to 15% slower
//    per operation. Rows are padded (36 or 136 floats) so that the fragment
//    loads of a warp hit 32 different banks in either orientation. The split
//    runs in registers after the fragment load (a mask and a subtraction a
//    value; the tensor core ignores the low 13 bits of an operand, so hi
//    needs no operation of its own).
//    The tensor core cuts its f32 sums instead of rounding them: chaining
//    every product into the accumulators drifts by about 1.1e-8 K of the
//    output's scale (3.7e-6 at 319, 1.2e-5 to 1.8e-5 at dW's ranges of 1504
//    to 2240). So where a block's range of the reduction is longer than 320
//    (dW, the probe's 1024-deep product) only the three products of one k-step of 8
//    are chained, from zero; each such partial joins the accumulators by a
//    rounded f32 add, the four chains of a row of tiles interleaved: 6e-7
//    against an f64 product, as cuBLAS SGEMM's, for 16-26% of the time.
//    Shorter reductions (every forward and dx of the MLPs) chain.
//    Measured on an H100 80GB HBM3 at 700 W, 196608 x 256 x 256 (tools/
//    dense_variants.py builds the kernel with one part left out or
//    swapped): 0.405 ms forward, 0.398 dx, 0.476 dW (rounded sums), 64
//    TFLOP/s of f32 work forward; the FMA route 0.69, cuBLAS SGEMM 0.57.
//    mma.sync alone sustains 305 TFLOP/s of TF32 in this pattern of 16
//    tiles a warp, 271 when three products chain, 217 with the rounded
//    adds; three times the products at the first rate are 0.25 ms. With
//    one product in place of three the kernel takes 0.234 ms, so its time
//    is 0.15 ms of structure plus 0.085 a product: the copies and their
//    address arithmetic are 0.05 of the structure (0.357 without them),
//    fragment loads, barriers and a block's first and last tiles the rest,
//    and none of it hides behind the mma. Rounded sums everywhere: 0.480 /
//    0.535 / 0.476; chained sums everywhere: dW 0.402 but 1.2e-5 off.
//    cvt.rna.tf32 for the split: 0.504 / 0.496 / 0.570 (the conversions
//    run at a quarter rate; it rounds hi to nearest and halves the
//    error). One block a SM with 255 registers: 0.476 / 0.474 / 0.488.
//    Tried in earlier builds and dropped, each within 2% of its base:
//    ldmatrix for the k-contiguous operands, 512 threads with 32 x 32 warp
//    tiles, no unrolling of the k-steps (dx a third slower). Recomputing a
//    copy's address from its tile coordinates in every tile cost a step's
//    70 products 10% (22.1 against 20.1 ms; the integer pipe runs at half
//    rate): a thread now carries one pointer and one mask per operand from
//    tile to tile. Not tried: a producer warp for the copies, a block
//    that walks several tiles, wgmma.
// 2. fma: the f32 FMA loop on the CUDA cores (128 x 128 tile, 8 x 8 outputs
//    a thread, depth 16, two stages through registers). It serves bf16
//    operands (a bf16 value and the product of two are exact in f32; no path
//    of the port uses them, so they were not given tensor-core code),
//    reductions of 8 or less (dx of the narrow layers: bound by the output,
//    where a ring of 32-deep stages copies mostly zeros) and stays
//    selectable for f32 as the figure to compare the tf32x3 route with.
//    Tried and dropped for it (TFLOP/s at 196608 x 256 x 256): depth 8
//    (34.3 against 35.7), one block a SM with 183 registers and no spills
//    (37.1 against 37.0), a 4 x 8 warp arrangement (37.0 against 38.4).
// 3. narrow rows (N <= 8, A with unit column stride: the forward of
//    alpha_linear and rgb_linear). B and the bias sit in shared memory; a
//    warp owns two rows of A at a time, reads them once in 16-byte pieces
//    and reduces its N sums by shuffles. Bound by bytes: 0.077 ms at
//    196608 x 256 x 1 against 0.060 (the main route 0.21, the FMA loop 0.38).
// 4. narrow columns (N <= 8, A with unit row stride: dW of the same layers,
//    A = x^T). A block owns 128 output rows (columns of x) and a range of
//    the reduction; eight threads share a row, each with four loads in
//    flight, and add their sums in a fixed order; the ranges are summed as
//    for a split. Bound by bytes: 0.102 ms at 256 x 196608 x 1 against
//    0.060 (the main route 0.27).
//
// dW is [K, N] <= 319 x 256 with a reduction over all the points (196,608
// in the fine pass): six output tiles. The reduction is split over grid.z:
// block z walks its own range of K and writes its partial tile into scratch
// [splits, M, N]; a second small kernel sums the partials in split order
// and applies the epilogue. No atomics: the result is deterministic. The
// caller chooses the split count from the shapes alone.
// Blocks are numbered with the N tiles fastest, so the blocks that share a
// row block of A run together and A comes from device memory once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // output tile rows
constexpr int BN = 128;       // output tile columns
constexpr int THREADS = 256;

static_assert(BM == BN, "one load pattern serves both operands");

__device__ __forceinline__ float epilogue(float v, const float* bias, int n,
                                          int relu) {
  if (bias != nullptr) v += bias[n];
  return relu ? fmaxf(v, 0.f) : v;
}

// ---- route 1: tf32x3 on the tensor cores ---------------------------------

constexpr int TK = 32;           // depth of a staged tile
constexpr int STAGES = 3;
constexpr int LD_K = TK + 4;     // row of an [outer][k] tile, floats
constexpr int LD_O = BM + 8;     // row of a [k][outer] tile, floats
constexpr int TILE_FLOATS = BM * LD_K;   // the larger of the two
constexpr int TC_SMEM = STAGES * 2 * TILE_FLOATS * sizeof(float);
constexpr int CHAIN_MAX_K = 320;  // longest reduction chained in the tensor
                                  // core: 3.7e-6 of the output's scale

static_assert(TK * LD_O <= TILE_FLOATS, "either orientation fits a stage");
static_assert(BM * TK == 4 * 4 * THREADS, "four 4-float pieces a thread");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's share of the copies of one operand: four pieces of four
// floats of every [128 x TK] tile. KC: a stage is laid out [outer][k] and a
// piece runs along k; else [k][outer] and a piece runs along outer. The
// thread's pieces are 32 rows (KC) or 8 k (else) apart, so one pointer and
// one mask carry from tile to tile and the rest is constants.
template <bool KC>
struct TileLoader {
  const float* ptr;  // the thread's first piece of the next tile
  int inside;        // KC: bit i set if piece i's row is inside the operand;
                     // else: how many of a piece's four elements are (0..4)

  // element (o, k) of a tile is g[(outer0 + o) * s_outer + (k0 + k) * s_k]
  __device__ __forceinline__ void init(const float* g, long long s_outer,
                                       long long s_k, int outer0, int n_outer,
                                       int k_begin) {
    const int o = KC ? threadIdx.x >> 3 : (threadIdx.x & 31) * 4;
    const int k = KC ? (threadIdx.x & 7) * 4 : threadIdx.x >> 5;
    ptr = g + (outer0 + o) * s_outer + (k_begin + k) * s_k;
    if (KC) {
      inside = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        inside |= (outer0 + o + 32 * i < n_outer ? 1 : 0) << i;
    } else {
      inside = max(0, min(4, n_outer - outer0 - o));
    }
  }

  // The tile at k0 into stage s, zero beyond the operand's edges and k_end;
  // vec: 16-byte copies along the stage's fast index, else element by
  // element. g: any address inside the operand, for the copies of nothing.
  __device__ __forceinline__ void load(float* s, const float* g,
                                       long long s_outer, long long s_k,
                                       int k0, int k_end, bool vec) {
    const int k = k0 + (KC ? (threadIdx.x & 7) * 4 : threadIdx.x >> 5);
    float* dst = s + (KC ? (threadIdx.x >> 3) * LD_K + (threadIdx.x & 7) * 4
                         : (threadIdx.x >> 5) * LD_O + (threadIdx.x & 31) * 4);
    const long long step = KC ? 32 * s_outer : 8 * s_k;
    const long long fast = KC ? s_k : s_outer;  // along a piece
    const int k_left = max(0, min(4, k_end - k));  // KC: a piece's k inside
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* src = ptr + i * step;
      float* d = dst + i * (KC ? 32 * LD_K : 8 * LD_O);
      // elements of this piece inside the operand and the reduction's range
      const int n = KC ? ((inside >> i & 1) ? k_left : 0)
                       : (k + 8 * i < k_end ? inside : 0);
      if (vec) {
        cp_async16(d, n ? src : g, 4 * n);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cp_async4(d + j, j < n ? src + j * fast : g, j < n ? 4 : 0);
      }
    }
    ptr += TK * s_k;
  }
};

// x = hi + lo with hi and lo TF32 values (the low 13 mantissa bits zero):
// hi is x cut to TF32, lo the rest (exact in f32) cut again. Masks and one
// subtraction; cvt.rna.tf32 would round to nearest, but it runs at a
// quarter of the ALUs' rate and makes the loop slower (0.50 against 0.41 ms
// for a 256-wide layer at 196,608 points).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d = a b + c on one m16n8k8 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// AK / BKC: k is the unit stride of A / of B (the stage's orientation).
// ROUNDED: the products of a k-step join the accumulators by rounded f32
// adds (a reduction longer than CHAIN_MAX_K); else they chain in the tensor
// core, 16-26% faster, and the output drifts by about 1.1e-8 K of its scale.
template <bool AK, bool BKC, bool ROUNDED>
__global__ void __launch_bounds__(THREADS, 2)
dense_mm_tf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int N, int K, long long sam, long long sak,
                     long long sbk, long long sbn, int tiles_n, int chunk,
                     int a_vec, int b_vec, int relu) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;
  float* s_b = smem + STAGES * TILE_FLOATS;

  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  out += static_cast<long long>(blockIdx.z) * M * N;
  const int n_tiles = (k_end - k_begin + TK - 1) / TK;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64;   // the warp's rows of the tile
  const int wn = (warp & 3) * 32;    // and its columns

  // a thread's fragment offsets in a stage: element (row, k) of A is at
  // row * A_R + k * A_C, element (k, n) of B at n * B_R + k * B_C
  constexpr int A_R = AK ? LD_K : 1, A_C = AK ? 1 : LD_O;
  constexpr int B_R = BKC ? LD_K : 1, B_C = BKC ? 1 : LD_O;
  const int a_off = (wm + gid) * A_R + tig * A_C;
  const int b_off = (wn + gid) * B_R + tig * B_C;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  TileLoader<AK> load_a;
  TileLoader<BKC> load_b;
  load_a.init(A, sam, sak, m0, M, k_begin);
  load_b.init(B, sbn, sbk, n0, N, k_begin);
  auto load = [&](int t) {  // tiles are loaded in order: t counts up
    const int st = t % STAGES;
    const int k0 = k_begin + t * TK;
    load_a.load(s_a + st * TILE_FLOATS, A, sam, sak, k0, k_end, a_vec != 0);
    load_b.load(s_b + st * TILE_FLOATS, B, sbn, sbk, k0, k_end, b_vec != 0);
  };

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    __syncthreads();              // everyone's did; tile t - 1 is consumed
    if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);
    cp_async_commit();
    const float* a = s_a + (t % STAGES) * TILE_FLOATS + a_off;
    const float* b = s_b + (t % STAGES) * TILE_FLOATS + b_off;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          split_tf32(b[ni * 8 * B_R + (kk + 4 * j) * B_C], bh[ni][j],
                     bl[ni][j]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)  // rows gid, gid + 8; k tig, tig + 4
          split_tf32(a[(mi * 16 + 8 * (j & 1)) * A_R + (kk + 4 * (j >> 1)) * A_C],
                     ah[j], al[j]);
        if constexpr (ROUNDED) {
          // the tensor core cuts its f32 sums instead of rounding them, and
          // a chain over a long reduction drifts (1.2e-5 of the output at
          // 1504). So a chain is the three products of this k-step, from
          // zero, and joins the accumulator by a rounded f32 add; the four
          // chains of a row of tiles are interleaved, so that a warp sends
          // four independent mma between two dependent ones.
          float part[4][4];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_tf32(part[ni], al, bh[ni], zero);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(part[ni], ah, bl[ni], part[ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(part[ni], ah, bh[ni], part[ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[ni][r];
        } else {
          // a short reduction: every product chains into the accumulators
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], al, bh[ni], acc[mi][ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], ah, bl[ni], acc[mi][ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], ah, bh[ni], acc[mi][ni]);
        }
      }
    }
  }

  // an accumulator pair is two neighbouring columns: 8-byte stores when a
  // row of N floats keeps them aligned (out is a fresh allocation)
  const bool vec = N % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + gid + 8 * h;
      if (m >= M) continue;
      float* row = out + static_cast<long long>(m) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * tig;
        if (n >= N) continue;
        const float v0 = epilogue(acc[mi][ni][2 * h], bias, n, relu);
        if (n + 1 < N) {
          const float v1 = epilogue(acc[mi][ni][2 * h + 1], bias, n + 1, relu);
          if (vec) {
            *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
          } else {
            row[n] = v0;
            row[n + 1] = v1;
          }
        } else {
          row[n] = v0;
        }
      }
    }
}

// ---- route 2: f32 FMAs on the CUDA cores ---------------------------------

constexpr int BK = 16;        // depth of one staged chunk
constexpr int LDS = BM + 4;   // padded row of a stage ([k][m] or [k][n])
constexpr int PER = BM * BK / THREADS;  // elements a thread loads per tile

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
                const float* __restrict__ bias, float* __restrict__ out, int M,
                int N, int K, long long sam, long long sak, long long sbk,
                long long sbn, int tiles_n, int chunk, int relu) {
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
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = n + j < N ? epilogue(acc[i][4 * h + j], bias, n + j, relu) : 0.f;
      if (vec && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = v[j];
      }
    }
  }
}

// ---- route 3: narrow rows (N <= 8, A contiguous along k) -----------------

constexpr int NARROW_MAX = 8;
constexpr int ROW_BLOCKS = 132 * 8;  // 8 blocks of 8 warps fill a SM

// B [K, NN] and the bias in shared memory ([NN][Kp], Kp = K rounded up to
// 4, zero beyond K); a warp per row of A. vec: rows of A are 16-byte
// aligned, so a lane reads four neighbouring k at once.
template <int NN>
__global__ void __launch_bounds__(THREADS)
dense_narrow_rows_kernel(const float* __restrict__ A,
                         const float* __restrict__ B,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int M, int K, long long sam,
                         long long sbk, long long sbn, int vec, int relu) {
  extern __shared__ __align__(16) float s_b[];
  const int Kp = (K + 3) & ~3;
  for (int i = threadIdx.x; i < NN * Kp; i += THREADS) {
    const int n = i / Kp, k = i % Kp;
    s_b[i] = k < K ? B[k * sbk + n * sbn] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * (THREADS / 32);
  // two rows a warp at a time: twice the loads in flight
  for (int m = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); m < M;
       m += 2 * n_warps) {
    const int m1 = m + n_warps;
    const bool two = m1 < M;
    const float* row0 = A + m * sam;
    const float* row1 = A + (two ? m1 : m) * sam;
    float acc[2][NN];
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[0][n] = acc[1][n] = 0.f;
    if (vec) {
#pragma unroll 2
      for (int k = 4 * lane; k < K; k += 128) {
        float4 a[2];
        if (k + 3 < K) {
          a[0] = __ldg(reinterpret_cast<const float4*>(row0 + k));
          a[1] = __ldg(reinterpret_cast<const float4*>(row1 + k));
        } else {  // the ragged end of a column slice
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float* row = r ? row1 : row0;
            a[r].x = row[k];
            a[r].y = k + 1 < K ? row[k + 1] : 0.f;
            a[r].z = k + 2 < K ? row[k + 2] : 0.f;
            a[r].w = 0.f;
          }
        }
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float4 b = *reinterpret_cast<const float4*>(s_b + n * Kp + k);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[r][n] = fmaf(a[r].x, b.x, acc[r][n]);
            acc[r][n] = fmaf(a[r].y, b.y, acc[r][n]);
            acc[r][n] = fmaf(a[r].z, b.z, acc[r][n]);
            acc[r][n] = fmaf(a[r].w, b.w, acc[r][n]);
          }
        }
      }
    } else {
      for (int k = lane; k < K; k += 32) {
        const float a0 = row0[k], a1 = row1[k];
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float b = s_b[n * Kp + k];
          acc[0][n] = fmaf(a0, b, acc[0][n]);
          acc[1][n] = fmaf(a1, b, acc[1][n]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          acc[r][n] += __shfl_xor_sync(0xffffffffu, acc[r][n], d);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        out[static_cast<long long>(m) * NN + n] =
            epilogue(acc[0][n], bias, n, relu);
        if (two)
          out[static_cast<long long>(m1) * NN + n] =
              epilogue(acc[1][n], bias, n, relu);
      }
    }
  }
}

// ---- route 4: narrow columns (N <= 8, A contiguous along m) --------------

constexpr int COL_I = 128;     // output rows of a block
constexpr int COL_KL = 8;      // threads that share an output row
constexpr int COL_UNROLL = 4;  // loads of A a thread keeps in flight

// A block owns 128 output rows i (columns of the [K, M] array behind A) and
// block z its range of the reduction; the 8 threads of a row take every
// eighth k, and their sums are added in thread order through shared memory.
template <int NN>
__global__ void __launch_bounds__(COL_I * COL_KL)
dense_narrow_cols_kernel(const float* __restrict__ A,
                         const float* __restrict__ B, float* __restrict__ out,
                         int M, int K, long long sak, long long sbk,
                         long long sbn, int chunk) {
  __shared__ float s_part[COL_KL][COL_I][NN];
  const int ti = threadIdx.x % COL_I, tk = threadIdx.x / COL_I;
  const int i = blockIdx.x * COL_I + ti;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  out += static_cast<long long>(blockIdx.z) * M * NN;
  float acc[NN];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n] = 0.f;
  if (i < M) {
    const float* a = A + i;
    int k = k_begin + tk;
    for (; k + (COL_UNROLL - 1) * COL_KL < k_end; k += COL_UNROLL * COL_KL) {
      float av[COL_UNROLL];
#pragma unroll
      for (int u = 0; u < COL_UNROLL; ++u)
        av[u] = __ldg(a + (k + u * COL_KL) * sak);
#pragma unroll
      for (int u = 0; u < COL_UNROLL; ++u)
#pragma unroll
        for (int n = 0; n < NN; ++n)
          acc[n] = fmaf(av[u], __ldg(B + (k + u * COL_KL) * sbk + n * sbn),
                        acc[n]);
    }
    for (; k < k_end; k += COL_KL) {
      const float av = a[k * sak];
#pragma unroll
      for (int n = 0; n < NN; ++n)
        acc[n] = fmaf(av, B[k * sbk + n * sbn], acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NN; ++n) s_part[tk][ti][n] = acc[n];
  __syncthreads();
  if (tk == 0 && i < M) {
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      float sum = s_part[0][ti][n];
#pragma unroll
      for (int t = 1; t < COL_KL; ++t) sum += s_part[t][ti][n];
      out[static_cast<long long>(i) * NN + n] = sum;
    }
  }
}

// ---- the sum of a split's partials ---------------------------------------

// out[i] = act(sum over the splits, in split order, of part[s][i] + bias).
__global__ void __launch_bounds__(THREADS)
sum_splits_kernel(const float* __restrict__ part,
                  const float* __restrict__ bias, float* __restrict__ out,
                  long long count, int splits, int N, int relu) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < count; i += stride) {
    float sum = part[i];
#pragma unroll 8
    for (int s = 1; s < splits; ++s) sum += part[s * count + i];
    out[i] = epilogue(sum, bias, static_cast<int>(i % N), relu);
  }
}

// ---- launches -------------------------------------------------------------

struct Args {
  const void *a, *b;
  const float* bias;
  float* dst;
  int relu, M, N, K;
  long long sam, sak, sbk, sbn;
  int tiles_n, splits, chunk;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T>
void launch_fma(const Args& p) {
  dense_mm_kernel<T><<<p.grid, THREADS, 0, p.stream>>>(
      static_cast<const T*>(p.a), static_cast<const T*>(p.b), p.bias, p.dst,
      p.M, p.N, p.K, p.sam, p.sak, p.sbk, p.sbn, p.tiles_n, p.chunk, p.relu);
}

// More than the default 48 KB of dynamic shared memory for `kernel`, asked
// for once per device: `done` is the caller's own flag array for this
// kernel (the attribute belongs to the device's copy of the function, and a
// call costs more than the launch it precedes).
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64) done[dev] = true;
  return 0;
}

bool aligned16(const void* ptr, long long other_stride) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && other_stride % 4 == 0;
}

template <bool AK, bool BKC, bool ROUNDED>
int launch_tf32(const Args& p) {
  auto kernel = dense_mm_tf32_kernel<AK, BKC, ROUNDED>;
  static bool done[64] = {};  // one per instantiation of this function
  const int err = allow_smem(kernel, TC_SMEM, done);
  if (err != 0) return err;
  // 16-byte pieces run along the unit stride; the other stride and the base
  // must keep every piece aligned
  const int a_vec = AK ? p.sak == 1 && aligned16(p.a, p.sam)
                       : p.sam == 1 && aligned16(p.a, p.sak);
  const int b_vec = BKC ? p.sbk == 1 && aligned16(p.b, p.sbn)
                        : p.sbn == 1 && aligned16(p.b, p.sbk);
  kernel<<<p.grid, THREADS, TC_SMEM, p.stream>>>(
      static_cast<const float*>(p.a), static_cast<const float*>(p.b), p.bias,
      p.dst, p.M, p.N, p.K, p.sam, p.sak, p.sbk, p.sbn, p.tiles_n, p.chunk,
      a_vec, b_vec, p.relu);
  return 0;
}

// The stage's orientation follows each operand's unit stride; the sums are
// rounded where a block's range of the reduction is long.
int launch_tf32_any(const Args& p) {
  const bool ak = !(p.sam == 1 && p.sak != 1);
  const bool bk = p.sbk == 1 && p.sbn != 1;
  if (min(p.K, p.chunk) > CHAIN_MAX_K)
    return ak ? (bk ? launch_tf32<true, true, true>(p)
                    : launch_tf32<true, false, true>(p))
              : (bk ? launch_tf32<false, true, true>(p)
                    : launch_tf32<false, false, true>(p));
  return ak ? (bk ? launch_tf32<true, true, false>(p)
                  : launch_tf32<true, false, false>(p))
            : (bk ? launch_tf32<false, true, false>(p)
                  : launch_tf32<false, false, false>(p));
}

template <int NN>
int launch_narrow(const Args& p, bool rows) {
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  if (rows) {
    const size_t smem = sizeof(float) * NN * ((p.K + 3) & ~3);
    auto kernel = dense_narrow_rows_kernel<NN>;
    static bool done[64] = {};  // one per instantiation of this function
    int dev = 0, most = 0;  // the most shared memory a block may have
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int err = allow_smem(kernel, most, done);
    if (err != 0) return err;
    const int blocks = min(ROW_BLOCKS, (p.M + 7) / 8);
    kernel<<<blocks, THREADS, smem, p.stream>>>(
        a, b, p.bias, p.dst, p.M, p.K, p.sam, p.sbk, p.sbn,
        aligned16(p.a, p.sam), p.relu);
  } else {
    const dim3 grid((p.M + COL_I - 1) / COL_I, 1, p.splits);
    dense_narrow_cols_kernel<NN><<<grid, COL_I * COL_KL, 0, p.stream>>>(
        a, b, p.dst, p.M, p.K, p.sak, p.sbk, p.sbn, p.chunk);
  }
  return 0;
}

int launch_narrow_n(const Args& p, bool rows) {
  switch (p.N) {
    case 1: return launch_narrow<1>(p, rows);
    case 2: return launch_narrow<2>(p, rows);
    case 3: return launch_narrow<3>(p, rows);
    case 4: return launch_narrow<4>(p, rows);
    case 5: return launch_narrow<5>(p, rows);
    case 6: return launch_narrow<6>(p, rows);
    case 7: return launch_narrow<7>(p, rows);
    case 8: return launch_narrow<8>(p, rows);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: [M, K] and b: [K, N], both bf16 if bf16 else f32, element (i, j) at
// a + i * sam + j * sak (b: sbk, sbn), strides in elements, none negative;
// bias: [N] f32 contiguous or null; relu: 0 or 1; out [M, N] f32
// contiguous, 16-byte aligned.
// route: 0 fma, 1 tf32x3 (f32 only), 2 narrow rows (f32, N <= 8, sak == 1,
// splits == 1, at most 227 KB of B), 3 narrow columns (f32, N <= 8,
// sam == 1).
// The reduction is cut into `splits` ranges of `chunk` (a multiple of 32
// when splits > 1 on routes 0 and 1, with splits * chunk >= K); with
// splits > 1, scratch holds [splits, M, N] f32 and a second launch sums it
// into out and applies the bias and the ReLU. M, N, K > 0, splits <= 65535.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int dense_mm_cuda(const void* a, const void* b, int bf16,
                             const void* bias, int relu, void* out,
                             void* scratch, int M, int N, int K, long long sam,
                             long long sak, long long sbk, long long sbn,
                             int splits, int chunk, int route, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || sam < 0 || sak < 0 || sbk < 0 ||
      sbn < 0 || splits < 1 || splits > 65535 || chunk <= 0 ||
      static_cast<long long>(splits) * chunk < K || route < 0 || route > 3 ||
      (splits > 1 && scratch == nullptr) ||
      (splits > 1 && route < 2 && chunk % TK != 0) || (route > 0 && bf16) ||
      (route >= 2 && N > NARROW_MAX) || (route == 2 && (sak != 1 || splits > 1)) ||
      (route == 3 && sam != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_m = (M + BM - 1) / BM;
  const long long tiles_n = (N + BN - 1) / BN;
  if (tiles_m * tiles_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = a;
  p.b = b;
  // with a split, the epilogue belongs to the sum of the partials
  p.bias = splits > 1 ? nullptr : static_cast<const float*>(bias);
  p.relu = splits > 1 ? 0 : relu;
  p.dst = static_cast<float*>(splits > 1 ? scratch : out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.sam = sam;
  p.sak = sak;
  p.sbk = sbk;
  p.sbn = sbn;
  p.tiles_n = static_cast<int>(tiles_n);
  p.splits = splits;
  p.chunk = chunk;
  p.grid = dim3(static_cast<unsigned>(tiles_m * tiles_n), 1, splits);
  p.stream = static_cast<cudaStream_t>(stream);

  int err = 0;
  if (route == 0) {
    if (bf16)
      launch_fma<__nv_bfloat16>(p);
    else
      launch_fma<float>(p);
  } else if (route == 1) {
    err = launch_tf32_any(p);
  } else {
    err = launch_narrow_n(p, route == 2);
  }
  if (err != 0) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long count = static_cast<long long>(M) * N;
  const int blocks =
      static_cast<int>(min((count + THREADS - 1) / THREADS, 4096LL));
  sum_splits_kernel<<<blocks, THREADS, 0, p.stream>>>(
      static_cast<const float*>(scratch), static_cast<const float*>(bias),
      static_cast<float*>(out), count, splits, N, relu);
  return static_cast<int>(cudaGetLastError());
}
