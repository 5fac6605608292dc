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
// T [n_rows, E] f32 or bf16, idx [K, S] int32 tap-major, out [S, Cout] f32,
// the sum in f32. An index outside [0, n_rows) reads a row of zeros: the
// zero row the tables point missing neighbours at is never materialized. A
// leading batch dimension is grid.z with per-element strides.
//
// The probes gather the [BLK, 27 C] block into fast memory and hand one
// [BLK, 27 C] x [27 C, Cout] product to the matrix unit. Here the same
// product runs on the tensor cores with the gather inside the kernel, so
// the [K, S, E] gather never reaches device memory.
//
// What bounds it on an H100: one full-width encode (17 layers, site caps
// 6656 / 16128 / 9984 / 3072 / 1024, channels 16..128) is ~23 GFLOP if
// every tap is counted and ~16.5 GFLOP at the indices that name a row,
// over under 0.1 GB of compulsory bytes. bf16 operands on the tensor cores
// (989 TFLOP/s): bytes, ~0.03 ms. f32 operands go to the tensor cores as
// three TF32 products (495 TFLOP/s): operations, ~0.10 ms (on the f32 CUDA
// cores, 67 TFLOP/s, it would be ~0.25 ms).
//
// ---- the design: mma.sync on the tensor cores -----------------------------
//
// A block of 8 warps owns 64 sites x all of Cout (16 to 128), so a gathered
// row is read once per tile. The reduction (taps x E) is walked in stages
// of 64 (bf16) or 32 (f32) elements, 128 bytes of each gathered row, made
// of pieces of 16 that each belong to one tap; a stage may span taps (E =
// 48). The block first loads its tile's indices of every tap, finds the
// taps that no site of the tile names (they add nothing and are skipped,
// block-uniformly) and lists the pieces of the others. The rows of a stage
// and its slice of W arrive by 16-byte cp.async through a ring of three
// stages, so the next stages' gathers are in flight while this one
// multiplies; a missing row (an index outside the table) and a piece past
// the block's range are zero-filled by the copy itself (source size 0): no
// branch in the inner loop, no zero row in memory. Rows are padded by 16
// bytes (W's by 16 or 32) so that the fragment loads of a warp hit 32
// different banks.
//  * bf16: mma.sync.m16n8k16 (bf16 operands, f32 sums), the fragments by
//    ldmatrix (W, stored [k][n], by ldmatrix.trans). W comes to the kernel
//    in bf16.
//  * f32: mma.sync.m16n8k8 on TF32 halves: x = hi + lo, three products
//    a_lo b_hi + a_hi b_lo + a_hi b_hi per tile (the dropped a_lo b_lo is
//    2^-22 of a product), split in registers after the fragment load, as in
//    dense_mm.cu.
// The warps are 4 along the sites x 2 along Cout: a warp owns 16 sites x
// Cout / 2. The tensor core cuts its f32 sums instead of rounding them, so
// no chain runs longer than CHAIN = 256 of the reduction: every 256 the
// chain's sums join a master accumulator by a rounded f32 add.
// Where a layer's tiles would leave SMs idle or unevenly loaded (1024 sites:
// 16 tiles; 9984 sites: 156 tiles on 132 SMs) and its reduction is long (9
// x 384 = 3456), the host (ops/conv_kernel.py: split_plan, a model of the
// blocks' time on the card's SMs) cuts the reduction over grid.y: the
// `splits` blocks of a tile are one thread-block cluster, block y takes its
// share of the tile's listed pieces, keeps its partial tile in shared
// memory, and after a cluster barrier each block adds its slice of the tile
// over the cluster's blocks in rank order (distributed shared memory): no
// partial reaches device memory and no second launch runs. Every sum runs in a fixed order: the result is
// deterministic.
//
// Where its time goes (tools/conv_variants.py times builds of this source
// with a part taken out or changed, and every split count): in bf16 the
// copies (the gathered rows, and the slices of W, read once per 64-site
// tile) and the products each hide only in part behind the other, and
// without either an encode still takes about four fifths of its time; in
// f32 the three TF32 products and their splits weigh more than the copies.
// A fourth stage and shorter chains move it by about 1%; one resident
// block an SM costs 13-20%.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

constexpr int MMA_THREADS = 256;  // 8 warps: 4 along the sites x 2 along Cout
constexpr int MIN_BLOCKS = 2;     // resident blocks an SM the build plans for
constexpr int BM = 64;            // sites per block
constexpr int STAGES = 3;
constexpr int PIECE = 16;         // the reduction's unit: one tap, 16 of E
constexpr int CHAIN = 256;        // longest reduction chained in the tensor
                                  // core (dense_mm.cu: at most 320)
constexpr int MAX_K = 32;         // taps: one bit each in a warp's ballot
constexpr int MAX_SPLITS = 16;    // blocks of a cluster (beyond 8: the card's
                                  // non-portable cluster size)
constexpr int MAX_SMEM = 227 * 1024;

template <typename T>
struct StageDepth {
  static constexpr int value = 64;  // bf16: 128 bytes of a row
};
template <>
struct StageDepth<float> {
  static constexpr int value = 32;  // f32: 128 bytes of a row
};

template <typename T, int CO>
struct Layout {
  static constexpr int DEPTH = StageDepth<T>::value;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // 16 bytes
  static constexpr int PPS = DEPTH / PIECE;    // pieces a stage
  static constexpr int CPP = PIECE / EPC;      // 16-byte chunks of a piece row
  static constexpr int LDA = DEPTH + EPC;      // gathered row + 16 bytes
  static constexpr int LDW = CO + 8;           // W row + 16 (bf16) / 32 bytes
  static constexpr int STAGE = BM * LDA + DEPTH * LDW;  // elements
  static constexpr int STAGE_BYTES = STAGE * static_cast<int>(sizeof(T));
  static_assert(STAGE_BYTES % 16 == 0, "stages stay 16-byte aligned");
  static_assert(CHAIN % DEPTH == 0, "a chain is whole stages");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// d += a b on one m16n8k16 tile, bf16 operands.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b on one m16n8k8 tile, TF32 operands.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo with hi and lo TF32 values: hi is x cut to TF32, lo the rest
// (exact in f32) cut again; as dense_mm.cu splits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// One stage's products into the warp's chain accumulators: bf16.
template <int CO>
__device__ __forceinline__ void stage_products(
    float (&acc)[CO / 16][4], const __nv_bfloat16* sa,
    const __nv_bfloat16* sw, int wm, int wn, int lane) {
  using L = Layout<__nv_bfloat16, CO>;
  constexpr int NT = CO / 16;
#pragma unroll
  for (int kk = 0; kk < L::DEPTH; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, sa + (wm + (lane & 15)) * L::LDA + kk + (lane >> 4) * 8);
    uint32_t b[NT][2];
    if constexpr (NT == 1) {
      ldmatrix_x2_trans(b[0], sw + (kk + (lane & 15)) * L::LDW + wn);
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sw + (kk + (lane & 15)) * L::LDW + wn + np * 16 +
                                 (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt]);
  }
}

// The same for f32 operands: three TF32 products a tile, small terms first.
template <int CO>
__device__ __forceinline__ void stage_products(float (&acc)[CO / 16][4],
                                               const float* sa,
                                               const float* sw, int wm,
                                               int wn, int lane) {
  using L = Layout<float, CO>;
  constexpr int NT = CO / 16;
  const int gid = lane >> 2, tig = lane & 3;
  const float* ap = sa + (wm + gid) * L::LDA + tig;
  const float* bp = sw + tig * L::LDW + wn + gid;
#pragma unroll
  for (int kk = 0; kk < L::DEPTH; kk += 8) {
    uint32_t ah[4], al[4];
    split_tf32(ap[kk], ah[0], al[0]);                   // (gid, tig)
    split_tf32(ap[8 * L::LDA + kk], ah[1], al[1]);      // (gid + 8, tig)
    split_tf32(ap[kk + 4], ah[2], al[2]);               // (gid, tig + 4)
    split_tf32(ap[8 * L::LDA + kk + 4], ah[3], al[3]);  // (gid + 8, tig + 4)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(bp[kk * L::LDW + nt * 8], bh[0], bl[0]);        // k tig
      split_tf32(bp[(kk + 4) * L::LDW + nt * 8], bh[1], bl[1]);  // tig + 4
      mma_tf32(acc[nt], al, bh);
      mma_tf32(acc[nt], ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  }
}

// out's tile of 64 sites x CO channels: block y of the tile's cluster of
// `splits` blocks sums its share of the reduction, and the cluster adds
// the shares. W [K, E, CO] in T's type. The host sizes s_piece for the most
// pieces a block of this split count can list (launch_mma).
template <typename T, int CO>
__global__ void __launch_bounds__(MMA_THREADS, MIN_BLOCKS)
sparse_conv_mma_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                       const T* __restrict__ w, float* __restrict__ out,
                       int n_rows, int E, int K, int S,
                       long long table_bstride, int splits) {
  using L = Layout<T, CO>;
  constexpr int NT = CO / 16;       // 8-wide tiles of a warp's Cout / 2
  constexpr int CW = CO / L::EPC;   // 16-byte chunks of a W row
  constexpr int FLUSH = CHAIN / L::DEPTH;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_stage = reinterpret_cast<T*>(smem_raw);
  int* s_idx = reinterpret_cast<int*>(smem_raw + STAGES * L::STAGE_BYTES);
  int* s_taps = s_idx + K * BM;       // [MAX_K] named taps, then their count
  int* s_piece = s_taps + MAX_K + 1;  // the block's pieces: tap << 20 | e0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * BM;
  const int z = blockIdx.y;
  const long long b = blockIdx.z;
  table += b * table_bstride;
  idx += b * K * S;
  out += b * S * CO;

  // the tile's indices of every tap; a site past S names nothing
  for (int i = tid; i < K * BM; i += MMA_THREADS) {
    const int k = i / BM, r = i % BM;
    s_idx[i] = s0 + r < S ? idx[static_cast<long long>(k) * S + s0 + r] : -1;
  }
  __syncthreads();
  // the taps some site of the tile names, in order (a tap that none names
  // adds nothing: it is skipped for the whole block): the warps look at the
  // taps in turn, then one warp lists the named ones
  for (int k = warp; k < K; k += MMA_THREADS / 32) {
    const bool any =
        static_cast<unsigned>(s_idx[k * BM + lane]) <
            static_cast<unsigned>(n_rows) ||
        static_cast<unsigned>(s_idx[k * BM + 32 + lane]) <
            static_cast<unsigned>(n_rows);
    const int named = __any_sync(FULL, any);  // every lane votes
    if (lane == 0) s_taps[k] = named;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned named = __ballot_sync(FULL, lane < K && s_taps[lane]);
    if (lane < K && (named >> lane & 1u))
      s_taps[__popc(named & ((1u << lane) - 1u))] = lane;
    if (lane == 0) s_taps[MAX_K] = __popc(named);
  }
  __syncthreads();
  // this split's share of the listed pieces, whole stages each
  const int pe = E / PIECE;
  const int listed = s_taps[MAX_K] * pe;
  const int per =
      ((listed + splits - 1) / splits + L::PPS - 1) / L::PPS * L::PPS;
  const int q0 = z * per;
  const int nq = max(0, min(listed - q0, per));
  for (int i = tid; i < nq; i += MMA_THREADS) {
    const int q = q0 + i;
    const int j = q / pe;
    s_piece[i] = s_taps[j] << 20 | (q - j * pe) * PIECE;
  }
  __syncthreads();
  const int n_stages = (nq + L::PPS - 1) / L::PPS;

  // the copies of stage t: 64 gathered rows x 128 bytes, DEPTH rows of W
  auto load = [&](int t) {
    T* sa = s_stage + (t % STAGES) * L::STAGE;
    T* sw = sa + BM * L::LDA;
#pragma unroll
    for (int i = tid; i < BM * 8; i += MMA_THREADS) {
      const int r = i >> 3, c = i & 7;
      const int q = t * L::PPS + c / L::CPP;
      const T* src = w;  // any valid address: a copy of 0 bytes reads none
      int bytes = 0;
      if (q < nq) {
        const int info = s_piece[q];
        const unsigned row = static_cast<unsigned>(s_idx[(info >> 20) * BM + r]);
        if (row < static_cast<unsigned>(n_rows)) {
          src = table + static_cast<long long>(row) * E + (info & 0xfffff) +
                (c % L::CPP) * L::EPC;
          bytes = 16;
        }
      }
      cp_async16(sa + r * L::LDA + c * L::EPC, src, bytes);
    }
#pragma unroll
    for (int i = tid; i < L::DEPTH * CW; i += MMA_THREADS) {
      const int rr = i / CW, c = i % CW;
      const int q = t * L::PPS + rr / PIECE;
      const T* src = w;
      int bytes = 0;
      if (q < nq) {
        const int info = s_piece[q];
        src = w + (static_cast<long long>(info >> 20) * E + (info & 0xfffff) +
                   rr % PIECE) * CO + c * L::EPC;
        bytes = 16;
      }
      cp_async16(sw + rr * L::LDW + c * L::EPC, src, bytes);
    }
  };

  const int wm = (warp & 3) * 16;        // the warp's sites of the tile
  const int wn = (warp >> 2) * (CO / 2);  // and its channels
  float acc[NT][4], sum[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = sum[nt][r] = 0.f;

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_stages) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage t landed
    __syncthreads();              // everyone's did; stage t - 1 is consumed
    if (t + STAGES - 1 < n_stages) load(t + STAGES - 1);
    cp_async_commit();
    const T* sa = s_stage + (t % STAGES) * L::STAGE;
    stage_products<CO>(acc, sa, sa + BM * L::LDA, wm, wn, lane);
    if ((t + 1) % FLUSH == 0 || t + 1 == n_stages) {
      // the chain joins the master sums by rounded f32 adds
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sum[nt][r] += acc[nt][r];
          acc[nt][r] = 0.f;
        }
    }
  }

  // c0, c1: row gid, columns 2 tig, 2 tig + 1; c2, c3: row gid + 8
  const int gid = lane >> 2, tig = lane & 3;
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + wm + gid + 8 * h;
      if (s >= S) continue;
      float* row = out + static_cast<long long>(s) * CO + wn + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(sum[nt][2 * h], sum[nt][2 * h + 1]);
    }
    return;
  }
  // The split's partial tile [BM][CO] into its shared memory (over the
  // ring, now drained), then block y of the cluster adds its slice of the
  // tile over the cluster's blocks, in rank order, from their shared
  // memory: no partial reaches device memory, and the sum is deterministic.
  cp_async_wait<0>();
  __syncthreads();
  float* s_part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(
          &s_part[(wm + gid + 8 * h) * CO + wn + nt * 8 + 2 * tig]) =
          make_float2(sum[nt][2 * h], sum[nt][2 * h + 1]);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  constexpr int N4 = BM * CO / 4;
  const int share = (N4 + splits - 1) / splits;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * share + tid; i < min(N4, (rank + 1) * share);
       i += MMA_THREADS) {
    float4 acc = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(s_part, 0))[i];
    for (int r = 1; r < splits; ++r) {
      const float4 v = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(s_part, r))[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const int s = s0 + 4 * i / CO;
    if (s < S)
      *reinterpret_cast<float4*>(out + static_cast<long long>(s) * CO +
                                 4 * i % CO) = acc;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// Shared memory of one block.
template <typename T, int CO>
long long mma_smem(int K, int max_pieces) {
  return static_cast<long long>(STAGES) * Layout<T, CO>::STAGE_BYTES +
         4LL * (K * BM + MAX_K + 1 + max_pieces);
}

template <typename T, int CO>
int launch_mma(const void* table, const void* idx, const void* w, void* out,
               int B, int n_rows, int E, int K, int S, long long table_bstride,
               int splits, cudaStream_t stream) {
  using L = Layout<T, CO>;
  auto kernel = sparse_conv_mma_kernel<T, CO>;
  // a block's pieces: at most its share of every tap's, in whole stages
  const int all = K * (E / PIECE);
  const int max_pieces =
      ((all + splits - 1) / splits + L::PPS - 1) / L::PPS * L::PPS;
  const long long smem = mma_smem<T, CO>(K, max_pieces);
  static_assert(BM * CO * 4 <= STAGES * L::STAGE_BYTES,
                "a partial tile fits the ring");
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // above the default 48 KB and clusters of more than 8 blocks, asked for
  // once per device and instantiation
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
  // the splits of a tile are one cluster along grid.y
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + BM - 1) / BM, splits, B);
  cfg.blockDim = dim3(MMA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const T*>(w), static_cast<float*>(out), n_rows, E, K, S,
      table_bstride, splits));
}

template <typename T>
int launch_mma_co(int Cout, const void* table, const void* idx, const void* w,
                  void* out, int B, int n_rows, int E, int K, int S,
                  long long table_bstride, int splits, cudaStream_t stream) {
  switch (Cout) {
    case 16:
      return launch_mma<T, 16>(table, idx, w, out, B, n_rows, E, K, S,
                               table_bstride, splits, stream);
    case 32:
      return launch_mma<T, 32>(table, idx, w, out, B, n_rows, E, K, S,
                               table_bstride, splits, stream);
    case 64:
      return launch_mma<T, 64>(table, idx, w, out, B, n_rows, E, K, S,
                               table_bstride, splits, stream);
    case 128:
      return launch_mma<T, 128>(table, idx, w, out, B, n_rows, E, K, S,
                                table_bstride, splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table: B tables of [n_rows, E] (bf16 if table_bf16 else f32), element b
// at table + b * table_bstride elements, rows contiguous, 16-byte aligned;
// idx [B, K, S] int32; w [K, E, Cout] in the table's type; out [B, S, Cout]
// f32; all three contiguous and 16-byte aligned. E is a multiple of 16 below
// 2^20, Cout one of 16, 32, 64, 128, K at most 32, B at most 65535. The
// reduction is cut into `splits` (at most 16) ranges, the blocks of one
// cluster.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sparse_conv_cuda(const void* table, int table_bf16,
                                const void* idx, const void* w, void* out,
                                int B, int n_rows, int E, int K, int S,
                                int Cout, long long table_bstride, int splits,
                                void* stream) {
  if (B <= 0 || B > 65535 || n_rows < 0 || E <= 0 || E % 16 != 0 ||
      E >= (1 << 20) || K <= 0 || K > MAX_K || S <= 0 ||
      !(Cout == 16 || Cout == 32 || Cout == 64 || Cout == 128) ||
      table_bstride < 0 || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      table_bf16
          ? launch_mma_co<__nv_bfloat16>(Cout, table, idx, w, out, B, n_rows,
                                         E, K, S, table_bstride, splits, s)
          : launch_mma_co<float>(Cout, table, idx, w, out, B, n_rows, E, K, S,
                                 table_bstride, splits, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The tiling the host's plan (ops/conv_kernel.py: split_plan) assumes, into
// out[6]: sites a block, the stage's depth along the reduction in bf16 and
// in f32, the most taps, the most splits, the resident blocks an SM.
extern "C" void sparse_conv_tiling(int* out) {
  out[0] = BM;
  out[1] = StageDepth<__nv_bfloat16>::value;
  out[2] = StageDepth<float>::value;
  out[3] = MAX_K;
  out[4] = MAX_SPLITS;
  out[5] = MIN_BLOCKS;
}
