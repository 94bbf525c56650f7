// SPx-quantized matmul for Hopper (sm_90a): out = x @ (lut[codes] * scale).
//
// Replaces: src/repro/kernels/spx_matmul.py::spx_matmul_pallas (TPU).
//
// Computes x (M, K) f32 @ W (K, N), where W[k, n] = lut[code(k, n)] *
// scale[n]. Codes are uint8, either one per weight or two 4-bit codes per
// byte with the low nibble holding the even column. The sum over K is f32
// fused multiply-add on the CUDA cores at decode, and f32-exact sums of
// bf16 tensor-core products at prefill (below); TF32 is never used. The
// per-column scale is applied once, after the sum.
//
// Bound on the H100: at the decode shapes (M = one row per batch slot) the
// kernel must read every code once — K*N/2 bytes for packed 4-bit codes —
// and does 2*M*K*N flops, so it is bound by the bytes it reads (3.35
// TB/s). At the prefill shapes (M in the tens to thousands) the flops
// bound it: 67 TFLOP/s in f32 FMA, 989 TFLOP/s for one bf16 tensor-core
// pass, which the exact split below runs three times.
//
// Design:
//  * Decode (M <= 8), spx_matmul_kernel_skinny: a block is 8 warps over
//    256 output columns and one K range; a thread owns 8 consecutive
//    columns of up to 8 rows (MT = M rounded up to a power of two,
//    accumulators in registers). The block's codes and its slice of x
//    stream through a ring of 4 shared-memory stages (16 KB of codes: 128
//    rows packed, 64 unpacked), filled with 16-byte cp.async three stages
//    ahead of use, so some 48 KB per block are in flight while the warps
//    compute; each warp takes its own 16 (or 8) rows of every stage. Codes
//    are decoded in registers through a shared-memory LUT: two shifts and
//    masks per 8 codes and one byte permute per code give the entry's
//    byte offset, and 16 entries (sp2_4) leave no bank conflict whatever
//    the codes are; x is read as a broadcast, 4 rows per load. Each
//    output's 8 warp sums are added in warp order in shared memory.
//  * The K range is split over the blocks of a thread block cluster (a
//    power of two, at most 16, chosen for about one block per SM): rank 0
//    adds the cluster's sums through distributed shared memory in rank
//    order and applies the scale, so the result does not depend on
//    scheduling, and no partial sum goes through device memory.
//    Rows whose stride is not a multiple of 16 bytes are staged with
//    plain loads; a stage may run past a block's last K row, and those
//    rows are zero.
//  * Prefill (M > 8), spx_matmul_kernel_mma: one block per (64 or 128
//    rows) x 256 output columns and K range, one warpgroup per 64 rows,
//    each issuing wgmma.m64n256k16 with f32 accumulators in registers.
//    The wide tile halves the f32 x that every column tile stages and
//    splits again (faster per prefill tick than 128 columns).
//  * Loads. Thread 0 asks the TMA unit for each K step of 64 rows: x as
//    two 32-column boxes of 128-byte rows with the 128-byte swizzle, and
//    the codes' rows, into a 3-stage ring on mbarriers, two steps ahead;
//    elements past M, K or N arrive as zeros. The codes cross device
//    memory as codes, once per row tile. Rows that are not 16-byte
//    aligned take plain loads instead.
//  * Decode. The stage's codes go through the LUT into a bf16 plane of W
//    in shared memory, K-major with the 128-byte swizzle (wgmma's layout
//    without a transpose; a thread writes 8 K values of one column as one
//    16-byte store). 4-bit codes are looked up by byte permutes in
//    registers, with no memory access; 8-bit codes in a shared table. Two
//    plane buffers: the next sub-step's plane is decoded a quarter at a
//    time between this sub-step's MMA instructions. Issuing a wgmma holds
//    the warp until the tensor pipe takes it, so work placed between them
//    runs while the queued MMAs execute; work after them would not.
//  * Exact split. Each f32 value of x is cut into three bf16 planes, x1 =
//    bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), whose sum is x
//    exactly (24 significand bits in three 8-bit pieces; each difference
//    is exact in f32) while the pieces stay normal floats, |x| above about
//    2^-100; below that x3 loses subnormal bits, under 2^-126 each. The
//    planes are made in registers, as wgmma's A fragments, from the
//    staged x. A bf16 x bf16 product is exact in f32, so x @ W = x1 @ W +
//    x2 @ W + x3 @ W up to the order of the f32 sums when every W value is
//    exact in bf16: the case of sp2_4, pot3 and pot4, whose levels are
//    sums of two powers of two a few binades apart. Error: that of an f32
//    sum of 3K exact products in another order, |err| <= ~3K * 2^-24 *
//    sum|x||w| (the tensor cores' f32 accumulation included).
//  * LUTs not exact in bf16 (sp2_8, uniform8 and the other 5- and 8-bit
//    schemes): each K step runs a second sub-step on the plane w_lo =
//    bf16(lut - bf16(lut)). Dropped: lut - w_hi - w_lo, below 2^-16 of
//    |lut|, so |err| <= 2^-16 * sum|x||w| beyond the f32 sum's own. Each
//    block votes once over the LUT it loads (__syncthreads_or) whether any
//    w_lo is nonzero; exact LUTs run one sub-step a step. The MMA code
//    has no branch on the vote, so ptxas keeps the wgmmas asynchronous.
//  * The K range is split over a thread-block cluster when the tiles alone
//    cannot fill the card: the size (at most 16) that puts the most blocks
//    on it in one wave, asked of cudaOccupancyMaxActiveClusters (with one
//    block per SM, clusters must fit within the card's GPCs). Each rank
//    adds its share of the tile over the cluster's blocks in rank order
//    through distributed shared memory, so the result is bit-identical
//    from launch to launch, and no partial sum goes through device memory.
//    Unsplit blocks store straight from their accumulators.
//  * Small layers (N <= 128, K <= 1024: the paper's 784-128-10 MLP, the
//    Q-network), spx_matmul_kernel_small: tiles sized to the layer, so
//    that a 128-column layer still gives the card dozens of blocks, and no
//    cluster, TMA or mbarrier on the path. A block owns 8 I rows x 16 J
//    columns (I, J in 1, 2, 4, chosen by runtime/planner.py) and all of
//    K; its warps (up to 8, or 16 on tiles of at most 8 x 32) split K in
//    whole 16-row steps and add their sums in warp
//    order in shared memory, so no partial sum leaves the block. Each warp
//    stages its own K rows of x and of the codes by cp.async (16 bytes,
//    8 for 8-byte code rows), all in flight at once, then waits for them
//    alone; x's rows are padded and the code rows of a step permuted so
//    that the fragment loads hit every bank once.
//    The MMA is mma.sync m16n8k16 with the weights as A and x as B
//    (out^T = W^T x^T), so a tile is 8 rows of M, not 64: the A fragments
//    come straight from the codes in registers (4-bit codes by byte
//    permutes; 8-bit codes through a shared table with a copy per lane,
//    free of bank conflicts), with K permuted within a step so that a
//    thread's four K values are four consecutive code rows and one float4
//    of x. Exactness as below: three bf16 planes of x, and w_lo where the
//    LUT is not exact in bf16. x past K stages as zeros; rows of x past M
//    and codes past N or K are not copied (they reach only outputs that
//    are never stored, or meet x = 0); unaligned code rows (N = 10
//    packed: 5 bytes) and unaligned x take plain loads.
//  * All kernels mask the M, N and K edges themselves: every shape runs.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLutMax = 256;

constexpr int kThreads = 256;

// The decode kernel's shape: 8 warps over 256 output columns; a thread
// owns 8 columns. Codes and x stream through a ring of shared-memory
// stages (16 KB of codes: 128 rows packed, 64 unpacked), filled with
// cp.async. The K range is split over the blocks of a cluster.
constexpr int kSkinnyMaxM = 8;
constexpr int kCols = 8;                   // output columns per thread
constexpr int kBlockN = 32 * kCols;        // 256
constexpr int kWarpsK = kThreads / 32;     // 8
constexpr int kStages = 4;
constexpr int kCodeBytes = 16384;          // codes per stage
constexpr int kMinKps = 64;                // K rows per block, at least
constexpr int kMaxCluster = 16;            // Hopper's largest cluster

template <int MT, bool PACKED>
struct Stage {
  static constexpr int kRowBytes = PACKED ? kBlockN / 2 : kBlockN;
  static constexpr int kRows = kCodeBytes / kRowBytes;      // 128 or 64
  static constexpr int kWarpRows = kRows / kWarpsK;         // 16 or 8
  static constexpr int kBytes = kCodeBytes + MT * kRows * 4;  // + x slice
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows k0 .. k0 + kRows - 1 (of the block's kn) of the code tile and
// of x: 16-byte cp.async where rows are 16-byte aligned, else plain loads;
// rows past kn, rows of x past M and columns past N are zero.
template <int MT, bool PACKED>
__device__ __forceinline__ void load_stage(
    uint8_t* __restrict__ dst, const uint8_t* __restrict__ codes,
    const float* __restrict__ x, int k0, int kn, int k_base, int M, int K,
    int col_byte0, int row_bytes, bool codes_aligned, bool x_aligned) {
  using S = Stage<MT, PACKED>;
  constexpr int kRowChunks = S::kRowBytes / 16;
  if (codes_aligned) {
#pragma unroll
    for (int i = 0; i < kCodeBytes / 16 / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kRowChunks, off = (c % kRowChunks) * 16;
      const bool ok = k0 + r < kn && col_byte0 + off < row_bytes;
      const uint8_t* src =
          ok ? codes + (size_t)(k_base + k0 + r) * row_bytes + col_byte0 + off
             : codes;
      cp_async16(dst + r * S::kRowBytes + off, src, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < kCodeBytes; c += kThreads) {
      const int r = c / S::kRowBytes, off = c % S::kRowBytes;
      dst[c] = (k0 + r < kn && col_byte0 + off < row_bytes)
                   ? codes[(size_t)(k_base + k0 + r) * row_bytes + col_byte0 +
                           off]
                   : (uint8_t)0;
    }
  }
  float* xs = reinterpret_cast<float*>(dst + kCodeBytes);  // [MT][kRows]
  if (x_aligned) {
    const int c = threadIdx.x;
    if (c < MT * S::kRows / 4) {
      const int m = c / (S::kRows / 4), r = (c % (S::kRows / 4)) * 4;
      const int left = kn - (k0 + r);
      const int bytes = m < M ? 4 * (left < 0 ? 0 : left < 4 ? left : 4) : 0;
      const float* src =
          bytes ? x + (size_t)m * K + k_base + k0 + r : x;
      cp_async16(xs + m * S::kRows + r, src, bytes);
    }
  } else {
    for (int c = threadIdx.x; c < MT * S::kRows; c += kThreads) {
      const int m = c / S::kRows, r = c % S::kRows;
      xs[c] = (m < M && k0 + r < kn) ? x[(size_t)m * K + k_base + k0 + r]
                                     : 0.f;
    }
  }
}

// byte offsets (code * 4) of a thread's 8 columns' LUT entries: from one
// word of nibble pairs (low nibble = even column) or two words of codes
template <bool PACKED>
__device__ __forceinline__ void lut_offsets(const uint32_t (&w)[2],
                                            uint32_t (&o)[kCols]) {
  if (PACKED) {
    const uint32_t lo = (w[0] << 2) & 0x3C3C3C3Cu;  // byte b: 4 * code 2b
    const uint32_t hi = (w[0] >> 2) & 0x3C3C3C3Cu;  // byte b: 4 * code 2b+1
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      o[2 * b] = __byte_perm(lo, 0u, 0x4440u + b);
      o[2 * b + 1] = __byte_perm(hi, 0u, 0x4440u + b);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[j] = ((w[j / 4] >> (8 * (j % 4))) & 0xFFu) << 2;
  }
}

template <int MT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
spx_matmul_kernel_skinny(const float* __restrict__ x,
                         const uint8_t* __restrict__ codes,
                         const float* __restrict__ scale,
                         const float* __restrict__ lut,
                         float* __restrict__ out, int M, int K, int N,
                         int lut_size, int kps) {
  using S = Stage<MT, PACKED>;
  extern __shared__ __align__(16) uint8_t ring[];     // kStages * S::kBytes
  __shared__ __align__(16) float s_lut[kLutMax];
  __shared__ float s_sum[MT * kBlockN];                // the block's sums
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_begin = blockIdx.y * kps;
  const int kn = max(0, min(K, k_begin + kps) - k_begin);
  const int row_bytes = PACKED ? N / 2 : N;
  const int col_byte0 = blockIdx.x * S::kRowBytes;
  const bool codes_aligned = row_bytes % 16 == 0 &&
                             (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool x_aligned = K % 4 == 0 &&
                         (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n_stages = (kn + S::kRows - 1) / S::kRows;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages)
      load_stage<MT, PACKED>(ring + st * S::kBytes, codes, x, st * S::kRows,
                             kn, k_begin, M, K, col_byte0, row_bytes,
                             codes_aligned, x_aligned);
    cp_async_commit();
  }
  for (int i = tid; i < kLutMax; i += kThreads)
    s_lut[i] = i < lut_size ? lut[i] : 0.f;

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  const char* lut_bytes = reinterpret_cast<const char*>(s_lut);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // stage st landed; stage st - 1 is free
    const int nxt = st + kStages - 1;
    if (nxt < n_stages)
      load_stage<MT, PACKED>(ring + (nxt % kStages) * S::kBytes, codes, x,
                             nxt * S::kRows, kn, k_begin, M, K, col_byte0,
                             row_bytes, codes_aligned, x_aligned);
    cp_async_commit();

    // this warp's rows of the stage; rows past kn are zero codes and x 0
    const uint8_t* stage = ring + (st % kStages) * S::kBytes;
    const uint8_t* rows = stage + warp * S::kWarpRows * S::kRowBytes +
                          lane * (PACKED ? 4 : 8);
    const float* xs = reinterpret_cast<const float*>(stage + kCodeBytes) +
                      warp * S::kWarpRows;
    float xv[MT][S::kWarpRows];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < S::kWarpRows / 4; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(xs + m * S::kRows + 4 * i);
        xv[m][4 * i] = a.x;
        xv[m][4 * i + 1] = a.y;
        xv[m][4 * i + 2] = a.z;
        xv[m][4 * i + 3] = a.w;
      }
#pragma unroll
    for (int s = 0; s < S::kWarpRows; ++s) {
      uint32_t w[2];
      if (PACKED) {
        w[0] = *reinterpret_cast<const uint32_t*>(rows + s * S::kRowBytes);
        w[1] = 0u;
      } else {
        const uint2 t =
            *reinterpret_cast<const uint2*>(rows + s * S::kRowBytes);
        w[0] = t.x;
        w[1] = t.y;
      }
      uint32_t o[kCols];
      lut_offsets<PACKED>(w, o);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float wv = *reinterpret_cast<const float*>(lut_bytes + o[j]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m][j] = fmaf(xv[m][s], wv, acc[m][j]);
      }
    }
  }
  cp_async_wait<0>();

  // the block's sums: each warp writes its partial sums to the ring (4
  // rows of x at a time), and each thread adds the 8 warps' values of its
  // outputs in warp order
  float* red = reinterpret_cast<float*>(ring);
  constexpr int kChunk = MT < 4 ? MT : 4;
  static_assert(kStages * S::kBytes >= kWarpsK * kChunk * kBlockN * 4,
                "the warps' sums reuse the ring");
#pragma unroll
  for (int c0 = 0; c0 < MT; c0 += kChunk) {
    __syncthreads();          // the ring (or the last chunk) is read
#pragma unroll
    for (int mm = 0; mm < kChunk; ++mm) {
      float4* dst = reinterpret_cast<float4*>(
          &red[(warp * kChunk + mm) * kBlockN + lane * kCols]);
      dst[0] = make_float4(acc[c0 + mm][0], acc[c0 + mm][1], acc[c0 + mm][2],
                           acc[c0 + mm][3]);
      dst[1] = make_float4(acc[c0 + mm][4], acc[c0 + mm][5], acc[c0 + mm][6],
                           acc[c0 + mm][7]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int o = tid + i * kThreads;          // (mm, col), mm < kChunk
      const int mm = o / kBlockN, col = o % kBlockN;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsK; ++w)
        sum += red[(w * kChunk + mm) * kBlockN + col];
      s_sum[(c0 + mm) * kBlockN + col] = sum;
    }
  }
  // then the cluster's blocks, added in rank order by rank 0 through
  // distributed shared memory
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int ranks = (int)cluster.num_blocks();
    for (int o = tid; o < MT * kBlockN; o += kThreads) {
      const int m = o / kBlockN, n = blockIdx.x * kBlockN + o % kBlockN;
      if (m < M && n < N) {
        float part[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          part[r] = r < ranks ? cluster.map_shared_rank(s_sum, r)[o] : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) sum += part[r];
        out[(size_t)m * N + n] = sum * scale[n];
      }
    }
  }
  cluster.sync();             // no block leaves while rank 0 reads it
}

// -- prefill (M > 8): warpgroup MMA on an exact bf16 split of x ---------------

constexpr int kPreBN = 256;             // output columns per block
constexpr int kPreBK = 64;              // K rows per step: one 128-byte row
constexpr int kPreStages = 3;           // ring depth, in K steps
constexpr int kRedStride = kPreBN + 8;  // padded f32 row of the block's sums
constexpr int kBTile = kPreBN * kPreBK * 2;  // one bf16 plane of W, 32 KB
constexpr int kDecodeParts = kPreBK / 16;  // a plane's decode, in K16 slices

template <int WGS, bool PACKED>
struct Pre {
  static constexpr int kThreads = 128 * WGS;   // one warpgroup per 64 rows
  static constexpr int kBM = 64 * WGS;
  static constexpr int kRowBytes = PACKED ? kPreBN / 2 : kPreBN;
  static constexpr int kCodeBytes = kPreBK * kRowBytes;
  // a stage: x as two 32-column halves of 128-byte rows, 128-byte swizzle
  // (TMA's layout), then the codes' rows
  static constexpr int kXHalf = kBM * 128;
  static constexpr int kStageBytes = 2 * kXHalf + kCodeBytes;
  // 1 KB to align the planes for the swizzle, two W plane buffers, the ring
  static constexpr int kSmem = 1024 + 2 * kBTile + kPreStages * kStageBytes;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-aligned");
  static_assert(kBM * kRedStride * 4 <= 2 * kBTile + kPreStages * kStageBytes,
                "the block's sums reuse the planes and the ring");
};

// byte offset of x's (row, k) in a stage (k < 64): the 16-byte chunks of
// each 128-byte row XOR the row's index mod 8
__device__ __forceinline__ int x_off(int half_bytes, int row, int k) {
  return (k >> 5) * half_bytes + row * 128 +
         ((((k >> 2) & 7) ^ (row & 7)) << 4) + (k & 3) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma descriptor of a K-major bf16 tile with the 128-byte swizzle: rows
// of 64 values (128 bytes), 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout and set to 1
__device__ __forceinline__ uint64_t desc_b128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a 2-D box of a tensor map into shared memory by the TMA unit; out of
// bounds elements are zeros; the bytes complete on the mbarrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// acc += a (64 x 16, bf16 fragment in registers) @ B (16 x 256, bf16,
// K-major, 128-byte swizzle, read through desc_b)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + mid + lo exactly, for both values of a pair: each plane is the
// bf16 rounding of what the planes before it leave (the differences are
// exact in f32), packed low value first as the MMA's A fragment wants
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
}

// Stage K rows k0 .. k0 + kPreBK - 1 of the code tile and of x's rows
// m0 .. m0 + kBM - 1. With tensor maps, thread 0 asks the TMA unit for
// three boxes (x's two halves, the codes), completing on the stage's
// mbarrier; elements past M, K or N come back zero, and a block's K range
// is whole steps except at K's end. Else every thread loads, zero-filling
// rows past kn or M and columns past N.
template <int WGS, bool PACKED>
__device__ __forceinline__ void load_pre_stage(
    uint8_t* __restrict__ dst, uint64_t* bar, const CUtensorMap* tm_x,
    const CUtensorMap* tm_c, bool tma, const uint8_t* __restrict__ codes,
    const float* __restrict__ x, int k0, int kn, int k_base, int m0, int M,
    int K, int col_byte0, int row_bytes) {
  using P = Pre<WGS, PACKED>;
  uint8_t* cs = dst + 2 * P::kXHalf;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, P::kStageBytes);
      tma_load(dst, tm_x, k_base + k0, m0, bar);
      tma_load(dst + P::kXHalf, tm_x, k_base + k0 + 32, m0, bar);
      tma_load(cs, tm_c, col_byte0, k_base + k0, bar);
    }
    return;
  }
  for (int c = threadIdx.x; c < P::kCodeBytes; c += P::kThreads) {
    const int r = c / P::kRowBytes, off = c % P::kRowBytes;
    cs[c] = (k0 + r < kn && col_byte0 + off < row_bytes)
                ? codes[(size_t)(k_base + k0 + r) * row_bytes + col_byte0 +
                        off]
                : (uint8_t)0;
  }
  for (int c = threadIdx.x; c < P::kBM * kPreBK; c += P::kThreads) {
    const int m = c / kPreBK, k = c % kPreBK;
    *reinterpret_cast<float*>(dst + x_off(P::kXHalf, m, k)) =
        (m0 + m < M && k0 + k < kn)
            ? x[(size_t)(m0 + m) * K + k_base + k0 + k] : 0.f;
  }
}

// A 16-entry bf16 LUT in registers: byte b of lo[j] / hi[j] is the low /
// high byte of entry 4 j + b.
struct Lut16 {
  uint32_t lo[4], hi[4];
};

__device__ __forceinline__ Lut16 lut16(const uint16_t* t) {
  Lut16 r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.lo[j] = r.hi[j] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      r.lo[j] |= (uint32_t)(t[4 * j + b] & 0xFF) << (8 * b);
      r.hi[j] |= (uint32_t)(t[4 * j + b] >> 8) << (8 * b);
    }
  }
  return r;
}

// The nibbles h (0 low, 1 high) of a word's four bytes as one selector
// q0 | q1 << 4 | q2 << 8 | q3 << 12
__device__ __forceinline__ uint32_t nibbles(uint32_t w, int h) {
  uint32_t t = (w >> (4 * h)) & 0x0F0F0F0Fu;
  t = (t | (t >> 4)) & 0x00FF00FFu;
  return (t & 0xFFu) | ((t >> 8) & 0xFF00u);
}

// Four LUT entries by byte permutes, no memory access: (e(q0) | e(q1) <<
// 16, e(q2) | e(q3) << 16) for the four codes of selector s
__device__ __forceinline__ uint2 lookup4(const Lut16& t, uint32_t s) {
  const uint32_t s7 = s & 0x7777u;               // index within 8 entries
  const uint32_t sel = 0x3210u | ((s >> 1) & 0x4444u);   // which 8
  const uint32_t lo = __byte_perm(__byte_perm(t.lo[0], t.lo[1], s7),
                                  __byte_perm(t.lo[2], t.lo[3], s7), sel);
  const uint32_t hi = __byte_perm(__byte_perm(t.hi[0], t.hi[1], s7),
                                  __byte_perm(t.hi[2], t.hi[3], s7), sel);
  return make_uint2(__byte_perm(lo, hi, 0x5140u), __byte_perm(lo, hi, 0x7362u));
}

// Decode a stage's codes into one bf16 plane of W (hi or lo, by the
// tables given): W[k][n] of this step goes to byte n * 128 + ((k / 8) ^
// (n % 8)) * 16 + (k % 8) * 2 (K-major, 128-byte swizzle). A thread takes
// one code byte column over 8 K rows and writes 16 bytes per output
// column. 4-bit codes are looked up in registers, 8-bit ones in the shared
// table.
template <int WGS, bool PACKED>
__device__ __forceinline__ void decode_b(const uint8_t* __restrict__ st,
                                         uint8_t* plane, const uint16_t* tab,
                                         const Lut16& t, int part) {
  using P = Pre<WGS, PACKED>;
  constexpr int kCols = PACKED ? 2 : 1;        // output columns per byte
  constexpr int kUnits = P::kRowBytes * (kPreBK / 8);
  constexpr int kPart = kUnits / kDecodeParts;
  static_assert(kPart % P::kThreads == 0, "whole units per thread and part");
#pragma unroll
  for (int u = part * kPart + threadIdx.x; u < (part + 1) * kPart;
       u += P::kThreads) {
    const int jb = u % P::kRowBytes, kc = u / P::kRowBytes;
    uint32_t c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = st[(kc * 8 + i) * P::kRowBytes + jb];
#pragma unroll
    for (int hh = 0; hh < kCols; ++hh) {
      // odd byte columns of each 8 start with their high nibble, so one
      // store instruction's 32 columns cover all 8 swizzle slots
      const int h = PACKED ? hh ^ ((jb >> 2) & 1) : hh;
      const int n = jb * kCols + h;
      uint4 w;
      if (PACKED) {
        const uint2 w0 = lookup4(
            t, nibbles(c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24, h));
        const uint2 w1 = lookup4(
            t, nibbles(c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24, h));
        w = make_uint4(w0.x, w0.y, w1.x, w1.y);
      } else {
        w = make_uint4((uint32_t)tab[c[0]] | ((uint32_t)tab[c[1]] << 16),
                       (uint32_t)tab[c[2]] | ((uint32_t)tab[c[3]] << 16),
                       (uint32_t)tab[c[4]] | ((uint32_t)tab[c[5]] << 16),
                       (uint32_t)tab[c[6]] | ((uint32_t)tab[c[7]] << 16));
      }
      *reinterpret_cast<uint4*>(plane + n * 128 + ((kc ^ (n & 7)) << 4)) = w;
    }
  }
}

template <int WGS, bool PACKED>
__global__ void __launch_bounds__(Pre<WGS, PACKED>::kThreads)
spx_matmul_kernel_mma(const float* __restrict__ x,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ lut, float* __restrict__ out,
                      int M, int K, int N, int lut_size, int kps,
                      const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_c, int tma) {
  using P = Pre<WGS, PACKED>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint16_t s_hi[kLutMax], s_lo[kLutMax];   // bf16 bits
  __shared__ float s_scale[kPreBN];                    // the tile's scales
  cg::cluster_group cluster = cg::this_cluster();
  // two buffers of W's planes, 1024-aligned for the swizzle, then the ring
  uint8_t* b_pl = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = b_pl + 2 * kBTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kPreBN, m0 = blockIdx.y * P::kBM;
  const int k_begin = blockIdx.z * kps;
  const int kn = max(0, min(K, k_begin + kps) - k_begin);
  const int row_bytes = PACKED ? N / 2 : N;
  const int col_byte0 = blockIdx.x * P::kRowBytes;
  const int n_steps = (kn + kPreBK - 1) / kPreBK;

  // the LUT entries and scales of this thread, read before the loads queue
  constexpr int kLutPer = (kLutMax + P::kThreads - 1) / P::kThreads;
  float lut_v[kLutPer];
#pragma unroll
  for (int j = 0; j < kLutPer; ++j) {
    const int i = tid + j * P::kThreads;
    lut_v[j] = i < lut_size ? lut[i] : 0.f;
  }
  for (int i = tid; i < kPreBN; i += P::kThreads)
    s_scale[i] = n0 + i < N ? scale[n0 + i] : 0.f;
  __shared__ __align__(8) uint64_t full[kPreStages];   // stage landed
  if (tid == 0) {
    for (int i = 0; i < kPreStages; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int st = 0; st < kPreStages - 1; ++st)
    if (st < n_steps)
      load_pre_stage<WGS, PACKED>(ring + st * P::kStageBytes, &full[st],
                                  &tm_x, &tm_c, tma, codes, x, st * kPreBK,
                                  kn, k_begin, m0, M, K, col_byte0,
                                  row_bytes);
  // the LUT as bf16 hi + lo planes; one vote: does any entry need lo?
  int need_lo = 0;
#pragma unroll
  for (int j = 0; j < kLutPer; ++j) {
    const int i = tid + j * P::kThreads;
    if (i < kLutMax) {
      const __nv_bfloat16 h = __float2bfloat16_rn(lut_v[j]);
      const __nv_bfloat16 l =
          __float2bfloat16_rn(lut_v[j] - __bfloat162float(h));
      s_hi[i] = *reinterpret_cast<const uint16_t*>(&h);
      s_lo[i] = *reinterpret_cast<const uint16_t*>(&l);
      need_lo |= (s_lo[i] & 0x7FFF) != 0;
    }
  }
  const bool lo = __syncthreads_or(need_lo) != 0;
  // 4-bit codes: the first 16 entries of both planes' tables in registers
  const Lut16 t_hi = lut16(s_hi), t_lo = lut16(s_lo);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // this thread's rows of the warpgroup's 64 and its column pair in each
  // group of 8 (the MMA fragment layout)
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int acol = (lane & 3) * 2;

  // Sub-steps: each K step once with W's hi plane, and with a LUT that is
  // not exact in bf16 once more with its lo plane (x3 @ w_lo, below 2^-16
  // of the rest, comes along). A sub-step's plane is decoded into one of
  // two buffers between the MMAs of the sub-step before, which read the
  // other; x's planes for a step are split once, in registers.
  const int subs = lo ? 2 : 1;
  const int n_sub = n_steps * subs;
  uint32_t a[3][kPreBK / 16][4];        // plane, K16 slice, fragment register
  auto stage_of = [&](int st) {
    return ring + (st % kPreStages) * P::kStageBytes;
  };
  auto split_x = [&](int st) {
    const uint8_t* stage = stage_of(st);
#pragma unroll
    for (int j = 0; j < kPreBK / 16; ++j) {
      const int k = 16 * j + acol;
      auto xv = [&](int row, int kk) {
        return *reinterpret_cast<const float2*>(stage +
                                                x_off(P::kXHalf, row, kk));
      };
      split3(xv(arow, k), a[0][j][0], a[1][j][0], a[2][j][0]);
      split3(xv(arow + 8, k), a[0][j][1], a[1][j][1], a[2][j][1]);
      split3(xv(arow, k + 8), a[0][j][2], a[1][j][2], a[2][j][2]);
      split3(xv(arow + 8, k + 8), a[0][j][3], a[1][j][3], a[2][j][3]);
    }
  };
  // wait for step st's stage (loads without tensor maps landed before the
  // last barrier) and refill the slot of the step before it, which every
  // thread has read before that barrier
  auto open_step = [&](int st) {
    if (tma) mbar_wait(&full[st % kPreStages], (st / kPreStages) & 1);
    const int nxt = st + kPreStages - 1;
    if (nxt < n_steps)
      load_pre_stage<WGS, PACKED>(stage_of(nxt), &full[nxt % kPreStages],
                                  &tm_x, &tm_c, tma, codes, x, nxt * kPreBK,
                                  kn, k_begin, m0, M, K, col_byte0,
                                  row_bytes);
  };
  auto decode = [&](int u, int part) {
    const int p = u % subs;
    decode_b<WGS, PACKED>(stage_of(u / subs) + 2 * P::kXHalf,
                          b_pl + (u & 1) * kBTile, p ? s_lo : s_hi,
                          p ? t_lo : t_hi, part);
  };
  if (n_sub > 0) {
    open_step(0);
    for (int part = 0; part < kDecodeParts; ++part) decode(0, part);
    split_x(0);
    fence_proxy_async();
    __syncthreads();
  }
  for (int u = 0; u < n_sub; ++u) {
    const uint64_t d_b = desc_b128(b_pl + (u & 1) * kBTile);
    const bool more = u + 1 < n_sub, new_step = (u + 1) % subs == 0;
    // the next sub-step's plane is decoded a quarter at a time between
    // this one's MMAs, which queue while it runs (the MMAs of u - 1 read
    // its buffer, and are done: each warpgroup waited for them before the
    // last barrier)
    if (more && new_step) open_step((u + 1) / subs);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPreBK / 16; ++j) {
      // the K16 slice j starts 32 bytes into each 128-byte row
#pragma unroll
      for (int p = 0; p < 3; ++p) wgmma_m64n256k16(acc, a[p][j], d_b + 2 * j);
      if (more) decode(u + 1, j);
    }
    wgmma_commit();
    if (more) {
      wgmma_wait_all();         // this sub-step's MMAs: x's registers free
      if (new_step) split_x((u + 1) / subs);
      fence_proxy_async();
      __syncthreads();          // the plane is written
    }
  }
  wgmma_wait_all();
  __syncthreads();              // the planes and the ring are free

  const int ranks = (int)cluster.num_blocks();
  if (ranks == 1) {             // no K split: scale and store from registers
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int gn = n0 + 8 * i + acol;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + arow + 8 * h;
        if (gm >= M) continue;
        float* dst = out + (size_t)gm * N + gn;
        const float* sc = s_scale + 8 * i + acol;
        if (gn < N) dst[0] = acc[4 * i + 2 * h] * sc[0];
        if (gn + 1 < N) dst[1] = acc[4 * i + 2 * h + 1] * sc[1];
      }
    }
    return;
  }
  float* red = reinterpret_cast<float*>(b_pl);        // [kBM][kRedStride]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + acol;
    *reinterpret_cast<float2*>(&red[arow * kRedStride + col]) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(&red[(arow + 8) * kRedStride + col]) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  // each rank adds its share of the tile over the cluster's blocks in rank
  // order, through distributed shared memory (4 columns a read, all reads
  // of an output issued before its sum), and applies the scale
  cluster.sync();
  const float* part[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    part[r] = r < ranks ? cluster.map_shared_rank(red, r) : red;
  constexpr int kQuads = P::kBM * kPreBN / 4;
  const int share = (kQuads + ranks - 1) / ranks;
  const int o0 = (int)cluster.block_rank() * share;
  const int o1 = min(o0 + share, kQuads);
#pragma unroll 2
  for (int o = o0 + tid; o < o1; o += P::kThreads) {
    const int row = o / (kPreBN / 4), col = (o % (kPreBN / 4)) * 4;
    const int gm = m0 + row, gn = n0 + col;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < ranks) {
        const float4 v = *reinterpret_cast<const float4*>(
            part[r] + row * kRedStride + col);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    if (gm >= M) continue;
    float* dst = out + (size_t)gm * N + gn;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (gn + c < N) dst[c] = vals[c] * s_scale[col + c];
  }
  cluster.sync();               // no block leaves while another reads it
}

// -- small layers: warp MMAs on tiles sized to the layer ----------------------

constexpr int kSmemMax = 232448;        // a block's shared memory (opt-in)
constexpr int kTabCopies = 32;          // the 8-bit codes' table, per lane

// BYTES (4, 8 or 16) by cp.async through L1
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) @ b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int I, int J, bool PACKED>
struct Small {
  static constexpr int kBM = 8 * I;                   // rows of M
  static constexpr int kBN = 16 * J;                  // output columns
  static constexpr int kRowBytes = PACKED ? kBN / 2 : kBN;  // of a code row
  static constexpr int kCopy = kRowBytes < 16 ? kRowBytes : 16;  // cp.async
  static constexpr int kTabBytes = PACKED ? 0 : kLutMax * kTabCopies * 4;
  // warps over K: 16 where the tile's registers allow 512 threads
  static constexpr int kMaxWarps = I * J <= 2 ? 16 : 8;
};

// Where a small-path block keeps what: first (head_bytes) the 8-bit table
// and the tile's scales; then the codes (the tile's rows, kRowBytes each,
// row 16 s + 4 t + i at 16 s + 4 i + t) and x ([row][k], rows xs floats
// apart, xs * 4 = 64 mod 128 bytes); once every warp is done, the warps'
// sums ([warp][i][j][lane][4]) and the summed tile ([row][column], rows
// kBN + 4 floats apart) reuse the codes and x.
struct SmallLayout {
  int steps, xs, codes_bytes, head_bytes, total;
};
constexpr int kScaleBytes = 64 * 4;     // the widest tile's scales

template <int I, int J, bool PACKED>
__host__ __device__ inline SmallLayout small_layout(int K, int warps) {
  using S = Small<I, J, PACKED>;
  SmallLayout l;
  l.steps = (K + 15) / 16;
  l.xs = l.steps * 16 + (l.steps % 2 ? 0 : 16);
  l.codes_bytes = l.steps * 16 * S::kRowBytes;
  l.head_bytes = S::kTabBytes + kScaleBytes;
  const int stage = l.codes_bytes + S::kBM * l.xs * 4;
  const int red = (warps * S::kBN + S::kBN + 4) * S::kBM * 4;
  l.total = l.head_bytes + (stage > red ? stage : red);
  return l;
}

template <int I, int J, bool PACKED>
__global__ void __launch_bounds__(Small<I, J, PACKED>::kMaxWarps * 32)
spx_matmul_kernel_small(const float* __restrict__ x,
                        const uint8_t* __restrict__ codes,
                        const float* __restrict__ scale,
                        const float* __restrict__ lut,
                        float* __restrict__ out, int M, int K, int N,
                        int lut_size) {
  using S = Small<I, J, PACKED>;
  extern __shared__ __align__(16) uint8_t smem_small[];
  const int warps = blockDim.x >> 5;
  const SmallLayout L = small_layout<I, J, PACKED>(K, warps);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_small);
  float* s_scale =
      reinterpret_cast<float*>(smem_small + L.head_bytes - kScaleBytes);
  uint8_t* cs = smem_small + L.head_bytes;
  float* xs = reinterpret_cast<float*>(cs + L.codes_bytes);
  float* red = reinterpret_cast<float*>(cs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * S::kBN, m0 = blockIdx.y * S::kBM;
  const int row_bytes = PACKED ? N / 2 : N;
  const int col_byte0 = PACKED ? n0 / 2 : n0;
  // this warp's K steps of 16 rows
  const int s_lo = warp * L.steps / warps;
  const int s_hi = (warp + 1) * L.steps / warps;

  // The LUT's entries, first in flight: for 4-bit codes four a lane
  // (entries 4 (lane % 4) .. + 3); for 8-bit codes 32 a round per warp,
  // one a lane.
  constexpr int kRounds = PACKED ? 1 : kLutMax / 32;
  constexpr int kLutLoads = PACKED ? 4 : kRounds;
  float lv[kLutLoads];
#pragma unroll
  for (int q = 0; q < kLutLoads; ++q) {
    const int e = PACKED ? 4 * (lane & 3) + q
                         : (warp + q * warps) * 32 + lane;
    lv[q] = e < lut_size ? __ldg(lut + e) : 0.f;
  }

  // Stage this warp's rows of x and of the code tile, all in flight at
  // once; x first, so that plain loads of unaligned code rows wait under
  // its copies. Code row 16 s + 4 t + i goes to row 16 s + 4 i + t: the
  // four threads t that read row i of their quads read consecutive rows,
  // so a step's reads hit every bank once. Only what the stored outputs
  // read is copied: rows of x past M and code
  // bytes past N feed only outputs that are never stored, and code rows
  // past K meet x = 0 (a code is an index into a finite table, whatever
  // its bits).
  {
    const int r0 = 16 * s_lo, nr = 16 * (s_hi - s_lo);
    const bool x_aligned =
        K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int chunks = nr / 4;              // of 4 floats, per row of x
    const int mr = min(S::kBM, M - m0);     // rows of x to copy
#pragma unroll 4
    for (int c = lane; c < mr * chunks; c += 32) {
      const int m = c / chunks, k = r0 + 4 * (c % chunks);
      float* dst = xs + m * L.xs + k;
      const float* src = x + (size_t)(m0 + m) * K + k;
      if (x_aligned && k < K) {
        cp_async16(dst, src, 16);
      } else {
        for (int e = 0; e < 4; ++e) dst[e] = k + e < K ? src[e] : 0.f;
      }
    }
    const int kr = min(nr, K - r0);         // code rows to copy
    const bool c_aligned =
        row_bytes % S::kCopy == 0 &&
        (reinterpret_cast<uintptr_t>(codes) & (S::kCopy - 1)) == 0;
    // pieces a row: copies of kCopy bytes, or words of plain loads
    const int per = S::kRowBytes / (c_aligned ? S::kCopy : 4);
#pragma unroll 4
    for (int c = lane; c < kr * per; c += 32) {
      const int r = r0 + c / per, piece = c % per;
      uint8_t* dst = cs + ((r & ~15) | ((r & 3) << 2) | ((r >> 2) & 3)) *
                              S::kRowBytes;
      if (c_aligned) {
        const int b0 = col_byte0 + piece * S::kCopy;
        if (b0 < row_bytes)
          cp_async_ca<S::kCopy>(dst + piece * S::kCopy,
                                codes + (size_t)r * row_bytes + b0);
      } else {
        const int b0 = col_byte0 + 4 * piece;
        uint32_t v = 0;
        for (int b = 0; b < 4 && b0 + b < row_bytes; ++b)
          v |= (uint32_t)codes[(size_t)r * row_bytes + b0 + b] << (8 * b);
        *reinterpret_cast<uint32_t*>(dst + 4 * piece) = v;
      }
    }
  }
  for (int i = tid; i < S::kBN && n0 + i < N; i += blockDim.x)
    cp_async_ca<4>(s_scale + i, scale + n0 + i);
  cp_async_commit();

  // The LUT as bf16 planes hi = bf16(lut), lo = bf16(lut - hi): 4-bit
  // codes in registers (Lut16, the same in every lane; the lo test a warp
  // vote), 8-bit codes in a shared table of
  // (hi | lo << 16) with one copy per lane: each warp shuffles its 32
  // entries of a round to every lane's copy (entry e of lane l at word e *
  // 32 + l); rounds past the LUT write zeros.
  Lut16 t_hi, t_lo;
  bool lo;
  if constexpr (PACKED) {
    // lane l holds word l % 16 of the two tables: plane (l / 8) % 2 (hi,
    // lo), byte (l / 4) % 2 (low, high) of entries 4 (l % 4) .. + 3;
    // every lane gathers the 16 words by shuffles
    uint32_t word = 0;
    int any = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const __nv_bfloat16 h = __float2bfloat16_rn(lv[b]);
      const __nv_bfloat16 l =
          __float2bfloat16_rn(lv[b] - __bfloat162float(h));
      const uint32_t lb = __bfloat16_as_ushort(l);
      const uint32_t e = (lane & 8) ? lb : __bfloat16_as_ushort(h);
      word |= ((lane & 4) ? e >> 8 : e & 0xFFu) << (8 * b);
      any |= (lb & 0x7FFF) != 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t_hi.lo[j] = __shfl_sync(0xFFFFFFFFu, word, j);
      t_hi.hi[j] = __shfl_sync(0xFFFFFFFFu, word, 4 + j);
      t_lo.lo[j] = __shfl_sync(0xFFFFFFFFu, word, 8 + j);
      t_lo.hi[j] = __shfl_sync(0xFFFFFFFFu, word, 12 + j);
    }
    lo = __any_sync(0xFFFFFFFFu, any) != 0;
  } else {
    uint32_t hl[kRounds];
    int any = 0;
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const __nv_bfloat16 h = __float2bfloat16_rn(lv[q]);
      const __nv_bfloat16 l =
          __float2bfloat16_rn(lv[q] - __bfloat162float(h));
      const uint32_t lb = __bfloat16_as_ushort(l);
      hl[q] = __bfloat16_as_ushort(h) | (lb << 16);
      any |= (lb & 0x7FFF) != 0;
    }
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int b = warp + q * warps;       // the round, the same warp-wide
      if (b >= kRounds) continue;
      if (32 * b < lut_size) {
#pragma unroll 8
        for (int src = 0; src < 32; ++src)
          tab[(32 * b + src) * kTabCopies + lane] =
              __shfl_sync(0xFFFFFFFFu, hl[q], src);
      } else {
        uint4* z = reinterpret_cast<uint4*>(tab + 32 * b * kTabCopies);
        for (int u = lane; u < 8 * kTabCopies; u += 32)
          z[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    lo = __syncthreads_or(any) != 0;
  }
  cp_async_wait<0>();
  __syncwarp();               // the warp's stage has landed

  float acc[I][J][4];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // A step's K slots 2t, 2t + 1, 2t + 8, 2t + 9 (the fragments' layout)
  // hold rows 16 s + 4t + 0..3: one float4 of x (B) and one word of each
  // of four code rows (A), staged at rows 16 s + 4 i + t. A's row g is
  // output column n0 + 2 (J g + j), row g + 8 the next one: the low and
  // the high nibble of one code byte.
#pragma unroll 2
  for (int s = s_lo; s < s_hi; ++s) {
    uint32_t b[3][I][2];                  // x's planes, per row tile
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          xs + (8 * i + g) * L.xs + 16 * s + 4 * t);
      split3(make_float2(v.x, v.y), b[0][i][0], b[1][i][0], b[2][i][0]);
      split3(make_float2(v.z, v.w), b[0][i][1], b[1][i][1], b[2][i][1]);
    }
    const uint8_t* rows_s = cs + (16 * s + t) * S::kRowBytes;
    // word w of the thread's four rows
    auto quad = [&](int w) {
      return make_uint4(
          *reinterpret_cast<const uint32_t*>(rows_s + 4 * w),
          *reinterpret_cast<const uint32_t*>(rows_s + 4 * S::kRowBytes +
                                             4 * w),
          *reinterpret_cast<const uint32_t*>(rows_s + 8 * S::kRowBytes +
                                             4 * w),
          *reinterpret_cast<const uint32_t*>(rows_s + 12 * S::kRowBytes +
                                             4 * w));
    };
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t a[4], al[4];
      if constexpr (PACKED) {
        const int byte = J * g + j;         // of the tile's code row
        const uint4 v = quad(byte >> 2);
        const uint32_t sel = (byte & 3) | (((byte & 3) + 4) << 4);
        const uint32_t c = __byte_perm(__byte_perm(v.x, v.y, sel),
                                       __byte_perm(v.z, v.w, sel), 0x5410);
        const uint32_t q0 = nibbles(c, 0), q1 = nibbles(c, 1);
        const uint2 e0 = lookup4(t_hi, q0), e1 = lookup4(t_hi, q1);
        a[0] = e0.x;
        a[1] = e1.x;
        a[2] = e0.y;
        a[3] = e1.y;
        if (lo) {
          const uint2 f0 = lookup4(t_lo, q0), f1 = lookup4(t_lo, q1);
          al[0] = f0.x;
          al[1] = f1.x;
          al[2] = f0.y;
          al[3] = f1.y;
        }
      } else {
        const int byte = 2 * (J * g + j);   // column h at byte + h
        const uint4 v = quad(byte >> 2);
        const uint32_t rows[4] = {v.x, v.y, v.z, v.w};
        uint32_t e[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            e[r][h] = tab[((rows[r] >> (8 * ((byte & 3) + h))) & 0xFF) *
                              kTabCopies + lane];
        a[0] = __byte_perm(e[0][0], e[1][0], 0x5410);
        a[1] = __byte_perm(e[0][1], e[1][1], 0x5410);
        a[2] = __byte_perm(e[2][0], e[3][0], 0x5410);
        a[3] = __byte_perm(e[2][1], e[3][1], 0x5410);
        al[0] = __byte_perm(e[0][0], e[1][0], 0x7632);
        al[1] = __byte_perm(e[0][1], e[1][1], 0x7632);
        al[2] = __byte_perm(e[2][0], e[3][0], 0x7632);
        al[3] = __byte_perm(e[2][1], e[3][1], 0x7632);
      }
#pragma unroll
      for (int i = 0; i < I; ++i) {
#pragma unroll
        for (int p = 0; p < 3; ++p)
          mma16816(acc[i][j], a, b[p][i][0], b[p][i][1]);
        if (lo) {
          mma16816(acc[i][j], al, b[0][i][0], b[0][i][1]);
          mma16816(acc[i][j], al, b[1][i][0], b[1][i][1]);
        }
      }
    }
  }

  // The warps' sums, added in warp order in the fragments' order (every
  // read on its own bank) into a [row][column] tile; then the scale, and
  // stores along N.
  __syncthreads();            // every warp is done with the staged tiles
  float4* red4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
      red4[((warp * I + i) * J + j) * 32 + lane] = make_float4(
          acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  __syncthreads();
  constexpr int kTile = I * J * 128, kStride = S::kBN + 4;
  float* tile = red + warps * kTile;
  for (int o = tid; o < kTile; o += blockDim.x) {
    float sum = 0.f;
#pragma unroll 4
    for (int w = 0; w < warps; ++w) sum += red[w * kTile + o];
    // D's element c of lane l in tile (i, j): row 2 t + c % 2 of the
    // row tile, column 2 (J g + j) + c / 2 (A's row g or g + 8)
    const int c = o & 3, l = (o >> 2) & 31, ij = o >> 7;
    tile[(8 * (ij / J) + 2 * (l & 3) + (c & 1)) * kStride +
         2 * (J * (l >> 2) + ij % J) + (c >> 1)] = sum;
  }
  __syncthreads();
  for (int q = tid; q < S::kBM * S::kBN; q += blockDim.x) {
    const int ml = q / S::kBN, nl = q % S::kBN;
    const int m = m0 + ml, n = n0 + nl;
    if (m < M && n < N)
      out[(size_t)m * N + n] = tile[ml * kStride + nl] * s_scale[nl];
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

int skinny_kps(int K, int splits) {
  return ceil_div(ceil_div(K, splits), kMinKps) * kMinKps;
}

// Blocks per cluster along K: the power of two (<= kMaxCluster) that
// brings the grid to about one block per SM, with >= kMinKps rows each.
int skinny_splits(int K, int N, int sms) {
  const int want = ceil_div(sms, ceil_div(N, kBlockN));
  int s = 1;
  while (s < want && s < kMaxCluster && ceil_div(K, 2 * s) >= kMinKps)
    s *= 2;
  return s;
}

template <int MT, bool PACKED>
cudaError_t launch_skinny_as(const float* x, const uint8_t* codes,
                             const float* scale, const float* lut,
                             float* out, int M, int K, int N, int lut_size,
                             int splits, cudaStream_t stream) {
  if (splits < 1 || splits > kMaxCluster) return cudaErrorInvalidValue;
  constexpr int kRing = kStages * Stage<MT, PACKED>::kBytes;
  // clusters above 8 blocks and the ring's shared memory need the
  // kernel's attributes; set once per instance
  static const cudaError_t attr_err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        spx_matmul_kernel_skinny<MT, PACKED>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(spx_matmul_kernel_skinny<MT, PACKED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kRing);
  }();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(N, kBlockN), splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kRing;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, spx_matmul_kernel_skinny<MT, PACKED>, x,
                            codes, scale, lut, out, M, K, N, lut_size,
                            skinny_kps(K, splits));
}

template <int MT>
cudaError_t launch_skinny(const float* x, const uint8_t* codes,
                          const float* scale, const float* lut, float* out,
                          int M, int K, int N, int packed, int lut_size,
                          int splits, cudaStream_t stream) {
  return packed ? launch_skinny_as<MT, true>(x, codes, scale, lut, out, M, K,
                                             N, lut_size, splits, stream)
                : launch_skinny_as<MT, false>(x, codes, scale, lut, out, M,
                                              K, N, lut_size, splits,
                                              stream);
}

template <int WGS, bool PACKED>
cudaError_t mma_attributes() {
  // clusters above 8 blocks and the shared memory need the kernel's
  // attributes; set once per instance
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        spx_matmul_kernel_mma<WGS, PACKED>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(spx_matmul_kernel_mma<WGS, PACKED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Pre<WGS, PACKED>::kSmem);
  }();
  return err;
}

// How many clusters of s prefill blocks the card holds at once (0 when the
// query fails), asked once per size: with one block per SM, clusters must
// fit within the card's GPCs, so large clusters leave SMs idle.
template <int WGS>
int mma_resident_clusters(int s) {
  static int cache[kMaxCluster + 1] = {};
  if (cache[s] == 0) {
    int n = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, s);
    cfg.blockDim = dim3(Pre<WGS, false>::kThreads);
    cfg.dynamicSmemBytes = Pre<WGS, false>::kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (mma_attributes<WGS, false>() != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(
            &n, spx_matmul_kernel_mma<WGS, false>, &cfg) != cudaSuccess)
      n = 0;
    cache[s] = n > 0 ? n : -1;
  }
  return cache[s] > 0 ? cache[s] : 0;
}

// K rows per prefill block: an even share, in whole K steps
int mma_kps(int K, int splits) {
  return ceil_div(ceil_div(K, splits), kPreBK) * kPreBK;
}

// Blocks per cluster along K for the prefill kernel: the size (<=
// kMaxCluster, at least one K step per block) that puts the most blocks on
// the card in one wave of resident clusters.
int mma_splits(int M, int K, int N, int sms) {
  const bool wide = M > 64;
  const int tiles = ceil_div(N, kPreBN) * ceil_div(M, wide ? 128 : 64);
  int best = 1, best_blocks = tiles < sms ? tiles : sms;
  for (int s = 2; s <= kMaxCluster && ceil_div(K, s) >= kPreBK; ++s) {
    if (ceil_div(K, mma_kps(K, s)) != s) continue;     // no empty blocks
    const int fit = wide ? mma_resident_clusters<2>(s)
                         : mma_resident_clusters<1>(s);
    if (tiles <= fit && tiles * s > best_blocks) {
      best = s;
      best_blocks = tiles * s;
    }
  }
  return best;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null when the driver does not offer it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor maps of x (M, K) f32, boxes of 32 x kBM with the 128-byte
// swizzle, and of the codes (K, row_bytes) u8, boxes of kRowBytes x
// kPreBK; false where the rows are not 16-byte aligned or encoding fails
template <int WGS, bool PACKED>
bool tensor_maps(const float* x, const uint8_t* codes, int M, int K,
                 int row_bytes, CUtensorMap* tm_x, CUtensorMap* tm_c) {
  using P = Pre<WGS, PACKED>;
  const EncodeTiled encode = encode_tiled();
  if (!encode || K % 4 || row_bytes % 16 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(codes)) &
       15))
    return false;
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_stride[1] = {(cuuint64_t)K * 4};
  const cuuint32_t x_box[2] = {32, (cuuint32_t)P::kBM};
  const cuuint64_t c_dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)K};
  const cuuint64_t c_stride[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t c_box[2] = {(cuuint32_t)P::kRowBytes, (cuuint32_t)kPreBK};
  return encode(tm_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(x), x_dims, x_stride, x_box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(tm_c, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<uint8_t*>(codes), c_dims, c_stride, c_box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WGS, bool PACKED>
cudaError_t launch_mma_as(const float* x, const uint8_t* codes,
                          const float* scale, const float* lut, float* out,
                          int M, int K, int N, int lut_size, int splits,
                          cudaStream_t stream) {
  using P = Pre<WGS, PACKED>;
  if (splits < 1 || splits > kMaxCluster) return cudaErrorInvalidValue;
  const cudaError_t attr_err = mma_attributes<WGS, PACKED>();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(N, kPreBN), ceil_div(M, P::kBM), splits);
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUtensorMap tm_x = {}, tm_c = {};
  const int tma = tensor_maps<WGS, PACKED>(x, codes, M, K, PACKED ? N / 2 : N,
                                           &tm_x, &tm_c);
  return cudaLaunchKernelEx(&cfg, spx_matmul_kernel_mma<WGS, PACKED>, x,
                            codes, scale, lut, out, M, K, N, lut_size,
                            mma_kps(K, splits), tm_x, tm_c, tma);
}

cudaError_t launch_mma(const float* x, const uint8_t* codes,
                       const float* scale, const float* lut, float* out,
                       int M, int K, int N, int packed, int lut_size,
                       int splits, cudaStream_t stream) {
  if (M <= 64)
    return packed ? launch_mma_as<1, true>(x, codes, scale, lut, out, M, K,
                                           N, lut_size, splits, stream)
                  : launch_mma_as<1, false>(x, codes, scale, lut, out, M, K,
                                            N, lut_size, splits, stream);
  return packed ? launch_mma_as<2, true>(x, codes, scale, lut, out, M, K, N,
                                         lut_size, splits, stream)
                : launch_mma_as<2, false>(x, codes, scale, lut, out, M, K, N,
                                          lut_size, splits, stream);
}

template <int I, int J, bool PACKED>
cudaError_t launch_small_as(const float* x, const uint8_t* codes,
                            const float* scale, const float* lut, float* out,
                            int M, int K, int N, int lut_size, int warps,
                            cudaStream_t stream) {
  using S = Small<I, J, PACKED>;
  const SmallLayout l = small_layout<I, J, PACKED>(K, warps);
  if (warps < 1 || warps > S::kMaxWarps || M < 1 || N < 1 ||
      l.total > kSmemMax)
    return cudaErrorInvalidValue;
  // the shared memory above 48 KB needs the kernel's attribute; set once
  // per instance
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      spx_matmul_kernel_small<I, J, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid(ceil_div(N, S::kBN), ceil_div(M, S::kBM));
  spx_matmul_kernel_small<I, J, PACKED><<<grid, warps * 32, l.total, stream>>>(
      x, codes, scale, lut, out, M, K, N, lut_size);
  return cudaGetLastError();
}

// the small-path instance of a tile: 8 I rows x 16 J columns, I and J in
// 1, 2, 4; any other tile is refused
template <bool PACKED>
cudaError_t launch_small(const float* x, const uint8_t* codes,
                         const float* scale, const float* lut, float* out,
                         int M, int K, int N, int lut_size, int tile_m,
                         int tile_n, int warps, cudaStream_t stream) {
#define REPRO_SMALL(TI, TJ)                                                 \
  if (tile_m == 8 * TI && tile_n == 16 * TJ)                                \
    return launch_small_as<TI, TJ, PACKED>(x, codes, scale, lut, out, M, K, \
                                           N, lut_size, warps, stream);
  REPRO_SMALL(1, 1) REPRO_SMALL(1, 2) REPRO_SMALL(1, 4)
  REPRO_SMALL(2, 1) REPRO_SMALL(2, 2) REPRO_SMALL(2, 4)
  REPRO_SMALL(4, 1) REPRO_SMALL(4, 2) REPRO_SMALL(4, 4)
#undef REPRO_SMALL
  return cudaErrorInvalidValue;
}

// the launch plans' paths (runtime/planner.py: plan_spx_launch)
constexpr int kPathSkinny = 0, kPathMma = 1, kPathSmall = 2;

}  // namespace

extern "C" {

// Blocks per thread-block cluster along K that the launch will use, for
// either kernel (M <= 8: the decode kernel, else the prefill kernel); the
// cluster adds its K splits itself, so no buffer depends on it.
int spx_matmul_splits(int M, int K, int N, int sms) {
  return M <= kSkinnyMaxM ? skinny_splits(K, N, sms)
                          : mma_splits(M, K, N, sms);
}

// x (M, K) f32, codes (K, N/2) packed or (K, N) uint8, scale (N,) f32,
// lut (lut_size,) f32, out (M, N) f32; all contiguous, on the device.
// The plan (runtime/planner.py: plan_spx_launch) names the kernel: path 0
// the decode kernel (M <= 8) with `splits` blocks per cluster, 1 the
// prefill kernel (M > 8) likewise, 2 the small-layer kernel with its tile
// (tile_m x tile_n) and warps; a plan the kernels cannot run is refused
// (cudaErrorInvalidValue) and nothing launches. Returns
// cudaGetLastError() after the launch.
int spx_matmul_f32(const float* x, const uint8_t* codes, const float* scale,
                   const float* lut, float* out, int M, int K, int N,
                   int packed, int lut_size, int path, int splits,
                   int tile_m, int tile_n, int warps, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_SKINNY(MT)                                                    \
  launch_skinny<MT>(x, codes, scale, lut, out, M, K, N, packed, lut_size,   \
                    splits, stream)
  if (path == kPathSmall) {
    err = packed ? launch_small<true>(x, codes, scale, lut, out, M, K, N,
                                      lut_size, tile_m, tile_n, warps,
                                      stream)
                 : launch_small<false>(x, codes, scale, lut, out, M, K, N,
                                       lut_size, tile_m, tile_n, warps,
                                       stream);
  } else if (path == kPathSkinny) {
    if (M <= 1) err = REPRO_SKINNY(1);
    else if (M <= 2) err = REPRO_SKINNY(2);
    else if (M <= 4) err = REPRO_SKINNY(4);
    else if (M <= kSkinnyMaxM) err = REPRO_SKINNY(8);
  } else if (path == kPathMma && M > kSkinnyMaxM) {
    err = launch_mma(x, codes, scale, lut, out, M, K, N, packed, lut_size,
                     splits, stream);
  }
#undef REPRO_SKINNY
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
