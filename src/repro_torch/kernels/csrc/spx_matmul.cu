// SPx-quantized matmul for Hopper (sm_90a): out = x @ (lut[codes] * scale).
//
// Replaces: src/repro/kernels/spx_matmul.py::spx_matmul_pallas (TPU).
//
// Computes x (M, K) f32 @ W (K, N), where W[k, n] = lut[code(k, n)] *
// scale[n]. Codes are uint8, either one per weight or two 4-bit codes per
// byte with the low nibble holding the even column. The sum over K is f32
// fused multiply-add on the CUDA cores (no TF32: the serving path's
// activations are f32 and the reference contracts them at full precision),
// and the per-column scale is applied once, after the sum.
//
// Bound on the H100: at the decode shapes (M = one row per batch slot) the
// kernel must read every code once — K*N/2 bytes for packed 4-bit codes —
// and does 2*M*K*N flops, far below the 67 TFLOP/s f32 rate, so it is
// bound by the bytes it reads (3.35 TB/s). At the prefill shapes (M in
// the hundreds) the f32 flops bound it.
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
//  * Prefill (M > 8), spx_matmul_kernel: one block per (64 x 64) output
//    tile with the K loop inside the block, in place of the TPU's
//    sequential K grid axis and VMEM accumulator. Each K step loads the
//    code tile, unpacks the nibbles and decodes through the LUT into a
//    shared f32 tile, so the codes cross device memory once, as codes.
//    When the tiles cannot fill 132 SMs, K is split over blockIdx.z and
//    split_k_reduce adds the partials in a fixed order and scales.
//  * Both kernels mask the M, N and K edges themselves: every shape runs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLutMax = 256;

template <int BM, int BN, int BK, int TM, int TN, bool PACKED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
spx_matmul_kernel(const float* __restrict__ x,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  const float* __restrict__ lut, float* __restrict__ out,
                  int M, int K, int N, int lut_size, int k_per_split) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int TY = BM / TM;  // threads along M
  constexpr int NT = TX * TY;
  __shared__ float s_lut[kLutMax];
  __shared__ float s_x[BK][BM + 1];  // x tile, K-major; +1 spreads banks
  __shared__ __align__(16) float s_w[BK][BN];  // decoded weight tile

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  for (int i = tid; i < kLutMax; i += NT)
    s_lut[i] = i < lut_size ? lut[i] : 0.f;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile: consecutive threads walk K, so the global reads coalesce
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      s_x[kk][mm] = (gm < M && gk < k_end) ? x[(size_t)gm * K + gk] : 0.f;
    }
    if (PACKED) {
      constexpr int BNB = BN / 2;  // code bytes per tile row
      const int nb = N / 2;
      for (int i = tid; i < BK * BNB; i += NT) {
        const int kk = i / BNB, jb = i % BNB;
        const int gk = k0 + kk, gb = n0 / 2 + jb;
        float2 wv = make_float2(0.f, 0.f);
        if (gk < k_end && gb < nb) {
          const uint8_t c = codes[(size_t)gk * nb + gb];
          wv = make_float2(s_lut[c & 0xF], s_lut[c >> 4]);  // low = even
        }
        *reinterpret_cast<float2*>(&s_w[kk][2 * jb]) = wv;
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, j = i % BN;
        const int gk = k0 + kk, gn = n0 + j;
        s_w[kk][j] = (gk < k_end && gn < N)
                         ? s_lut[codes[(size_t)gk * N + gn]] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s_x[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s_w[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // one split: scaled result; several: unscaled partial for the reduce
  const bool final_pass = gridDim.z == 1;
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gm < M && gn < N)
        dst[(size_t)gm * N + gn] = final_pass ? acc[i][j] * scale[gn]
                                              : acc[i][j];
    }
  }
}

__global__ void split_k_reduce(const float* __restrict__ partial,
                               const float* __restrict__ scale,
                               float* __restrict__ out, int M, int N,
                               int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < mn;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + idx];
    out[idx] = s * scale[idx % N];
  }
}

// The prefill tile: (BM, BN, BK, TM, TN), 256 threads.
struct Square { static constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4; };
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

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

int square_splits(int M, int K, int N, int sms) {
  const int blocks = ceil_div(N, Square::BN) * ceil_div(M, Square::BM);
  const int want = ceil_div(4 * sms, blocks);        // about four waves
  const int most = ceil_div(K, 4 * Square::BK);      // >= 4 K steps each
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}

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

cudaError_t launch_square(const float* x, const uint8_t* codes,
                          const float* scale, const float* lut, float* out,
                          float* partial, int M, int K, int N, int packed,
                          int lut_size, int splits, cudaStream_t stream) {
  using T = Square;
  const int kps = ceil_div(ceil_div(K, splits), T::BK) * T::BK;
  const int z = ceil_div(K, kps);
  dim3 grid(ceil_div(N, T::BN), ceil_div(M, T::BM), z);
  float* dst = z == 1 ? out : partial;
  if (packed)
    spx_matmul_kernel<T::BM, T::BN, T::BK, T::TM, T::TN, true>
        <<<grid, kThreads, 0, stream>>>(x, codes, scale, lut, dst, M, K, N,
                                        lut_size, kps);
  else
    spx_matmul_kernel<T::BM, T::BN, T::BK, T::TM, T::TN, false>
        <<<grid, kThreads, 0, stream>>>(x, codes, scale, lut, dst, M, K, N,
                                        lut_size, kps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || z == 1) return err;
  const size_t mn = (size_t)M * N;
  const int rblocks = (int)((mn + kThreads - 1) / kThreads);
  split_k_reduce<<<rblocks < 4096 ? rblocks : 4096, kThreads, 0, stream>>>(
      partial, scale, out, M, N, z);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Split count the launch will use: for M <= 8 the blocks of a cluster
// along K (no partial buffer), else the square tile's K splits; the
// caller then sizes the partial buffer as splits * M * N floats (unused
// when it returns 1).
int spx_matmul_splits(int M, int K, int N, int sms) {
  return M <= kSkinnyMaxM ? skinny_splits(K, N, sms)
                          : square_splits(M, K, N, sms);
}

// x (M, K) f32, codes (K, N/2) packed or (K, N) uint8, scale (N,) f32,
// lut (lut_size,) f32, out (M, N) f32; all contiguous, on the device.
// Returns cudaGetLastError() after the launch.
int spx_matmul_f32(const float* x, const uint8_t* codes, const float* scale,
                   const float* lut, float* out, float* partial, int M, int K,
                   int N, int packed, int lut_size, int splits,
                   cudaStream_t stream) {
  cudaError_t err;
#define REPRO_SKINNY(MT)                                                    \
  launch_skinny<MT>(x, codes, scale, lut, out, M, K, N, packed, lut_size,   \
                    splits, stream)
  if (M <= 1) err = REPRO_SKINNY(1);
  else if (M <= 2) err = REPRO_SKINNY(2);
  else if (M <= 4) err = REPRO_SKINNY(4);
  else if (M <= kSkinnyMaxM) err = REPRO_SKINNY(8);
  else err = launch_square(x, codes, scale, lut, out, partial, M, K, N,
                           packed, lut_size, splits, stream);
#undef REPRO_SKINNY
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
