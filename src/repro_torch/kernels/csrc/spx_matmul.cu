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
//  * One block per (BM x BN) output tile with the K loop inside the block,
//    in place of the TPU's sequential K grid axis and VMEM accumulator.
//    The accumulator lives in registers (TM x TN per thread).
//  * The LUT (<= 256 f32) goes to shared memory once per block. Each K step
//    loads the code tile, unpacks the nibbles and decodes through the LUT
//    into a shared f32 tile, so the codes cross device memory once, as
//    codes, and are never expanded in device memory.
//  * Two tile shapes: a skinny one (BM = 8) for decode, where every row of
//    a wide tile would be padding, and a square one for prefill.
//  * Decode has too few output tiles to fill 132 SMs, so the K range is
//    split over blockIdx.z (split-K). Each split writes an unscaled partial
//    sum; a second kernel adds the partials in a fixed order and applies
//    the scale, so the result does not depend on scheduling.
//  * The kernel masks the M, N and K edges itself: every shape runs here.
#include <cuda_runtime.h>
#include <stdint.h>

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

// Tile shapes: (BM, BN, BK, TM, TN), 256 threads each.
struct Skinny { static constexpr int BM = 8, BN = 128, BK = 32, TM = 1, TN = 4; };
struct Square { static constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4; };
constexpr int kSkinnyMaxM = 8;
constexpr int kThreads = 256;

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <class T>
int splits_for(int M, int K, int N, int sms) {
  const int blocks = ceil_div(N, T::BN) * ceil_div(M, T::BM);
  const int want = ceil_div(4 * sms, blocks);        // about four waves
  const int most = ceil_div(K, 4 * T::BK);           // >= 4 K steps each
  const int s = want < most ? want : most;
  return s < 1 ? 1 : s;
}

template <class T>
int k_per_split(int K, int splits) {
  return ceil_div(ceil_div(K, splits), T::BK) * T::BK;
}

template <class T>
cudaError_t launch(const float* x, const uint8_t* codes, const float* scale,
                   const float* lut, float* out, float* partial, int M, int K,
                   int N, int packed, int lut_size, int splits,
                   cudaStream_t stream) {
  const int kps = k_per_split<T>(K, splits);
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

// Split count the launch will use; the caller sizes the partial buffer as
// splits * M * N floats (unused when it returns 1).
int spx_matmul_splits(int M, int K, int N, int sms) {
  return M <= kSkinnyMaxM ? splits_for<Skinny>(M, K, N, sms)
                          : splits_for<Square>(M, K, N, sms);
}

// x (M, K) f32, codes (K, N/2) packed or (K, N) uint8, scale (N,) f32,
// lut (lut_size,) f32, out (M, N) f32; all contiguous, on the device.
// Returns cudaGetLastError() after the launch.
int spx_matmul_f32(const float* x, const uint8_t* codes, const float* scale,
                   const float* lut, float* out, float* partial, int M, int K,
                   int N, int packed, int lut_size, int splits,
                   cudaStream_t stream) {
  const cudaError_t err =
      M <= kSkinnyMaxM
          ? launch<Skinny>(x, codes, scale, lut, out, partial, M, K, N,
                           packed, lut_size, splits, stream)
          : launch<Square>(x, codes, scale, lut, out, partial, M, K, N,
                           packed, lut_size, splits, stream);
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
