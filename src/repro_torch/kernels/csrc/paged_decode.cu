// Ragged decode-window attention over a paged KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_ragged_pallas
// (TPU), and, through the w = 1 mapping in kernels/paged_attention.py,
// paged_attention.py::paged_attention_pallas.
//
// q (B, Hkv, R, dh), R = rep * w rows in rep-major order: row r*w + i is
// window position i of the r-th query head that shares KV head h. Row
// r*w + i attends cache positions <= ctx_len[b] + i; rows with
// i >= q_len[b] are exact zeros. Online softmax over the pages with a -1e30
// mask, masked probabilities forced to 0, a 1e-30 clamp on the
// denominator, and scores scaled by 1/sqrt(dh). K/V pools are
// (n_pages, Hkv, page_size, dh) f32; block_table (B, max_pages) int32.
//
// Bound on the H100: each (slot, KV head) must read its ctx + q_len
// cached tokens of K and V once (2 * dh * 4 bytes per token) and does
// 4 * R * dh flops per token; at R <= 64 that is under 8 flops per byte,
// so the kernel is bound by the bytes it reads (3.35 TB/s), and at
// serving batch sizes by the latency of the page loop.
//
// Design:
//  * One block per (slot, KV head). The block reads its own block-table
//    row, ctx_len and q_len (in place of the TPU's scalar prefetch) and
//    stages its R query rows in shared memory once.
//  * The page loop runs while j * page_size < ctx + q_len, so a slot reads
//    only its own pages and an inactive slot (ctx = q_len = 0) none. Each
//    step copies the K and V page of this head (contiguous page_size * dh
//    floats each) into shared memory with 16-byte loads; every query row
//    of the block then reuses them, which is the GQA saving.
//  * Scores: one warp per (row, position) pair, lanes split dh and reduce
//    with shuffles. Per-row (m, l) statistics and the f32 accumulator
//    (R x dh) live in shared memory and are rescaled once per page.
//  * dh is a template parameter (32, 64, 128, 256); others are refused.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                    const float* __restrict__ vp,
                    const int* __restrict__ block_table,
                    const int* __restrict__ ctx_len,
                    const int* __restrict__ q_len, float* __restrict__ out,
                    int hkv, int rows, int w, int page_size, int max_pages,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                      // rows * DH
  float* s_acc = s_q + rows * DH;         // rows * DH
  float* s_k = s_acc + rows * DH;         // page_size * DH
  float* s_v = s_k + page_size * DH;      // page_size * DH
  float* s_p = s_v + page_size * DH;      // rows * page_size
  float* s_m = s_p + rows * page_size;    // rows: running max
  float* s_l = s_m + rows;                // rows: running denominator
  float* s_c = s_l + rows;                // rows: this page's rescale

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int ctx = ctx_len[b], qn = q_len[b];
  const size_t qoff = ((size_t)b * hkv + h) * rows * DH;

  for (int e = tid; e < rows * DH; e += kThreads) {
    s_q[e] = q[qoff + e];
    s_acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }
  const int attend = ctx + qn;
  int n_pages = attend > 0 ? (attend + page_size - 1) / page_size : 0;
  n_pages = n_pages < max_pages ? n_pages : max_pages;
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const int page = block_table[(size_t)b * max_pages + j];
    const size_t poff = ((size_t)page * hkv + h) * page_size * DH;
    const float4* k4 = reinterpret_cast<const float4*>(kp + poff);
    const float4* v4 = reinterpret_cast<const float4*>(vp + poff);
    float4* sk4 = reinterpret_cast<float4*>(s_k);
    float4* sv4 = reinterpret_cast<float4*>(s_v);
    for (int e = tid; e < page_size * DH / 4; e += kThreads) {
      sk4[e] = k4[e];
      sv4[e] = v4[e];
    }
    __syncthreads();

    // masked, scaled scores of every (row, position) pair of this page
    for (int idx = warp; idx < rows * page_size; idx += kWarps) {
      const int r = idx / page_size, p = idx - r * page_size;
      const float* qr = s_q + r * DH;
      const float* kr = s_k + p * DH;
      float dot = 0.f;
#pragma unroll
      for (int d = lane; d < DH; d += 32) dot = fmaf(qr[d], kr[d], dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        const int win = r % w, pos = j * page_size + p;
        const bool ok = pos <= ctx + win && win < qn;
        s_p[idx] = ok ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics, one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const int win = r % w;
      float* pr = s_p + r * page_size;
      float mx = kNegInf;
      for (int p = lane; p < page_size; p += 32) mx = fmaxf(mx, pr[p]);
      mx = warp_max(mx);
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < page_size; p += 32) {
        const int pos = j * page_size + p;
        const bool ok = pos <= ctx + win && win < qn;
        const float e = ok ? expf(pr[p] - m_new) : 0.f;
        pr[p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_c[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V
    for (int e = tid; e < rows * DH; e += kThreads) {
      const int r = e / DH, d = e - r * DH;
      const float* pr = s_p + r * page_size;
      float a = s_acc[e] * s_c[r];
      for (int p = 0; p < page_size; ++p) a = fmaf(pr[p], s_v[p * DH + d], a);
      s_acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * DH; e += kThreads)
    out[qoff + e] = s_acc[e] / fmaxf(s_l[e / DH], 1e-30f);
}

template <int DH>
cudaError_t launch(const float* q, const float* kp, const float* vp,
                   const int* bt, const int* ctx, const int* qn, float* out,
                   int B, int hkv, int rows, int w, int page_size,
                   int max_pages, float scale, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, hkv);
  paged_decode_kernel<DH><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, bt, ctx, qn, out, hkv, rows, w, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t paged_decode_smem_bytes(int rows, int dh, int page_size) {
  return sizeof(float) * ((size_t)2 * rows * dh + (size_t)2 * page_size * dh +
                          (size_t)rows * page_size + 3 * (size_t)rows);
}

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// head_dim the kernel is not built for.
int paged_decode_ragged_f32(const float* q, const float* kp, const float* vp,
                            const int* block_table, const int* ctx_len,
                            const int* q_len, float* out, int B, int hkv,
                            int rows, int dh, int w, int page_size,
                            int max_pages, float scale, cudaStream_t stream) {
  const size_t smem = paged_decode_smem_bytes(rows, dh, page_size);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch<32>(q, kp, vp, block_table, ctx_len, q_len, out, B,
                              hkv, rows, w, page_size, max_pages, scale, smem,
                              stream); break;
    case 64: err = launch<64>(q, kp, vp, block_table, ctx_len, q_len, out, B,
                              hkv, rows, w, page_size, max_pages, scale, smem,
                              stream); break;
    case 128: err = launch<128>(q, kp, vp, block_table, ctx_len, q_len, out,
                                B, hkv, rows, w, page_size, max_pages, scale,
                                smem, stream); break;
    case 256: err = launch<256>(q, kp, vp, block_table, ctx_len, q_len, out,
                                B, hkv, rows, w, page_size, max_pages, scale,
                                smem, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
