// Ragged decode-window attention over a paged KV cache, for Hopper (sm_90a),
// over f32 pages or over SPx-quantized (uint8 codes + f32 scale) pages.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_ragged_pallas
// and ::paged_decode_ragged_quant_pallas (TPU), and, through the w = 1
// mapping in kernels/paged_attention.py, ::paged_attention_pallas and
// ::paged_attention_quant_pallas.
//
// q (B, Hkv, R, dh), R = rep * w rows in rep-major order: row r*w + i is
// window position i of the r-th query head that shares KV head h. Row
// r*w + i attends cache positions <= ctx_len[b] + i; rows with
// i >= q_len[b] are exact zeros. Online softmax over the pages with a -1e30
// mask, masked probabilities forced to 0, a 1e-30 clamp on the
// denominator, and scores scaled by 1/sqrt(dh). block_table (B, max_pages)
// int32. Pools are (n_pages, Hkv, page_size, dh): f32, or uint8 codebook
// codes beside (n_pages, Hkv, page_size, 1) f32 per-token scales and a
// LUT of <= 256 f32 levels. For code pages k = lut[code] * k_scale and
// v = lut[code] * v_scale; the scales fold out of the dh sums, as the
// reference folds them: k_scale multiplies each score after the dot
// product, v_scale each probability before P @ V.
//
// Bound on the H100: each (slot, KV head) must read its ctx + q_len
// cached tokens of K and V once (2 * dh * 4 bytes per token in f32,
// 2 * (dh + 4) in codes + scale) and does 4 * R * dh flops per token; at
// R <= 64 that is under 16 flops per byte, so the kernel is bound by the
// bytes it reads (3.35 TB/s), and at serving batch sizes by the latency of
// the page loop.
//
// Design:
//  * One block per (slot, KV head). The block reads its own block-table
//    row, ctx_len and q_len (in place of the TPU's scalar prefetch) and
//    stages its R query rows in shared memory once.
//  * The page loop runs while j * page_size < ctx + q_len, so a slot reads
//    only its own pages and an inactive slot (ctx = q_len = 0) none. Each
//    step copies the K and V page of this head (contiguous page_size * dh
//    elements each) into shared memory with 16-byte loads; every query row
//    of the block then reuses them, which is the GQA saving.
//  * Code pages stay codes in shared memory (1 byte each, 16 per load:
//    dh is a multiple of 16, so every page row is 16-byte aligned); the
//    block keeps the LUT in shared memory for its whole life and decodes
//    lut[code] where a score or a P @ V term consumes it. The page's
//    scales (page_size floats, the pool's trailing dim of 1) are staged
//    beside the codes.
//  * Scores: one warp per (row, position) pair, lanes split dh and reduce
//    with shuffles. Per-row (m, l) statistics and the f32 accumulator
//    (R x dh) live in shared memory and are rescaled once per page.
//  * dh is a template parameter (32, 64, 128, 256); others are refused.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kLutMax = 256;

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

// How a page's K or V reaches shared memory and how one element is read
// back. F32 pages are copied as they are; code pages stay codes and are
// decoded through the block's LUT.
struct F32Page {
  using T = float;
  __device__ __forceinline__ static float value(const float* page, int e,
                                                const float*) {
    return page[e];
  }
};

struct CodePage {
  using T = uint8_t;
  __device__ __forceinline__ static float value(const uint8_t* page, int e,
                                                const float* lut) {
    return lut[page[e]];
  }
};

template <int DH, class Page>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const typename Page::T* __restrict__ kp,
                    const typename Page::T* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const float* __restrict__ lut, int lut_size,
                    const int* __restrict__ block_table,
                    const int* __restrict__ ctx_len,
                    const int* __restrict__ q_len, float* __restrict__ out,
                    int hkv, int rows, int w, int page_size, int max_pages,
                    float scale) {
  using T = typename Page::T;
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                      // rows * DH
  float* s_acc = s_q + rows * DH;         // rows * DH
  float* s_p = s_acc + rows * DH;         // rows * page_size
  float* s_m = s_p + rows * page_size;    // rows: running max
  float* s_l = s_m + rows;                // rows: running denominator
  float* s_c = s_l + rows;                // rows: this page's rescale
  float* s_lut = s_c + rows;              // kLutMax (code pages only)
  float* s_ks = s_lut + (kQuant ? kLutMax : 0);        // page_size
  float* s_vs = s_ks + (kQuant ? page_size : 0);       // page_size
  // K/V page tiles after the floats, 16-byte aligned
  size_t fl = (size_t)(s_vs + (kQuant ? page_size : 0) - smem);
  fl = (fl + 3) & ~(size_t)3;
  T* s_k = reinterpret_cast<T*>(smem + fl);            // page_size * DH
  T* s_v = s_k + page_size * DH;                       // page_size * DH

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
  if (kQuant)
    for (int i = tid; i < kLutMax; i += kThreads)
      s_lut[i] = i < lut_size ? lut[i] : 0.f;
  const int attend = ctx + qn;
  int n_pages = attend > 0 ? (attend + page_size - 1) / page_size : 0;
  n_pages = n_pages < max_pages ? n_pages : max_pages;
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const int page = block_table[(size_t)b * max_pages + j];
    const size_t tok0 = ((size_t)page * hkv + h) * page_size;
    // 16-byte copies: 4 floats or 16 codes each
    const uint4* k16 = reinterpret_cast<const uint4*>(kp + tok0 * DH);
    const uint4* v16 = reinterpret_cast<const uint4*>(vp + tok0 * DH);
    uint4* sk16 = reinterpret_cast<uint4*>(s_k);
    uint4* sv16 = reinterpret_cast<uint4*>(s_v);
    const int n16 = page_size * DH * (int)sizeof(T) / 16;
    for (int e = tid; e < n16; e += kThreads) {
      sk16[e] = k16[e];
      sv16[e] = v16[e];
    }
    if (kQuant)
      for (int p = tid; p < page_size; p += kThreads) {
        s_ks[p] = k_scale[tok0 + p];
        s_vs[p] = v_scale[tok0 + p];
      }
    __syncthreads();

    // masked, scaled scores of every (row, position) pair of this page
    for (int idx = warp; idx < rows * page_size; idx += kWarps) {
      const int r = idx / page_size, p = idx - r * page_size;
      const float* qr = s_q + r * DH;
      const T* kr = s_k + p * DH;
      float dot = 0.f;
#pragma unroll
      for (int d = lane; d < DH; d += 32)
        dot = fmaf(qr[d], Page::value(kr, d, s_lut), dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        const int win = r % w, pos = j * page_size + p;
        const bool ok = pos <= ctx + win && win < qn;
        float s = dot * scale;
        if (kQuant) s *= s_ks[p];
        s_p[idx] = ok ? s : kNegInf;
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

    // acc = acc * corr + (P [* v_scale]) @ V
    for (int e = tid; e < rows * DH; e += kThreads) {
      const int r = e / DH, d = e - r * DH;
      const float* pr = s_p + r * page_size;
      float a = s_acc[e] * s_c[r];
      for (int p = 0; p < page_size; ++p) {
        const float pv = kQuant ? pr[p] * s_vs[p] : pr[p];
        a = fmaf(pv, Page::value(s_v, p * DH + d, s_lut), a);
      }
      s_acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * DH; e += kThreads)
    out[qoff + e] = s_acc[e] / fmaxf(s_l[e / DH], 1e-30f);
}

size_t smem_bytes(int rows, int dh, int page_size, bool quant) {
  size_t floats = (size_t)2 * rows * dh + (size_t)rows * page_size +
                  3 * (size_t)rows;
  if (quant) floats += kLutMax + 2 * (size_t)page_size;
  floats = (floats + 3) & ~(size_t)3;
  const size_t elem = quant ? 1 : sizeof(float);
  return sizeof(float) * floats + 2 * elem * (size_t)page_size * dh;
}

template <int DH, class Page>
cudaError_t launch(const float* q, const typename Page::T* kp,
                   const typename Page::T* vp, const float* ks,
                   const float* vs, const float* lut, int lut_size,
                   const int* bt, const int* ctx, const int* qn, float* out,
                   int B, int hkv, int rows, int w, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows, DH, page_size, sizeof(*kp) == 1);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<DH, Page>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, hkv);
  paged_decode_kernel<DH, Page><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, ks, vs, lut, lut_size, bt, ctx, qn, out, hkv, rows, w,
      page_size, max_pages, scale);
  return cudaGetLastError();
}

template <class Page>
int dispatch(const float* q, const typename Page::T* kp,
             const typename Page::T* vp, const float* ks, const float* vs,
             const float* lut, int lut_size, const int* bt, const int* ctx,
             const int* qn, float* out, int B, int hkv, int rows, int dh,
             int w, int page_size, int max_pages, float scale,
             cudaStream_t stream) {
  cudaError_t err;
  switch (dh) {
    case 32: err = launch<32, Page>(q, kp, vp, ks, vs, lut, lut_size, bt, ctx,
                                    qn, out, B, hkv, rows, w, page_size,
                                    max_pages, scale, stream); break;
    case 64: err = launch<64, Page>(q, kp, vp, ks, vs, lut, lut_size, bt, ctx,
                                    qn, out, B, hkv, rows, w, page_size,
                                    max_pages, scale, stream); break;
    case 128: err = launch<128, Page>(q, kp, vp, ks, vs, lut, lut_size, bt,
                                      ctx, qn, out, B, hkv, rows, w,
                                      page_size, max_pages, scale, stream);
      break;
    case 256: err = launch<256, Page>(q, kp, vp, ks, vs, lut, lut_size, bt,
                                      ctx, qn, out, B, hkv, rows, w,
                                      page_size, max_pages, scale, stream);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes: f32 pages, or code
// pages (quant != 0).
size_t paged_decode_smem_bytes(int rows, int dh, int page_size, int quant) {
  return smem_bytes(rows, dh, page_size, quant != 0);
}

// Each returns cudaGetLastError() after the launch; cudaErrorInvalidValue
// for a head_dim the kernel is not built for.
int paged_decode_ragged_f32(const float* q, const float* kp, const float* vp,
                            const int* block_table, const int* ctx_len,
                            const int* q_len, float* out, int B, int hkv,
                            int rows, int dh, int w, int page_size,
                            int max_pages, float scale, cudaStream_t stream) {
  return dispatch<F32Page>(q, kp, vp, nullptr, nullptr, nullptr, 0,
                           block_table, ctx_len, q_len, out, B, hkv, rows, dh,
                           w, page_size, max_pages, scale, stream);
}

int paged_decode_ragged_quant_f32(const float* q, const uint8_t* k_codes,
                                  const float* k_scale,
                                  const uint8_t* v_codes,
                                  const float* v_scale, const float* lut,
                                  int lut_size, const int* block_table,
                                  const int* ctx_len, const int* q_len,
                                  float* out, int B, int hkv, int rows,
                                  int dh, int w, int page_size, int max_pages,
                                  float scale, cudaStream_t stream) {
  return dispatch<CodePage>(q, k_codes, v_codes, k_scale, v_scale, lut,
                            lut_size, block_table, ctx_len, q_len, out, B,
                            hkv, rows, dh, w, page_size, max_pages, scale,
                            stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
