// Ragged decode-window attention over a paged KV cache, for Hopper (sm_90a),
// over f32 pages, bf16 pages, f16 pages or SPx-quantized (uint8 codes +
// f32 scale) pages.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_ragged_pallas
// and ::paged_decode_ragged_quant_pallas (TPU), and, through the in-kernel
// single-token mode, ::paged_attention_pallas and
// ::paged_attention_quant_pallas.
//
// q (B, Hkv, R, dh), R = rep * w rows in rep-major order: row r*w + i is
// window position i of the r-th query head that shares KV head h. Row
// r*w + i attends cache positions <= ctx_len[b] + i; rows with
// i >= q_len[b] are exact zeros. Online softmax with a -1e30 mask, masked
// probabilities forced to 0, a 1e-30 clamp on the denominator, and scores
// scaled by 1/sqrt(dh). block_table (B, max_pages) int32. Pools are
// (n_pages, Hkv, page_size, dh): f32, bf16, f16, or uint8 codebook codes
// beside (n_pages, Hkv, page_size, 1) f32 per-token scales and a LUT of
// <= 256 f32 levels. For code pages k = lut[code] * k_scale and
// v = lut[code] * v_scale; the scales fold out of the dh sums, as the reference folds them:
// k_scale multiplies each score after the dot product, v_scale each
// probability before P @ V. In single-token mode (w = 1) the kernel reads
// ctx_len as "positions < ctx_len attended": ctx = max(ctx_len - 1, 0) and
// q_len = (ctx_len > 0), so the caller runs no op before the launch.
// bf16 pages compute what the TPU kernel computes for them: q stays f32,
// K and V widen to f32, and each probability is rounded to bf16 before
// P @ V (``pv.astype(v.dtype)``), while the denominator sums the f32
// probabilities. f16 pages do the same with f16: each probability is
// rounded to nearest even (``__float2half_rn``, subnormals kept, as
// ``Tensor.to(torch.float16)`` rounds), since the probabilities of far-off
// tokens fall below f16's normal range (6.1e-5) and flushing them to zero
// would depart from the reference. f16 * f16 products are exact in f32.
//
// Bound on the H100: each (slot, KV head) must read its ctx + q_len cached
// tokens of K and V once (2 * dh * 4 bytes per token in f32, 2 * dh * 2 in
// bf16, 2 * (dh + 4) in codes + scale) and does 4 * R * dh flops per
// token; at R <= 64 that is under 16 flops per byte (32 on bf16 pages), so
// the kernel is bound by the bytes it reads (3.35 TB/s). At serving batch
// sizes a launch reads a few hundred KB, so what it costs is latency: how
// many dependent memory round trips and barriers lie on its longest path.
// bf16 pages halve the bytes but not the instructions per token (the
// same FMAs and shuffles, plus the widening), so they shorten a launch
// only where the bytes, not that path, set its time.
//
// Design (flash-decoding):
//  * Grid (B, Hkv * row groups, splits). A row group is 8 query rows; a
//    split is a run of split_tokens positions (a multiple of 16) of the
//    slot's block table. The wrapper picks the split count from the
//    table width (the longest context the launch can see), the SM count
//    and a floor of tokens per split. The query rows and the first page
//    ids are loaded before the slot's lengths arrive, and each group
//    loads the next group's page ids. A block whose split starts past
//    its slot's context ends at once; the merge reads only the splits
//    that start inside it.
//  * Inside a block, warps own tokens, not (row, token) pairs: warp j
//    takes the 4-token groups j, j + 4, ... of the split, each with its own
//    online-softmax state. A lane holds dh/32 consecutive elements of the
//    8 query rows in registers and loads the same slice of the group's
//    4 K rows and 4 V rows straight into registers (16-byte loads for f32
//    at dh >= 128, 8 for codes at dh 256): all 8 loads of a group are in
//    flight at once, coalesced across the warp (bf16 rows: 16-byte loads
//    at dh 256, 8 at 128, 4 at 64, 2 at 32), and no page is staged in
//    shared memory, so there is no block-wide barrier in the token loop.
//  * Scores: each lane has 8 x 4 partial dot products; one transposed
//    butterfly (16 + 8 + 4 + 2 + 1 shuffles) leaves lane L with the full
//    score of pair L = row * 4 + token. Row statistics then take two
//    shuffles, and P @ V broadcasts each probability with one shuffle.
//  * Code pages: each code is loaded by one lane and decoded once through
//    the block's shared-memory LUT (one LUT read per element), then used
//    by all 8 rows from registers.
//  * The warps merge their (m, l, acc) once, in shared memory, in warp
//    order. With one split the block writes the output; with several it
//    writes its partial (m, l, unnormalised acc) to scratch, and
//    paged_decode_merge_kernel (one block per output row and 32 columns)
//    combines the splits that start inside the slot's context in a fixed
//    order, so the result does not depend on scheduling.
//  * All shared memory is static (at most 33 KB), so no launch sets an
//    attribute. dh is a template parameter (32, 64, 128, 256); others are
//    refused.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;        // query rows per block (one row group)
constexpr int kTok = 4;         // tokens per warp step; kRows * kTok = 32
constexpr int kSplitGranule = kWarps * kTok;  // tokens; splits are multiples
constexpr int kLutMax = 256;
constexpr int kMergeThreads = 256;
constexpr int kMaxSplits = 1024;
constexpr unsigned kFull = 0xffffffffu;

template <int E>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (E == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// How a lane loads its dh/32 elements of one page row, and how the raw
// load becomes floats. F32 rows are the floats; bf16 and f16 rows are E
// halves of 32-bit words, widened exactly; code rows are E bytes, decoded
// through the block's LUT. ``round_p`` is what P @ V multiplies V by: the
// f32 probability, or for bf16 (f16) pages that probability rounded to
// bf16 (f16).
struct F32Page {
  using T = float;
  __device__ __forceinline__ static float round_p(float p) { return p; }
  template <int E> struct Raw { float v[E]; };
  template <int E>
  __device__ __forceinline__ static Raw<E> load(const float* p) {
    Raw<E> r;
    load_f32<E>(p, r.v);
    return r;
  }
  template <int E>
  __device__ __forceinline__ static Raw<E> zero() {
    Raw<E> r;
#pragma unroll
    for (int e = 0; e < E; ++e) r.v[e] = 0.f;
    return r;
  }
  template <int E>
  __device__ __forceinline__ static void decode(const Raw<E>& r,
                                                float (&v)[E],
                                                const float*) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = r.v[e];
  }
};

struct Bf16Page {
  using T = uint16_t;           // bf16 bits
  __device__ __forceinline__ static float round_p(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  template <int E> struct Raw { uint32_t w[(E + 1) / 2]; };
  template <int E>
  __device__ __forceinline__ static Raw<E> load(const uint16_t* p) {
    Raw<E> r;
    if constexpr (E == 8) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      r.w[0] = t.x;
      r.w[1] = t.y;
      r.w[2] = t.z;
      r.w[3] = t.w;
    } else if constexpr (E == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      r.w[0] = t.x;
      r.w[1] = t.y;
    } else if constexpr (E == 2) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    return r;
  }
  template <int E>
  __device__ __forceinline__ static Raw<E> zero() {
    Raw<E> r;
#pragma unroll
    for (int i = 0; i < (E + 1) / 2; ++i) r.w[i] = 0u;
    return r;
  }
  // element e is the low (even e) or high (odd e) half of word e / 2; a
  // bf16 is the top 16 bits of the f32 of the same value
  template <int E>
  __device__ __forceinline__ static void decode(const Raw<E>& r,
                                                float (&v)[E],
                                                const float*) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = __uint_as_float(e % 2 ? r.w[e / 2] & 0xFFFF0000u
                                   : r.w[e / 2] << 16);
  }
};

// f16 pages load as bf16 pages do (16-bit words); they differ in how a
// half widens and in how a probability rounds.
struct F16Page : Bf16Page {
  __device__ __forceinline__ static float round_p(float p) {
    return __half2float(__float2half_rn(p));
  }
  template <int E>
  __device__ __forceinline__ static void decode(const Raw<E>& r,
                                                float (&v)[E],
                                                const float*) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = __half2float(__ushort_as_half(static_cast<unsigned short>(
          e % 2 ? r.w[e / 2] >> 16 : r.w[e / 2] & 0xFFFFu)));
  }
};

struct CodePage {
  using T = uint8_t;
  __device__ __forceinline__ static float round_p(float p) { return p; }
  template <int E> struct Raw { uint32_t w[(E + 3) / 4]; };
  template <int E>
  __device__ __forceinline__ static Raw<E> load(const uint8_t* p) {
    Raw<E> r;
    if constexpr (E == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      r.w[0] = t.x;
      r.w[1] = t.y;
    } else if constexpr (E == 4) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (E == 2) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      r.w[0] = __ldg(p);
    }
    return r;
  }
  template <int E>
  __device__ __forceinline__ static Raw<E> zero() {
    Raw<E> r;
#pragma unroll
    for (int i = 0; i < (E + 3) / 4; ++i) r.w[i] = 0u;
    return r;
  }
  template <int E>
  __device__ __forceinline__ static void decode(const Raw<E>& r,
                                                float (&v)[E],
                                                const float* lut) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = lut[(r.w[e / 4] >> (8 * (e % 4))) & 0xFFu];
  }
};

// Sum 32 values across the warp so that lane L ends with the total of
// value L: at each step a lane keeps the half of its values that its
// partner lane does not, and adds the partner's copy of that half.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

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
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int hkv, int rows, int w,
                    int single, int page_size, int max_pages,
                    int split_tokens, float scale) {
  using T = typename Page::T;
  constexpr int E = DH / 32;
  constexpr bool kQuant = sizeof(T) == 1;
  using Raw = typename Page::template Raw<E>;
  __shared__ float s_lut[kQuant ? kLutMax : 1];
  __shared__ float s_m[kWarps][kRows], s_l[kWarps][kRows];
  __shared__ __align__(16) float s_acc[kWarps][kRows][DH];

  const int b = blockIdx.x;
  const int groups = (rows + kRows - 1) / kRows;
  const int h = blockIdx.y / groups, row0 = (blockIdx.y % groups) * kRows;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const size_t qrow0 = ((size_t)b * hkv + h) * rows;
  const int max_tokens = max_pages * page_size;
  const int t_begin = split * split_tokens;
  const int* bt = block_table + (size_t)b * max_pages;
  // loaded before the slot's lengths arrive: the query rows, the page
  // ids of this warp's first token group and the LUT
  float qr[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (row0 + i < rows) {
      load_f32<E>(q + (qrow0 + row0 + i) * DH + lane * E, qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[i][e] = 0.f;
    }
  }
  int pg[kTok];
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    const int tok = t_begin + warp * kTok + j;
    pg[j] = tok < max_tokens ? __ldg(bt + tok / page_size) : 0;
  }
  if (kQuant)
    for (int i = threadIdx.x; i < kLutMax; i += kThreads)
      s_lut[i] = i < lut_size ? lut[i] : 0.f;

  int ctx, qn;
  if (single) {
    const int c = ctx_len[b];
    ctx = c > 0 ? c - 1 : 0;
    qn = c > 0 ? 1 : 0;
  } else {
    ctx = ctx_len[b];
    qn = q_len[b];
  }
  const int attend = min(ctx + qn, max_tokens);
  const int t_end = min(attend, t_begin + split_tokens);
  // a split past the slot's context: the merge never reads it
  if (gridDim.z > 1 && t_begin >= t_end) return;

  if (kQuant) __syncthreads();      // the LUT is in shared memory

  // this lane's pair of the 8 x 4 score tile: row ri, token ti
  const int ri = lane / kTok, ti = lane % kTok;
  const int my_row = row0 + ri;
  const int my_win = my_row % w;
  const bool my_row_ok = my_row < rows && my_win < qn;
  const int my_limit = ctx + my_win;

  float m_run = kNegInf, l_run = 0.f;
  float acc[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  for (int t0 = t_begin + warp * kTok; t0 < t_end; t0 += kWarps * kTok) {
    // start the group's 4 K row and 4 V row loads (and this lane's token's
    // scales) before any math, then the next group's page ids
    Raw kraw[kTok], vraw[kTok];
    size_t my_off = 0;
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int tok = t0 + j;
      if (tok < t_end) {
        const size_t off =
            ((size_t)pg[j] * hkv + h) * page_size + tok % page_size;
        kraw[j] = Page::template load<E>(kp + off * DH + lane * E);
        vraw[j] = Page::template load<E>(vp + off * DH + lane * E);
        if (j == ti) my_off = off;
      } else {
        kraw[j] = Page::template zero<E>();
        vraw[j] = Page::template zero<E>();
      }
    }
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int tok = t0 + kWarps * kTok + j;
      pg[j] = tok < t_end ? __ldg(bt + tok / page_size) : 0;
    }
    const int my_tok = t0 + ti;
    float my_ks = 1.f, my_vs = 1.f;
    if (kQuant && my_tok < t_end) {
      my_ks = k_scale[my_off];
      my_vs = v_scale[my_off];
    }

    float dots[32];
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      float kf[E];
      Page::template decode<E>(kraw[j], kf, s_lut);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[i][e], kf[e], d);
        dots[i * kTok + j] = d;
      }
    }
    const float dot = transpose_sum(dots, lane);

    const bool ok = my_tok < t_end && my_row_ok && my_tok <= my_limit;
    float s = dot * scale;
    if (kQuant) s *= my_ks;
    s = ok ? s : kNegInf;
    float mx = fmaxf(s, __shfl_xor_sync(kFull, s, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float p = ok ? expf(s - m_new) : 0.f;
    float sum = p + __shfl_xor_sync(kFull, p, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    const float pw = Page::round_p(kQuant ? p * my_vs : p);

    // acc = acc * corr + (P [* v_scale], rounded as the page type says) @ V
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      float vf[E];
      Page::template decode<E>(vraw[j], vf, s_lut);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pij = __shfl_sync(kFull, pw, i * kTok + j);
        if (j == 0) {
          const float c = __shfl_sync(kFull, corr, i * kTok);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] *= c;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pij, vf[e], acc[i][e]);
      }
    }
  }

  // merge the warps in warp order
  if (ti == 0) {
    s_m[warp][ri] = m_run;
    s_l[warp][ri] = l_run;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[warp][i][lane * E + e] = acc[i][e];
  __syncthreads();

  const int splits = gridDim.z;
  const size_t n_rows = (size_t)gridDim.x * hkv * rows;
  for (int idx = threadIdx.x; idx < kRows * DH; idx += kThreads) {
    const int i = idx / DH, d = idx % DH;
    if (row0 + i >= rows) break;
    float m = kNegInf;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) m = fmaxf(m, s_m[j][i]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const float c = expf(s_m[j][i] - m);
      l = fmaf(s_l[j][i], c, l);
      a = fmaf(s_acc[j][i][d], c, a);
    }
    const size_t row = qrow0 + row0 + i;
    if (splits == 1) {
      out[row * DH + d] = a / fmaxf(l, 1e-30f);
    } else {
      part_acc[((size_t)split * n_rows + row) * DH + d] = a;
      if (d == 0) {
        part_ml[((size_t)split * n_rows + row) * 2] = m;
        part_ml[((size_t)split * n_rows + row) * 2 + 1] = l;
      }
    }
  }
}

// One block per (output row, 32 output columns): the row's used splits
// (those that start inside its slot's context) combined with the weights
// c = exp(m - M). Warp g sums every 8th split's c * acc and c * l,
// starting at split g, and warp 0 adds the 8 warps' sums in warp order.
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ ctx_len,
                          const int* __restrict__ q_len,
                          float* __restrict__ out, int rows_per_slot,
                          int dh, int single, int split_tokens,
                          int max_tokens) {
  constexpr int kGroups = kMergeThreads / 32;
  __shared__ float s_m[kMaxSplits];
  __shared__ float s_a[kGroups][32], s_l[kGroups][32];
  const size_t n_rows = gridDim.x;
  const int row = blockIdx.x, b = row / rows_per_slot;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int d = blockIdx.y * 32 + lane;
  int attend;
  if (single) {
    attend = ctx_len[b] > 0 ? ctx_len[b] : 0;
  } else {
    attend = ctx_len[b] + q_len[b];
  }
  attend = min(attend, max_tokens);
  const int used = attend > 0 ? (attend + split_tokens - 1) / split_tokens
                              : 0;
  for (int s = tid; s < used; s += kMergeThreads)
    s_m[s] = part_ml[((size_t)s * n_rows + row) * 2];
  __syncthreads();
  float m = kNegInf;
  for (int s = 0; s < used; ++s) m = fmaxf(m, s_m[s]);
  float a = 0.f, l = 0.f;
#pragma unroll 4
  for (int s = g; s < used; s += kGroups) {
    const float c = expf(s_m[s] - m);
    l = fmaf(part_ml[((size_t)s * n_rows + row) * 2 + 1], c, l);
    a = fmaf(part_acc[((size_t)s * n_rows + row) * dh + d], c, a);
  }
  s_a[g][lane] = a;
  s_l[g][lane] = l;
  __syncthreads();
  if (g == 0) {
    float at = 0.f, lt = 0.f;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      at += s_a[j][lane];
      lt += s_l[j][lane];
    }
    out[(size_t)row * dh + d] = at / fmaxf(lt, 1e-30f);
  }
}

template <int DH, class Page>
cudaError_t launch(const float* q, const typename Page::T* kp,
                   const typename Page::T* vp, const float* ks,
                   const float* vs, const float* lut, int lut_size,
                   const int* bt, const int* ctx, const int* qn, float* out,
                   float* scratch, int B, int hkv, int rows, int w,
                   int single, int page_size, int max_pages, int splits,
                   float scale, cudaStream_t stream) {
  const int groups = (rows + kRows - 1) / kRows;
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const int max_tokens = max_pages * page_size;
  const int per = (max_tokens + splits - 1) / splits;
  const int split_tokens =
      per > 0 ? (per + kSplitGranule - 1) / kSplitGranule * kSplitGranule
              : kSplitGranule;
  splits = max(1, (max_tokens + split_tokens - 1) / split_tokens);
  const int n_rows = B * hkv * rows;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)splits * n_rows * DH;
  dim3 grid(B, hkv * groups, splits);
  paged_decode_kernel<DH, Page><<<grid, kThreads, 0, stream>>>(
      q, kp, vp, ks, vs, lut, lut_size, bt, ctx, qn, out, part_acc, part_ml,
      hkv, rows, w, single, page_size, max_pages, split_tokens, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_decode_merge_kernel<<<dim3(n_rows, DH / 32), kMergeThreads, 0,
                              stream>>>(
      part_acc, part_ml, ctx, qn, out, hkv * rows, DH, single, split_tokens,
      max_tokens);
  return cudaGetLastError();
}

template <class Page>
int dispatch(const float* q, const typename Page::T* kp,
             const typename Page::T* vp, const float* ks, const float* vs,
             const float* lut, int lut_size, const int* bt, const int* ctx,
             const int* qn, float* out, float* scratch, int B, int hkv,
             int rows, int dh, int w, int single, int page_size,
             int max_pages, int splits, float scale, cudaStream_t stream) {
#define REPRO_PAGED_LAUNCH(D)                                               \
  launch<D, Page>(q, kp, vp, ks, vs, lut, lut_size, bt, ctx, qn, out,       \
                  scratch, B, hkv, rows, w, single, page_size, max_pages,   \
                  splits, scale, stream)
  cudaError_t err;
  switch (dh) {
    case 32: err = REPRO_PAGED_LAUNCH(32); break;
    case 64: err = REPRO_PAGED_LAUNCH(64); break;
    case 128: err = REPRO_PAGED_LAUNCH(128); break;
    case 256: err = REPRO_PAGED_LAUNCH(256); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_LAUNCH
  return (int)err;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch(es); cudaErrorInvalidValue
// for a head_dim the kernel is not built for. ``scratch`` holds
// splits * B * Hkv * rows * (dh + 2) floats when splits > 1 (unused at 1).
// ``single`` != 0 selects the single-token mode (q_len is then not read).
int paged_decode_ragged_f32(const float* q, const float* kp, const float* vp,
                            const int* block_table, const int* ctx_len,
                            const int* q_len, float* out, float* scratch,
                            int B, int hkv, int rows, int dh, int w,
                            int single, int page_size, int max_pages,
                            int splits, float scale, cudaStream_t stream) {
  return dispatch<F32Page>(q, kp, vp, nullptr, nullptr, nullptr, 0,
                           block_table, ctx_len, q_len, out, scratch, B, hkv,
                           rows, dh, w, single, page_size, max_pages, splits,
                           scale, stream);
}

// bf16 pools: ``kp``/``vp`` hold bf16 bits; q, out and scratch are f32.
int paged_decode_ragged_bf16(const float* q, const uint16_t* kp,
                             const uint16_t* vp, const int* block_table,
                             const int* ctx_len, const int* q_len, float* out,
                             float* scratch, int B, int hkv, int rows, int dh,
                             int w, int single, int page_size, int max_pages,
                             int splits, float scale, cudaStream_t stream) {
  return dispatch<Bf16Page>(q, kp, vp, nullptr, nullptr, nullptr, 0,
                            block_table, ctx_len, q_len, out, scratch, B,
                            hkv, rows, dh, w, single, page_size, max_pages,
                            splits, scale, stream);
}

// f16 pools: ``kp``/``vp`` hold f16 bits; q, out and scratch are f32.
int paged_decode_ragged_f16(const float* q, const uint16_t* kp,
                            const uint16_t* vp, const int* block_table,
                            const int* ctx_len, const int* q_len, float* out,
                            float* scratch, int B, int hkv, int rows, int dh,
                            int w, int single, int page_size, int max_pages,
                            int splits, float scale, cudaStream_t stream) {
  return dispatch<F16Page>(q, kp, vp, nullptr, nullptr, nullptr, 0,
                           block_table, ctx_len, q_len, out, scratch, B, hkv,
                           rows, dh, w, single, page_size, max_pages, splits,
                           scale, stream);
}

int paged_decode_ragged_quant_f32(const float* q, const uint8_t* k_codes,
                                  const float* k_scale,
                                  const uint8_t* v_codes,
                                  const float* v_scale, const float* lut,
                                  int lut_size, const int* block_table,
                                  const int* ctx_len, const int* q_len,
                                  float* out, float* scratch, int B, int hkv,
                                  int rows, int dh, int w, int single,
                                  int page_size, int max_pages, int splits,
                                  float scale, cudaStream_t stream) {
  return dispatch<CodePage>(q, k_codes, v_codes, k_scale, v_scale, lut,
                            lut_size, block_table, ctx_len, q_len, out,
                            scratch, B, hkv, rows, dh, w, single, page_size,
                            max_pages, splits, scale, stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
