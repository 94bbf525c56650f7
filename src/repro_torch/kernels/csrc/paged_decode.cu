// Ragged decode-window attention over a paged KV cache, for Hopper (sm_90a),
// over f32 pages, bf16 pages, f16 pages or SPx-quantized (uint8 codes +
// f32 scale) pages. Two kernels: paged_decode_kernel (CUDA cores; f32 and
// code pages) and paged_decode_mma_kernel (tensor cores; bf16 and f16
// pages).
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
// bf16 and f16 pages compute what the TPU kernel computes for them: the
// score is the f32 dot of q with the widened K, and each probability is
// rounded to the page's type before P @ V (``pv.astype(v.dtype)``: to
// nearest even, f16 subnormals kept, as ``Tensor.to`` rounds; the
// probabilities of far-off tokens fall below f16's normal range, 6.1e-5,
// and flushing them would depart from the reference), while the
// denominator sums the f32 probabilities.
//
// Bound on the H100: each (slot, KV head) must read its ctx + q_len cached
// tokens of K and V once (2 * dh * 4 bytes per token in f32, 2 * dh * 2 in
// bf16 or f16, 2 * (dh + 4) in codes + scale) and does 4 * R * dh flops
// per token: R flops per byte of f32 pages, 2R of 16-bit pages. The
// CUDA cores give 20 flops per byte at 3.35 TB/s (67 TFLOP/s), the
// tensor cores 295 (989 TFLOP/s), so on the CUDA cores a verify window
// (R = rep * w = 40 for gemma at w = 5) is bound by its arithmetic on
// 16-bit pages, and on the tensor cores every shape the port serves is
// bound by the bytes it reads. At serving batch sizes a launch reads a
// few hundred KB, so what it costs is latency: how many dependent memory
// round trips, barriers and launches lie on its longest path.
//
// paged_decode_kernel (f32 and code pages; flash-decoding):
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
//    flight at once, coalesced across the warp, and no page is staged in
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
//    attribute.
//
// paged_decode_mma_kernel (bf16 and f16 pages; one launch per call):
//  * One thread-block cluster of C blocks (a power of two <= 16, and <=
//    dh / 4, fixed by the shapes: enough blocks for the card, 2 chunks a
//    warp at the table's full width) per (slot, KV head, group of 8 query
//    rows). The slot's live context, read on the device from ctx_len and
//    q_len, is cut into n 16-token chunks, and A ranks of the cluster
//    take them: the fewest (a power of two <= C) that give no warp more
//    than 2. Chunk c goes to warp c mod 4 of rank (c / 4) mod A. A decode
//    tick's few chunks so stay in one block (A = 1: no cluster barrier,
//    the other ranks leave at once), and no block works past the context.
//  * Each warp streams its chunks through its own three shared-memory
//    stages with 16-byte cp.async, the next chunks' K and V rows in flight
//    behind the current chunk's MMAs; the page ids of a chunk are loaded
//    a step before its copies are issued (the first before the slot's
//    lengths arrive), q is cut into planes while the first copies fly,
//    and no block-wide barrier lies in the loop.
//  * Tensor cores, mma.sync.m16n8k16 with f32 accumulation; tokens on
//    the M side, the group's 8 rows as N. S^T = K Q^T: K's 16 x 16 tiles
//    by ldmatrix as A, q's planes as B, in 2 * planes independent sums
//    whose next fragments load ahead of the MMAs. Exact planes of q: on
//    bf16 pages three bf16 planes, q1 = bf16(q), q2 = bf16(q - q1), q3 =
//    bf16(q - q1 - q2), whose sum is q (24 bits in three 8-bit pieces)
//    while the pieces stay normal (|q| above about 2^-100), and a bf16 x
//    bf16 product is exact in f32: the score is the f32 dot up to the
//    order of its sums. On f16 pages two f16 planes of q scaled per row by
//    a power of two 2^e that brings max|q| into [2^14, 2^15): the scale is
//    exact and undone on the f32 score, it keeps the planes inside f16's
//    range (65504), and each element's residual is at most 2^-22 |q_d|
//    plus, where a lower plane falls below f16's normal range, 2^-39
//    max|q|; f16 x f16 products are exact in f32, f16 K (subnormals too)
//    is read as it is. The other choice, K split into bf16 hi + lo (exact,
//    f16's 11 bits in two 8-bit pieces), needs three q planes for six
//    MMAs per tile and a split of every K fragment in registers; q's
//    planes are made once per block.
//  * Online softmax per warp in registers: a thread's score fragment
//    holds two tokens of the same two rows its O^T fragments hold, so a
//    row's max takes three shuffles and its rescale none; the f32
//    probabilities are summed per thread and reduced once at the end.
//    O^T = V^T P^T: V's tiles by ldmatrix.trans as A, and P, rounded to
//    the page's type, as B: its 16-bit accumulator layout becomes the B
//    fragment by two movmatrix.trans. A 16-bit product is exact in f32.
//  * Merge: each warp's (m, l, O) in its own stages, the block's 4 warps
//    in warp order (row weights once). With A = 1 the block writes the
//    output. With A > 1 each rank pushes its (m, l) and each rank's share
//    of the dh columns into that rank's receive area by remote stores
//    (after a barrier half, arrived at the start, tells every block runs),
//    one cluster barrier, and each rank merges its columns over the ranks
//    in rank order from its own shared memory: reruns are bit-identical
//    and no partial crosses device memory.
//  * Shared memory: q's planes, 3 stages x 4 warps of 16 K rows and 16 V
//    rows (rows padded by 16 bytes, so ldmatrix has no bank conflict) and
//    the receive area: 224 KB at dh 256.
//  * What bounds it (tools/kernel_ablation.py on the card): a launch's
//    fixed path (the launch, the block table and lengths, then K/V: two
//    dependent memory round trips; one chunk's MMAs and softmax; the
//    merge and the output's stores) is a few microseconds, against
//    2.5 us of bytes for 4 slots x 2048 tokens of gemma-2b's head.
//    Sharing the rows' maxima and P across the warps each round, so that
//    no O is merged, measured slower: two barriers a round cost more.
//
// dh is a template parameter (32, 64, 128, 256); others are refused.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// load becomes floats. F32 rows are the floats; code rows are E bytes,
// decoded through the block's LUT.
struct F32Page {
  using T = float;
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

struct CodePage {
  using T = uint8_t;
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
    const float pw = kQuant ? p * my_vs : p;

    // acc = acc * corr + (P [* v_scale]) @ V
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

// -- bf16 and f16 pages: tensor cores, one launch ---------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kChunk = 16;         // tokens per MMA tile (the M side)
constexpr int kStages = 3;         // chunks in flight per warp
constexpr int kMaxCluster = 16;    // Hopper's largest cluster
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 16-bit matrices; lanes 8i .. 8i + 7 address matrix i's rows
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// a cluster barrier in two halves: arrive (no memory order) and wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the transpose of an 8 x 8 16-bit matrix held as one fragment
__device__ __forceinline__ uint32_t movm_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// The page type's MMA: how q is cut into planes of that type, how two
// floats pack into a 32-bit pair (rounded to nearest even, low half
// first), and the m16n8k16 product with f32 accumulation.
struct Bf16Mma {
  static constexpr int kPlanes = 3;
  static constexpr bool kRowScale = false;
  __device__ __forceinline__ static uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xFFFF0000u));
  }
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct F16Mma {
  static constexpr int kPlanes = 2;
  static constexpr bool kRowScale = true;
  __device__ __forceinline__ static uint32_t pack(float a, float b) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <int DH, class H>
struct MmaTile {
  static constexpr int kRowB = 2 * DH + 16;          // a padded 16-bit row
  static constexpr int kQBytes = H::kPlanes * kRows * kRowB;
  static constexpr int kStageBytes = 2 * kChunk * kRowB;   // K, then V
  static constexpr int kWarpBytes = kStages * kStageBytes;
  // the receive area of the cluster's merge: per source rank m, l (2 * 8
  // floats) and O of this rank's columns (8 * DH / C floats), C <= kMaxC
  static constexpr int kMaxC = DH / 4 < kMaxCluster ? DH / 4 : kMaxCluster;
  static constexpr int kRecvO = 2 * kRows * kMaxC;           // floats
  static constexpr int kRecvOffset = kQBytes + kMmaWarps * kWarpBytes;
  static constexpr int kSmem = kRecvOffset + 4 * (kRecvO + kRows * DH);
  static constexpr int kOStride = DH + 4;   // floats; no bank conflict,
                                            // 16-byte rows
  static constexpr int kPart = 2 * kRows + kRows * kOStride;  // m, l, O
  static constexpr int kPartStride = kWarpBytes / 4;   // a warp's stages
  static_assert(kPart * 4 <= kWarpBytes, "a warp's merge reuses its stages");
};

constexpr unsigned kNoRow = 0xFFFFFFFFu;

// One chunk's 16 K rows and 16 V rows into a warp's stage: lane i < 16
// holds the pool row of token i, or kNoRow past the context (zeros are
// copied instead).
template <int DH, int ROWB>
__device__ __forceinline__ void load_chunk(uint32_t ks, uint32_t vs,
                                           const uint16_t* __restrict__ kp,
                                           const uint16_t* __restrict__ vp,
                                           unsigned my_row, int lane) {
  constexpr int kPieces = DH / 8;                  // 16 bytes each, a row
  constexpr int kPerLane = kChunk * kPieces / 32;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int piece = lane + 32 * j;
    const int t = piece / kPieces, c = piece % kPieces;
    const unsigned row = __shfl_sync(kFull, my_row, t);
    const size_t src = (size_t)(row != kNoRow ? row : 0) * DH + c * 8;
    const int bytes = row != kNoRow ? 16 : 0;
    cp_async16(ks + t * ROWB + c * 16, kp + src, bytes);
    cp_async16(vs + t * ROWB + c * 16, vp + src, bytes);
  }
}

template <int DH, class H>
__global__ void __launch_bounds__(kMmaThreads)
paged_decode_mma_kernel(const float* __restrict__ q,
                        const uint16_t* __restrict__ kp,
                        const uint16_t* __restrict__ vp,
                        const int* __restrict__ block_table,
                        const int* __restrict__ ctx_len,
                        const int* __restrict__ q_len,
                        float* __restrict__ out, int hkv, int rows, int w,
                        int single, int page_size, int max_pages,
                        float scale) {
  using L = MmaTile<DH, H>;
  constexpr int kRowB = L::kRowB;
  constexpr int kMt = DH / 16;                  // O^T tiles (16 dh each)
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float s_rs[kRows];                 // each row's score factor
  __shared__ float s_w[kMmaWarps][kRows];       // the warps' merge weights
  __shared__ float s_bl[kRows];                 // the block's l

  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int groups = (rows + kRows - 1) / kRows;
  const int unit = blockIdx.x / C;
  const int bh = unit / groups, row0 = (unit % groups) * kRows;
  const int b = bh / hkv, h = bh % hkv;
  const size_t qrow0 = (size_t)bh * rows;
  const int max_tokens = max_pages * page_size;
  const int* bt = block_table + (size_t)b * max_pages;
  // chunk c goes to warp c mod 4 of rank (c / 4) mod A: a warp's first
  // chunk does not depend on A
  const int first = rank * kMmaWarps + warp;
  const uint32_t q_pl = smem_u32(smem);
  const uint32_t stage0 = q_pl + L::kQBytes + warp * L::kWarpBytes;

  // loaded before the slot's lengths arrive: the page ids of this warp's
  // first chunk (lane i: token i of the chunk)
  int pg[kStages];
  {
    const int t = first * kChunk + lane;
    pg[0] = lane < kChunk && t < max_tokens ? __ldg(bt + t / page_size) : 0;
  }
  int ctx, qn;
  if (single) {
    const int c = ctx_len[b];
    ctx = c > 0 ? c - 1 : 0;
    qn = c > 0 ? 1 : 0;
  } else {
    ctx = ctx_len[b];
    qn = q_len[b];
  }

  // this warp's two rows of q (2 warp, 2 warp + 1; zeros past the group)
  constexpr int kPairs = (DH / 2 + 31) / 32;    // column pairs per lane
  float2 x[2][kPairs];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = row0 + 2 * warp + k;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = lane + 32 * i;
      x[k][i] = r < rows && pair < DH / 2
                    ? __ldg(reinterpret_cast<const float2*>(
                          q + (qrow0 + r) * DH) + pair)
                    : make_float2(0.f, 0.f);
    }
  }

  // the first chunks' copies go out before q is cut
  const int attend = min(ctx + qn, max_tokens);
  const int n_chunks = (attend + kChunk - 1) / kChunk;
  // the active ranks: the fewest (a power of two <= C) that give no warp
  // more than 2 chunks; the others only keep the cluster's barriers. The
  // first half of a barrier tells, before the merge stores into another
  // block's shared memory, that every block of the cluster runs.
  int A = 1;
  while (A < C && 2 * kMmaWarps * A < n_chunks) A *= 2;
  if (A > 1) cluster_arrive_relaxed();
  if (rank >= A) {
    if (A > 1) {
      cluster_wait();
      cluster.sync();
    }
    return;
  }
  const int stride = kMmaWarps * A;
#pragma unroll
  for (int j = 1; j < kStages; ++j) {
    const int t = (first + j * stride) * kChunk + lane;
    pg[j] = lane < kChunk && t < attend ? __ldg(bt + t / page_size) : 0;
  }
  // lane i < 16: the pool row of token i of chunk c (page id pgv)
  auto pool_row = [&](int c, int pgv) -> unsigned {
    const int t = c * kChunk + lane;
    return lane < kChunk && t < attend
               ? ((unsigned)pgv * hkv + h) * page_size + t % page_size
               : kNoRow;
  };
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    const int c = first + j * stride;
    if (c < n_chunks)
      load_chunk<DH, kRowB>(stage0 + j * L::kStageBytes,
                            stage0 + j * L::kStageBytes + kChunk * kRowB, kp,
                            vp, pool_row(c, pg[j]), lane);
    cp_async_commit();
  }

  // q's planes of the warp's two rows
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int n = 2 * warp + k;
    float rs = scale;
    if (H::kRowScale) {
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        mx = fmaxf(mx, fmaxf(fabsf(x[k][i].x), fabsf(x[k][i].y)));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      // mx = f 2^(E - 127), f in [1, 2): 2^(141 - E) brings it into
      // [2^14, 2^15); both factors are exact powers of two
      const int biased = (__float_as_int(mx) >> 23) & 0xFF;
      const int e = mx > 0.f ? min(max(141 - max(biased, 1), -100), 100) : 0;
      const float up = __int_as_float((127 + e) << 23);
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        x[k][i] = make_float2(x[k][i].x * up, x[k][i].y * up);
      rs = scale * __int_as_float((127 - e) << 23);
    }
    if (lane == 0) s_rs[n] = rs;
#pragma unroll
    for (int p = 0; p < H::kPlanes; ++p)
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int pair = lane + 32 * i;
        if (pair >= DH / 2) continue;
        const uint32_t u = H::pack(x[k][i].x, x[k][i].y);
        const float2 f = H::unpack(u);
        x[k][i].x -= f.x;
        x[k][i].y -= f.y;
        *reinterpret_cast<uint32_t*>(smem + (p * kRows + n) * kRowB +
                                     4 * pair) = u;
      }
  }
  __syncthreads();                  // q's planes and row factors are written

  // this thread's rows of the score and O^T fragments: n0 = 2 t4 and n0 + 1;
  // a row attends positions <= its limit (-1: a row past the group or the
  // window)
  int limit[2];
  float rs[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = row0 + 2 * t4 + k;
    limit[k] = r < rows && r % w < qn ? min(ctx + r % w, attend - 1) : -1;
    rs[k] = s_rs[2 * t4 + k] * kLog2e;     // scores in log2 units
  }
  const uint32_t q_addr = q_pl + (lane & 7) * kRowB + 16 * (lane >> 3);
  const uint32_t k_lane = (lane & 15) * kRowB + 16 * (lane >> 4);
  const uint32_t v_lane =
      ((lane & 7) + 8 * (lane >> 4)) * kRowB + 16 * ((lane >> 3) & 1);

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[kMt][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  int pg_next = 0;
  {
    const int t = (first + kStages * stride) * kChunk + lane;
    if (lane < kChunk && t < attend) pg_next = __ldg(bt + t / page_size);
  }
  for (int j = 0, c = first; c < n_chunks; ++j, c += stride) {
    int pg_after = 0;
    {
      const int t = (c + (kStages + 1) * stride) * kChunk + lane;
      if (lane < kChunk && t < attend) pg_after = __ldg(bt + t / page_size);
    }
    const uint32_t ks = stage0 + (j % kStages) * L::kStageBytes;
    const uint32_t vs = ks + kChunk * kRowB;
    cp_async_wait<kStages - 1>();
    __syncwarp();                   // chunk c's rows are in the stage

    // S^T = K Q^T over the planes of q, in 2 * kPlanes independent sums
    // (a chain of dependent MMAs would wait on each one's latency); the
    // fragments of the next 32 columns are loaded before this step's MMAs
    float sp[H::kPlanes][2][4];
#pragma unroll
    for (int p = 0; p < H::kPlanes; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[p][0][e] = sp[p][1][e] = 0.f;
    uint32_t ka[2][2][4], qb[2][H::kPlanes][4];
    auto load_qk = [&](int kc, int buf) {
      ldsm4(ka[buf][0], ks + k_lane + 64 * kc);
      ldsm4(ka[buf][1], ks + k_lane + 64 * kc + 32);
#pragma unroll
      for (int p = 0; p < H::kPlanes; ++p)
        ldsm4(qb[buf][p], q_addr + p * kRows * kRowB + 64 * kc);
    };
    load_qk(0, 0);
#pragma unroll
    for (int kc = 0; kc < DH / 32; ++kc) {
      if (kc + 1 < DH / 32) load_qk(kc + 1, (kc + 1) & 1);
#pragma unroll
      for (int p = 0; p < H::kPlanes; ++p) {
        H::mma(sp[p][0], ka[kc & 1][0], qb[kc & 1][p][0], qb[kc & 1][p][1]);
        H::mma(sp[p][1], ka[kc & 1][1], qb[kc & 1][p][2], qb[kc & 1][p][3]);
      }
    }
    // V's first fragments, loaded while the softmax runs
    uint32_t va[2][4];
    ldsm4_t(va[0], vs + v_lane);
    if (kMt > 1) ldsm4_t(va[1], vs + v_lane + 32);
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = sp[H::kPlanes - 1][0][e] + sp[H::kPlanes - 1][1][e];
#pragma unroll
      for (int p = H::kPlanes - 2; p >= 0; --p)
        s[e] += sp[p][0][e] + sp[p][1][e];
    }

    // s[e]: token c * 16 + g (+ 8 for e >= 2), row n0 + (e & 1)
    const int tok = c * kChunk + g;
    float mx[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = tok + 8 * (e >> 1) <= limit[e & 1];
      s[e] = ok ? s[e] * rs[e & 1] : kNegInf;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mx[k] = fmaxf(s[k], s[k + 2]);
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(kFull, mx[k], 4));
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(kFull, mx[k], 8));
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(kFull, mx[k], 16));
    }
    float corr[2], p[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float m_new = fmaxf(m_run[k], mx[k]);
      corr[k] = exp2f(m_run[k] - m_new);
      m_run[k] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = tok + 8 * (e >> 1) <= limit[e & 1];
      p[e] = ok ? exp2f(s[e] - m_run[e & 1]) : 0.f;
    }
    l_run[0] = l_run[0] * corr[0] + (p[0] + p[2]);
    l_run[1] = l_run[1] * corr[1] + (p[1] + p[3]);

    // O^T = O^T * corr + V^T P^T, P rounded to the page's type
    const uint32_t b0 = movm_t(H::pack(p[0], p[1]));
    const uint32_t b1 = movm_t(H::pack(p[2], p[3]));
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      o[mt][0] *= corr[0];
      o[mt][1] *= corr[1];
      o[mt][2] *= corr[0];
      o[mt][3] *= corr[1];
      H::mma(o[mt], va[mt & 1], b0, b1);
      if (mt + 2 < kMt) ldsm4_t(va[mt & 1], vs + v_lane + 32 * (mt + 2));
    }
    __syncwarp();                   // the stage is read

    const int c2 = c + kStages * stride;
    if (c2 < n_chunks)
      load_chunk<DH, kRowB>(ks, vs, kp, vp, pool_row(c2, pg_next), lane);
    cp_async_commit();
    pg_next = pg_after;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l_run[k] += __shfl_xor_sync(kFull, l_run[k], 4);
    l_run[k] += __shfl_xor_sync(kFull, l_run[k], 8);
    l_run[k] += __shfl_xor_sync(kFull, l_run[k], 16);
  }

  // each warp's (m, l, O) into its own stages (its copies have landed),
  // then the block's merge in warp order: row n's weights c_j = exp(m_j -
  // M) computed once
  float* part = reinterpret_cast<float*>(smem + L::kQBytes);
  float* mine = part + warp * L::kPartStride;
  if (g == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mine[2 * t4 + k] = m_run[k];
      mine[kRows + 2 * t4 + k] = l_run[k];
    }
  }
  float* mine_o = mine + 2 * kRows;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const int d = mt * 16 + g;
    mine_o[(2 * t4) * L::kOStride + d] = o[mt][0];
    mine_o[(2 * t4 + 1) * L::kOStride + d] = o[mt][1];
    mine_o[(2 * t4) * L::kOStride + d + 8] = o[mt][2];
    mine_o[(2 * t4 + 1) * L::kOStride + d + 8] = o[mt][3];
  }
  __syncthreads();
  // the block's (m, l, O): with A > 1 each active rank's share of the
  // columns is pushed into that rank's receive area (slot ``rank``) by
  // remote stores
  float* recv = reinterpret_cast<float*>(smem + L::kRecvOffset);
  const int share = DH / A;
  if (A > 1) cluster_wait();
  if (tid < kRows) {
    float m = kNegInf;
#pragma unroll
    for (int j = 0; j < kMmaWarps; ++j)
      m = fmaxf(m, part[j * L::kPartStride + tid]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaWarps; ++j) {
      const float cj = exp2f(part[j * L::kPartStride + tid] - m);
      s_w[j][tid] = cj;
      l = fmaf(part[j * L::kPartStride + kRows + tid], cj, l);
    }
    s_bl[tid] = l;
    if (A > 1)
      for (int r = 0; r < A; ++r) {
        float* dst = cluster.map_shared_rank(recv, r) + 2 * kRows * rank;
        dst[tid] = m;
        dst[kRows + tid] = l;
      }
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * DH / 4; idx += kMmaThreads) {
    const int n = idx / (DH / 4), d = 4 * (idx % (DH / 4));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMmaWarps; ++j) {
      const float4 oj = *reinterpret_cast<const float4*>(
          part + j * L::kPartStride + 2 * kRows + n * L::kOStride + d);
      const float w = s_w[j][n];
      a = make_float4(fmaf(oj.x, w, a.x), fmaf(oj.y, w, a.y),
                      fmaf(oj.z, w, a.z), fmaf(oj.w, w, a.w));
    }
    if (A == 1) {
      if (row0 + n < rows) {
        const float l = fmaxf(s_bl[n], 1e-30f);
        *reinterpret_cast<float4*>(out + (qrow0 + row0 + n) * DH + d) =
            make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
      }
    } else {
      const int r = d / share, j = d % share;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, r) +
                                 L::kRecvO + (rank * kRows + n) * share +
                                 j) = a;
    }
  }
  if (A == 1) return;

  // one cluster barrier: every rank's share has landed; rank r merges the
  // A blocks' (m, l, O) of columns [r * DH / A, (r + 1) * DH / A) in rank
  // order from its own shared memory
  cluster.sync();
  const int quads = share / 4;
  for (int idx = tid; idx < kRows * quads; idx += kMmaThreads) {
    const int n = idx / quads, j = 4 * (idx % quads);
    if (row0 + n >= rows) continue;
    float m = kNegInf;
    for (int r = 0; r < A; ++r) m = fmaxf(m, recv[2 * kRows * r + n]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < A; ++r) {
      const float cr = exp2f(recv[2 * kRows * r + n] - m);
      const float4 o_r = *reinterpret_cast<const float4*>(
          recv + L::kRecvO + (r * kRows + n) * share + j);
      l = fmaf(recv[2 * kRows * r + kRows + n], cr, l);
      a = make_float4(fmaf(o_r.x, cr, a.x), fmaf(o_r.y, cr, a.y),
                      fmaf(o_r.z, cr, a.z), fmaf(o_r.w, cr, a.w));
    }
    l = fmaxf(l, 1e-30f);
    *reinterpret_cast<float4*>(out + (qrow0 + row0 + n) * DH + rank * share +
                               j) =
        make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
  }
}

template <int DH, class H>
cudaError_t mma_attributes() {
  // clusters above 8 blocks and the stages' shared memory need the
  // kernel's attributes; set once per instance
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_mma_kernel<DH, H>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(paged_decode_mma_kernel<DH, H>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MmaTile<DH, H>::kSmem);
  }();
  return err;
}

// The cluster size a launch asked for ``want`` (a power of two <= 16)
// uses: the largest power of two <= min(want, DH / 4) of which the card
// can hold one cluster (with one block per SM, clusters must fit within a
// GPC). Asked once per size; deterministic for the card.
template <int DH, class H>
int mma_cluster(int want) {
  static int cache[kMaxCluster + 1] = {};
  if (cache[want] == 0) {
    if (mma_attributes<DH, H>() != cudaSuccess) return 1;
    int s = min(want, DH / 4);        // each rank normalises 4 columns or more
    for (; s > 1; s /= 2) {
      int n = 0;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(s);
      cfg.blockDim = dim3(kMmaThreads);
      cfg.dynamicSmemBytes = MmaTile<DH, H>::kSmem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = s;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(
              &n, paged_decode_mma_kernel<DH, H>, &cfg) == cudaSuccess &&
          n > 0)
        break;
    }
    cudaGetLastError();             // a refused size is no launch error
    cache[want] = s;
  }
  return cache[want];
}

bool valid_cluster(int c) {
  return c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0;
}

template <int DH, class H>
cudaError_t launch_mma(const float* q, const uint16_t* kp, const uint16_t* vp,
                       const int* bt, const int* ctx, const int* qn,
                       float* out, int B, int hkv, int rows, int w,
                       int single, int page_size, int max_pages, int cluster,
                       float scale, cudaStream_t stream) {
  if (!valid_cluster(cluster)) return cudaErrorInvalidValue;
  const cudaError_t attr_err = mma_attributes<DH, H>();
  if (attr_err != cudaSuccess) return attr_err;
  const int C = mma_cluster<DH, H>(cluster);
  const int units = B * hkv * ((rows + kRows - 1) / kRows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units * C);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = MmaTile<DH, H>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;     // a cluster of one is a plain grid
  cudaError_t err = cudaLaunchKernelEx(&cfg, paged_decode_mma_kernel<DH, H>,
                                       q, kp, vp, bt, ctx, qn, out, hkv, rows,
                                       w, single, page_size, max_pages,
                                       scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class H>
int dispatch_mma(const float* q, const uint16_t* kp, const uint16_t* vp,
                 const int* bt, const int* ctx, const int* qn, float* out,
                 int B, int hkv, int rows, int dh, int w, int single,
                 int page_size, int max_pages, int cluster, float scale,
                 cudaStream_t stream) {
#define REPRO_MMA_LAUNCH(D)                                                 \
  launch_mma<D, H>(q, kp, vp, bt, ctx, qn, out, B, hkv, rows, w, single,    \
                   page_size, max_pages, cluster, scale, stream)
  cudaError_t err;
  switch (dh) {
    case 32: err = REPRO_MMA_LAUNCH(32); break;
    case 64: err = REPRO_MMA_LAUNCH(64); break;
    case 128: err = REPRO_MMA_LAUNCH(128); break;
    case 256: err = REPRO_MMA_LAUNCH(256); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_MMA_LAUNCH
  return (int)err;
}

template <class H>
int cluster_used(int dh, int want) {
  if (!valid_cluster(want)) return 0;
  switch (dh) {
    case 32: return mma_cluster<32, H>(want);
    case 64: return mma_cluster<64, H>(want);
    case 128: return mma_cluster<128, H>(want);
    case 256: return mma_cluster<256, H>(want);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch(es); cudaErrorInvalidValue
// for a head_dim the kernel is not built for. f32 and code pools
// (paged_decode_kernel): ``scratch`` holds
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

// bf16 and f16 pools (paged_decode_mma_kernel): ``kp``/``vp`` hold bf16
// (f16) bits; q and out are f32. ``cluster``: the blocks per cluster asked
// for, a power of two <= 16 (``paged_decode_cluster`` says which size the
// card gives). No scratch: the cluster merges in shared memory.
int paged_decode_ragged_bf16(const float* q, const uint16_t* kp,
                             const uint16_t* vp, const int* block_table,
                             const int* ctx_len, const int* q_len, float* out,
                             int B, int hkv, int rows, int dh, int w,
                             int single, int page_size, int max_pages,
                             int cluster, float scale, cudaStream_t stream) {
  return dispatch_mma<Bf16Mma>(q, kp, vp, block_table, ctx_len, q_len, out,
                               B, hkv, rows, dh, w, single, page_size,
                               max_pages, cluster, scale, stream);
}

int paged_decode_ragged_f16(const float* q, const uint16_t* kp,
                            const uint16_t* vp, const int* block_table,
                            const int* ctx_len, const int* q_len, float* out,
                            int B, int hkv, int rows, int dh, int w,
                            int single, int page_size, int max_pages,
                            int cluster, float scale, cudaStream_t stream) {
  return dispatch_mma<F16Mma>(q, kp, vp, block_table, ctx_len, q_len, out, B,
                              hkv, rows, dh, w, single, page_size, max_pages,
                              cluster, scale, stream);
}

// The cluster size a bf16 (``f16`` == 0) or f16 launch at head dim ``dh``
// that asks for ``want`` blocks uses; 0 for arguments no launch takes.
int paged_decode_cluster(int dh, int f16, int want) {
  return f16 ? cluster_used<F16Mma>(dh, want) : cluster_used<Bf16Mma>(dh, want);
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
