// Online-softmax (flash) attention for the dense prefill, for Hopper
// (sm_90a). Forward only, as the TPU kernel is.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (TPU).
//
// q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh) f32, Hq = rep * Hkv (GQA):
// query head hq attends KV head hq / rep. out (B, Hq, Sq, dh) f32.
// Scores are q . k * 1/sqrt(dh); with ``causal`` a key at position c is
// attended by the query at position r only when r >= c (positions from 0
// in both, as the TPU kernel masks). Online softmax with a -1e30 mask,
// masked probabilities forced to 0, and a 1e-30 clamp on the denominator.
//
// Bound on the H100: the function reads q, k, v once and writes out once
// (4 * dh * (2 * B * Hq * Sq + 2 * B * Hkv * Skv) bytes) and does
// 4 * B * Hq * Sq * Skv * dh flops (half of it under the causal mask); at
// the dense prefill's lengths (tens to hundreds of tokens) and dh = 256
// that is well over 20 flops per byte, so it is bound by the f32 FMA rate
// (67 TFLOP/s) once the grid fills the card.
//
// Design:
//  * One block per (query tile of kBq rows, b * Hq + hq): the TPU kernel's
//    sequential KV grid axis becomes a loop inside the block. The block
//    indexes its KV head hq / rep itself, so GQA needs no repeated K/V.
//  * The Q tile, one K tile and one V tile of kBkv rows live in shared
//    memory; each thread keeps its share of the (kBq x dh) accumulator in
//    registers, and the per-row (m, l) statistics sit in shared memory.
//  * Scores: each thread computes 4 (row, key) dots over dh; the Q and K
//    tiles carry one float of padding per row so the 8 keys a warp reads
//    at one d fall in 8 different banks.
//  * Ragged lengths: rows past Sq and keys past Skv load as zeros and are
//    masked; rows past Sq are never written. Every Sq and Skv runs here,
//    with no plain fallback.
//  * Causal: KV tiles that lie wholly above the diagonal are skipped,
//    which computes the same function as visiting and masking them.
//  * dh is a template parameter (32, 64, 128, 256); others are refused.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBq = 32;        // query rows per block
constexpr int kBkv = 32;       // keys per KV tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kSp = kBkv + 1;  // padded row stride of the score tile

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
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int hq, int rep, int sq, int skv, int causal,
                       float scale) {
  constexpr int kStr = DH + 1;        // padded row stride of Q and K tiles
  constexpr int kPer = DH / 8;        // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                  // kBq * kStr
  float* s_k = s_q + kBq * kStr;      // kBkv * kStr
  float* s_v = s_k + kBkv * kStr;     // kBkv * DH
  float* s_s = s_v + kBkv * DH;       // kBq * kSp: scores, then probs
  float* s_m = s_s + kBq * kSp;       // kBq
  float* s_l = s_m + kBq;             // kBq
  float* s_c = s_l + kBq;             // kBq

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBq;
  const int bh = blockIdx.y;               // b * hq + head
  const int b = bh / hq, head = bh - b * hq;
  const int hkv = hq / rep;
  const size_t kv_bh = (size_t)b * hkv + head / rep;
  const float* qb = q + (size_t)bh * sq * DH;
  const float* kb = k + kv_bh * skv * DH;
  const float* vb = v + kv_bh * skv * DH;

  for (int e = tid; e < kBq * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    s_q[r * kStr + d] = q0 + r < sq ? qb[(size_t)(q0 + r) * DH + d] : 0.f;
  }
  for (int r = tid; r < kBq; r += kThreads) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }
  // accumulator: thread owns row ar and columns ac + 8 * i
  const int ar = tid >> 3, ac = tid & 7;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  int n_tiles = (skv + kBkv - 1) / kBkv;
  if (causal) {
    const int last = (q0 + kBq - 1) / kBkv + 1;  // tiles touching the diagonal
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  // score micro-tile: row sr, keys sc + 8 * i
  const int sr = tid >> 3, sc = tid & 7;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBkv;
    __syncthreads();  // previous tile's readers are done
    for (int e = tid; e < kBkv * DH; e += kThreads) {
      const int c = e / DH, d = e - c * DH;
      const bool in = c0 + c < skv;
      const size_t g = (size_t)(c0 + c) * DH + d;
      s_k[c * kStr + d] = in ? kb[g] : 0.f;
      s_v[c * DH + d] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = s_q + sr * kStr;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dot[i] = fmaf(qv, s_k[(sc + 8 * i) * kStr + d], dot[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = sc + 8 * i, kpos = c0 + c, qpos = q0 + sr;
      const bool ok = kpos < skv && (!causal || qpos >= kpos);
      s_s[sr * kSp + c] = ok ? dot[i] * scale : kNegInf;
    }
    __syncthreads();

    // online-softmax statistics: one warp per row, one key per lane
    for (int r = warp; r < kBq; r += kThreads / 32) {
      const int kpos = c0 + lane, qpos = q0 + r;
      const bool ok = kpos < skv && (!causal || qpos >= kpos);
      const float s = s_s[r * kSp + lane];
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      s_s[r * kSp + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_c[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    const float corr = s_c[ar];
    const float* pr = s_s + ar * kSp;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
    for (int c = 0; c < kBkv; ++c) {
      const float p = pr[c];
      const float* vr = s_v + c * DH + ac;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vr[8 * i], acc[i]);
    }
  }
  __syncthreads();

  if (q0 + ar < sq) {
    const float inv = 1.f / fmaxf(s_l[ar], 1e-30f);
    float* o = out + ((size_t)bh * sq + q0 + ar) * DH + ac;
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[8 * i] = acc[i] * inv;
  }
}

size_t smem_bytes(int dh) {
  return sizeof(float) * ((size_t)(kBq + kBkv) * (dh + 1) +
                          (size_t)kBkv * dh + (size_t)kBq * kSp + 3 * kBq);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int hq, int rep, int sq, int skv, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBq - 1) / kBq, B * hq);
  flash_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, hq, rep, sq, skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// head_dim the kernel is not built for.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, int B, int hq, int rep, int sq, int skv,
                        int dh, int causal, float scale,
                        cudaStream_t stream) {
  cudaError_t err;
  switch (dh) {
    case 32: err = launch<32>(q, k, v, out, B, hq, rep, sq, skv, causal,
                              scale, stream); break;
    case 64: err = launch<64>(q, k, v, out, B, hq, rep, sq, skv, causal,
                              scale, stream); break;
    case 128: err = launch<128>(q, k, v, out, B, hq, rep, sq, skv, causal,
                                scale, stream); break;
    case 256: err = launch<256>(q, k, v, out, B, hq, rep, sq, skv, causal,
                                scale, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
