// Online-softmax (flash) attention for the dense prefill, for Hopper
// (sm_90a). Forward only, as the TPU kernel is.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (TPU).
//
// q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh) f32, Hq = rep * Hkv (GQA):
// query head hq attends KV head hq / rep. out (B, Hq, Sq, dh) f32.
// Scores are q . k * 1/sqrt(dh); with ``causal`` a key at position c is
// attended by the query at position r only when r >= c (keys from 0,
// query row i at q_offset + i: 0 as the TPU kernel masks, a shard's
// first position under context-parallel prefill). Online softmax with a
// -1e30 mask, masked probabilities forced to 0, and a 1e-30 clamp on the
// denominator.
//
// Bound on the H100: the function reads q, k, v once and writes out once
// (4 * dh * (2 * B * Hq * Sq + 2 * B * Hkv * Skv) bytes) and does
// 4 * B * Hq * Sq * Skv * dh flops (half of it under the causal mask). At
// the serving path's short prompts (tens of tokens) that is a few MFLOP
// per launch, so latency bounds it: the chain of loads and products of
// one block. At long prompts (thousands of tokens) the flops do:
// 67 TFLOP/s in f32 FMA, 989 TFLOP/s for one bf16 tensor-core pass.
//
// Design:
//  * GQA rows packed. A block owns one (batch, KV head) and BQ rows (64
//    by default) of its group's (query position x query head) rows, row
//    r = pos * rep + head: with rep = 8 and BQ = 64, 8 positions of all 8
//    heads. K and V tiles are loaded
//    once for the whole group, not once per query head.
//  * Tensor cores through an exact split. Q, K, V and the probabilities P
//    are f32; each operand is cut into bf16 hi + lo planes (hi =
//    bf16(v), lo = bf16(v - hi); v - hi - lo is below 2^-16 of |v|), and
//    S = Q K^T and O += P V each take three bf16 MMAs with f32
//    accumulation, hi.hi + hi.lo + lo.hi, whose products are exact in
//    f32. Dropped: lo.lo and the planes' residuals, about 2^-16 of each
//    |term|, random in sign, so some 2^-16 * sqrt(dh) * |q||k| / sqrt(dh)
//    on a score: well inside the 1e-4 tolerance held against the f32
//    plain version. The MMA is mma.sync.m16n8k16 (bf16 in, f32 out): a
//    warp owns 16 rows and its own S and O fragments in registers, so the
//    softmax statistics and rescaling stay f32 in registers with two quad
//    shuffles per row and no shared score tile; at these tile sizes a
//    warpgroup MMA would add fences and a shared-memory P for little.
//  * Q is split once per block into bf16 hi and lo planes in shared
//    memory; K and V tiles of BKV keys (32 by default) stream as f32
//    through a
//    shared-memory stage filled by cp.async one tile ahead, and each tile
//    is split once, by the whole block, into hi and lo planes. The warps
//    read every operand's fragments from the planes with ldmatrix (V's
//    transposed).
//  * One block walks all the KV tiles of its rows and normalises straight
//    from registers. Dealing the KV tiles of a short prompt over the
//    blocks of a cluster, merged through distributed shared memory, was
//    measured slower at the serving shape than walking them in one block
//    (PERF.md): the merge's remote reads cost more than the second tile.
//  * Ragged lengths: rows past Sq * rep and keys past Skv load as zeros
//    and are masked; rows past the end are never written. Causal: KV tiles
//    wholly above the tile's last position are skipped, which computes
//    the same function as visiting and masking them.
//  * dh is a template parameter (32, 64, 80, 128, 256; any multiple of 16
//    whose planes fit); others are refused.
//  * The tile is a template parameter too: BQ packed rows a block (32, 64
//    or 128; 16 a warp) and BKV keys a KV tile (32 or 64). Every pair
//    whose shared memory (Tile::kBytes) fits a block is built at each dh;
//    runtime/planner.py (plan_attention) picks one: (64, 32) unless
//    REPRO_BLOCKS_ATTN pins another. A pair not built is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kSmemMax = 232448;   // a block's shared memory (opt-in)

// The block of (DH, BQ, BKV): BQ packed rows over BQ / 16 warps, KV tiles
// of BKV keys. The f32 Q tile lands first where K's and V's planes go
// later, so that region holds the larger of the two.
template <int DH, int BQ, int BKV>
struct Tile {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPl = 2 * DH + 16;    // bytes per bf16 plane row
  static constexpr int kQPl = 2 * BQ * kPl;          // Q hi and lo planes
  static constexpr int kKvPl = 2 * 2 * BKV * kPl;    // K and V, hi and lo
  static constexpr int kQF32 = BQ * DH * 4;          // the f32 Q tile
  static constexpr int kKvRegion = kKvPl > kQF32 ? kKvPl : kQF32;
  static constexpr int kStage = 2 * BKV * DH * 4;    // f32 K and V tile
  static constexpr int kBytes = kQPl + kKvRegion + kStage;
  static_assert(BQ % 16 == 0 && BKV % 16 == 0, "whole MMA tiles");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// (a, b) = hi + lo, each a pair of bf16 packed low value first
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// d += a (16 x 16, row) @ b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi.hi + hi.lo + lo.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma16816(d, ah, bh0, bh1);
  mma16816(d, ah, bl0, bl1);
  mma16816(d, al, bh0, bh1);
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 address matrix i's rows
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes from src (or zeros when !in; src stays a valid address) to dst:
// cp.async when aligned
__device__ __forceinline__ void copy16(float* dst, const float* src, bool in,
                                       bool aligned) {
  if (aligned) {
    cp_async16(dst, src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = in ? src[i] : 0.f;
  }
}

// f32 rows (n_rows x DH, row-major) -> bf16 hi and lo planes (kPl bytes a
// row, lo plane `lo_off` bytes after hi)
template <class T, int DH>
__device__ __forceinline__ void split_rows(const float* src, uint8_t* hi,
                                           int lo_off, int n_rows) {
  for (int e = threadIdx.x; e < n_rows * (DH / 4); e += T::kThreads) {
    const int r = e / (DH / 4), d = (e % (DH / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * DH + d);
    uint2 h, l;
    split2(x.x, x.y, h.x, l.x);
    split2(x.z, x.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * T::kPl + 2 * d) = h;
    *reinterpret_cast<uint2*>(hi + lo_off + r * T::kPl + 2 * d) = l;
  }
}

template <int DH, int BQ, int BKV>
__global__ void __launch_bounds__(Tile<DH, BQ, BKV>::kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int hq, int rep, int sq, int skv, int causal,
                       int q_offset, float scale) {
  using T = Tile<DH, BQ, BKV>;
  constexpr int kBq = BQ, kBkv = BKV, kThreads = T::kThreads;
  constexpr int kNd = DH / 8;            // O fragments (8 columns each)
  constexpr int kNs = kBkv / 8;          // S fragments (8 keys each)
  constexpr int kPlane = kBkv * T::kPl;  // one K or V plane
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* q_pl = smem;                            // hi, then lo
  uint8_t* kv_pl = smem + T::kQPl;                 // K hi, K lo, V hi, V lo
  float* stage = reinterpret_cast<float*>(kv_pl + T::kKvRegion);  // K, V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hkv = hq / rep;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y - b * hkv;
  const int rows = sq * rep;               // packed rows of the group
  const int rho0 = blockIdx.x * kBq;
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv * DH;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  int n_tiles = (skv + kBkv - 1) / kBkv;
  if (causal) {
    const int last =
        q_offset + min(sq - 1, (min(rows, rho0 + kBq) - 1) / rep);
    n_tiles = min(n_tiles, last / kBkv + 1);
  }

  // the f32 Q tile lands in the K/V planes' space, K/V tile 0 in the stage
  float* q_f32 = reinterpret_cast<float*>(kv_pl);
  for (int e = tid; e < kBq * (DH / 4); e += kThreads) {
    const int r = e / (DH / 4), d = (e % (DH / 4)) * 4;
    const int rho = rho0 + r < rows ? rho0 + r : 0, pos = rho / rep;
    const int head = kvh * rep + (rho - pos * rep);
    copy16(q_f32 + r * DH + d,
           q + (((size_t)b * hq + head) * sq + pos) * DH + d,
           rho0 + r < rows, aligned);
  }
  cp_async_commit();
  auto load_tile = [&](int t) {
    for (int e = tid; e < kBkv * (DH / 4); e += kThreads) {
      const int c = e / (DH / 4), d = (e % (DH / 4)) * 4;
      const int key = t * kBkv + c;
      const size_t src = kv_base + (size_t)(key < skv ? key : 0) * DH + d;
      copy16(stage + c * DH + d, k + src, key < skv, aligned);
      copy16(stage + (kBkv + c) * DH + d, v + src, key < skv, aligned);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);
  else cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                // the Q tile landed
  split_rows<T, DH>(q_f32, q_pl, kBq * T::kPl, kBq);

  // this thread's two rows (g and g + 8 of the warp's 16) and their
  // positions under the causal mask (row i of q sits at q_offset + i)
  const int r0 = warp * 16 + g;
  const int pos0 = q_offset + (rho0 + r0) / rep;
  const int pos1 = q_offset + (rho0 + r0 + 8) / rep;
  // ldmatrix row addresses: A (Q) rows of the warp, B (K) keys, V keys
  const uint32_t qa = smem_u32(q_pl) + (warp * 16 + (lane & 15)) * T::kPl +
                      16 * (lane >> 4);
  const uint32_t ka = smem_u32(kv_pl) +
                      ((lane & 7) + 8 * (lane >> 4)) * T::kPl +
                      16 * ((lane >> 3) & 1);
  const uint32_t va = smem_u32(kv_pl) + 2 * kPlane +
                      ((lane & 7) + 8 * ((lane >> 3) & 1)) * T::kPl +
                      16 * (lane >> 4);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kNd][4];
#pragma unroll
  for (int i = 0; i < kNd; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int c0 = i * kBkv;
    cp_async_wait<0>();
    __syncthreads();              // tile i landed; the planes are free
    split_rows<T, DH>(stage, kv_pl, kPlane, kBkv);
    split_rows<T, DH>(stage + kBkv * DH, kv_pl + 2 * kPlane, kPlane, kBkv);
    __syncthreads();              // the planes are written, the stage read
    if (i + 1 < n_tiles) load_tile(i + 1);

    // S = Q K^T: 16 rows x kBkv keys per warp, kNs 8-key fragments
    float s[kNs][4];
#pragma unroll
    for (int j = 0; j < kNs; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < DH / 16; ++kc) {
      uint32_t ah[4], al[4];
      ldsm4(ah, qa + 32 * kc);
      ldsm4(al, qa + kBq * T::kPl + 32 * kc);
#pragma unroll
      for (int jp = 0; jp < kNs / 2; ++jp) {
        uint32_t kh[4], kl[4];
        const uint32_t addr = ka + jp * 16 * T::kPl + 32 * kc;
        ldsm4(kh, addr);
        ldsm4(kl, addr + kPlane);
        mma3(s[2 * jp], ah, al, kh[0], kh[1], kl[0], kl[1]);
        mma3(s[2 * jp + 1], ah, al, kh[2], kh[3], kl[2], kl[3]);
      }
    }

    // mask, scale and the online-softmax statistics of rows r0 and r0 + 8
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + j * 8 + 2 * t4 + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const bool ok = key < skv && (!causal || pos >= key);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + j * 8 + 2 * t4 + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const bool ok = key < skv && (!causal || pos >= key);
        s[j][e] = ok ? expf(s[j][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }

    // O += P V: P's accumulator fragments are its A fragments
#pragma unroll
    for (int kk = 0; kk < kNs / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kNd / 2; ++dp) {
        uint32_t vh[4], vl[4];
        const uint32_t addr = va + kk * 16 * T::kPl + 32 * dp;
        ldsm4_t(vh, addr);
        ldsm4_t(vl, addr + kPlane);
        mma3(o[2 * dp], ph, pl, vh[0], vh[1], vl[0], vl[1]);
        mma3(o[2 * dp + 1], ph, pl, vh[2], vh[3], vl[2], vl[3]);
      }
    }
  }
  cp_async_wait<0>();
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + r0 + 8 * h;
    if (rho >= rows) continue;
    const int pos = rho / rep, head = kvh * rep + (rho - pos * rep);
    float* dst = out + (((size_t)b * hq + head) * sq + pos) * DH + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8) =
          make_float2(o[nd][2 * h] * inv[h], o[nd][2 * h + 1] * inv[h]);
  }
}

template <int DH, int BQ, int BKV>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int hq, int rep, int sq, int skv, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  using T = Tile<DH, BQ, BKV>;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      flash_attention_kernel<DH, BQ, BKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((sq * rep + BQ - 1) / BQ, B * (hq / rep));
  flash_attention_kernel<DH, BQ, BKV><<<grid, T::kThreads, T::kBytes,
                                        stream>>>(
      q, k, v, out, hq, rep, sq, skv, causal, q_offset, scale);
  return cudaGetLastError();
}

// The built tiles: every (BQ, BKV) whose block fits at head dim DH.
template <int DH, int BQ, int BKV>
constexpr bool kBuilt = Tile<DH, BQ, BKV>::kBytes <= kSmemMax;

#define REPRO_FLASH_TILES(X) X(32, 32) X(32, 64) X(64, 32) X(64, 64) \
  X(128, 32) X(128, 64)

template <int DH, int BQ, int BKV>
cudaError_t launch_if_built(const float* q, const float* k, const float* v,
                            float* out, int B, int hq, int rep, int sq,
                            int skv, int causal, int q_offset, float scale,
                            cudaStream_t stream) {
  if constexpr (kBuilt<DH, BQ, BKV>)
    return launch<DH, BQ, BKV>(q, k, v, out, B, hq, rep, sq, skv, causal,
                               q_offset, scale, stream);
  else
    return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_tile(const float* q, const float* k, const float* v,
                        float* out, int B, int hq, int rep, int sq, int skv,
                        int causal, int q_offset, int bq, int bkv,
                        float scale, cudaStream_t stream) {
#define REPRO_FLASH_LAUNCH(BQ, BKV)                                         \
  if (bq == BQ && bkv == BKV)                                               \
    return launch_if_built<DH, BQ, BKV>(q, k, v, out, B, hq, rep, sq, skv,  \
                                        causal, q_offset, scale, stream);
  REPRO_FLASH_TILES(REPRO_FLASH_LAUNCH)
#undef REPRO_FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

template <int DH>
int tile_bytes(int bq, int bkv) {
#define REPRO_FLASH_BYTES(BQ, BKV)                                          \
  if (bq == BQ && bkv == BKV)                                               \
    return kBuilt<DH, BQ, BKV> ? Tile<DH, BQ, BKV>::kBytes : 0;
  REPRO_FLASH_TILES(REPRO_FLASH_BYTES)
#undef REPRO_FLASH_BYTES
  return 0;
}

#undef REPRO_FLASH_TILES

}  // namespace

extern "C" {

// Returns the launch's error; cudaErrorInvalidValue for a head_dim or a
// tile (bq packed rows, bkv keys) the kernel is not built for.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, int B, int hq, int rep, int sq, int skv,
                        int dh, int causal, int q_offset, int bq, int bkv,
                        float scale, cudaStream_t stream) {
#define REPRO_FLASH_DH(D)                                                   \
  case D:                                                                   \
    return (int)launch_tile<D>(q, k, v, out, B, hq, rep, sq, skv, causal,   \
                               q_offset, bq, bkv, scale, stream);
  switch (dh) {
    REPRO_FLASH_DH(32) REPRO_FLASH_DH(64) REPRO_FLASH_DH(80)
    REPRO_FLASH_DH(128) REPRO_FLASH_DH(256)
  }
#undef REPRO_FLASH_DH
  return (int)cudaErrorInvalidValue;
}

// Shared memory of a block of the built tile (bq, bkv) at head dim dh; 0
// where none is built.
int flash_attention_tile_bytes(int dh, int bq, int bkv) {
  switch (dh) {
    case 32: return tile_bytes<32>(bq, bkv);
    case 64: return tile_bytes<64>(bq, bkv);
    case 80: return tile_bytes<80>(bq, bkv);
    case 128: return tile_bytes<128>(bq, bkv);
    case 256: return tile_bytes<256>(bq, bkv);
  }
  return 0;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
