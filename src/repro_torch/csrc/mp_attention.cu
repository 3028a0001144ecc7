// Banded-precision flash-decode attention: the partials of one KV segment,
// written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mp_attention/mp_attention.py: _flash_segment_kernel /
//   flash_decode_segment.
//
// For each row b of B (batch * kv_heads) and each of its G query heads:
//   scores_j = (q . k_j) * sm_scale, or -1e30 where j >= seg_len[b];
//   online softmax over the keys: m = running max, l = running sum of
//   exp(s - m), acc = running sum of exp(s - m) v_j, all fp32.
// int8 K/V are dequantized with the scale of their (row, key block):
// scales[b, j / blk] = (k scale, v scale).  Masking uses -1e30 and not -inf,
// as the reference does: a segment with no valid key then gives m = -1e30,
// l = S and acc = sum of v (exp(0) = 1 on every masked key), which the merge
// weights by exp(-1e30 - m_tot) = 0, where -inf would give NaN.
//
// What bounds it on the H100: bytes.  A decode step reads each K/V row once
// and does 4 G d flops on it (G <= 16), far below the ~295 flops per byte at
// which the tensor cores would bound; the least time is the K/V bytes over
// 3.35 TB/s.
//
// What the design does about it: int8 K/V move half the bytes of bf16, and
// the kernel reads them as they are stored, 16 bytes per thread per load,
// dequantizing while it stages them in shared memory as fp32; keys past the
// last tile that holds a valid one are not read at all (their p = 0 exactly,
// so the result is the same).  The simple layout: one block per row b, a
// loop over 64-key tiles, q (G x d) and the tile's K, V and scores in shared
// memory, one warp per query head for the max and sum (warp shuffles), each
// thread one column of d for up to 16 / (256 / d) heads of fp32 accumulators.
// With B = 32 at the serving shape this fills 32 of 132 SMs: a split-KV grid
// whose partials go through merge_partials is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per shared-memory tile: two per lane in a warp
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// Rows [0, kTile) of a row-major (., D) segment into shared memory as fp32
// times `scale`, row stride `lds`.  16-byte vector loads; a load never
// crosses a row since D is a multiple of 16 / sizeof(KT).
template <typename KT, int D>
__device__ __forceinline__ void stage_tile(const KT* __restrict__ src, float* dst, int lds,
                                           float scale) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(KT));
  constexpr int kChunks = kTile * D / kVec;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const uint4 raw = src4[c];
    const KT* vals = reinterpret_cast<const KT*>(&raw);
    const int r = (c * kVec) / D, col = (c * kVec) % D;
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * lds + col + i] = to_float(vals[i]) * scale;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kTile * (D + 1) + kTile * D + kMaxG * D + kMaxG * kTile + 3 * kMaxG);
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
flash_segment_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                     const KT* __restrict__ v, const float* __restrict__ scales,
                     const int* __restrict__ seg_len, float* __restrict__ acc_out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int G, int S,
                     int blk, float sm_scale) {
  constexpr int LDK = D + 1;             // padded: a warp reads one column of 32 rows
  constexpr int kGroups = kThreads / D;  // threads per column of d
  constexpr int kHeads = kMaxG / kGroups;  // heads per thread in the P V product
  extern __shared__ float smem[];
  float* Ks = smem;                   // kTile x LDK
  float* Vs = Ks + kTile * LDK;       // kTile x D
  float* Qs = Vs + kTile * D;         // G x D
  float* Ps = Qs + kMaxG * D;         // G x kTile: scores, then probabilities
  float* Ms = Ps + kMaxG * kTile;     // running max per head
  float* Ls = Ms + kMaxG;             // running sum per head
  float* As = Ls + kMaxG;             // rescale factor of the current tile

  const long long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const QT* qb = q + row * G * D;
  const KT* kb = k + row * S * D;
  const KT* vb = v + row * S * D;
  const float* sb = scales ? scales + row * (S / blk) * 2 : nullptr;
  const int len = seg_len[row];

  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_float(qb[i]);
  if (tid < kMaxG) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  const int col = tid % D, g0 = tid / D;
  float acc[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) acc[h] = 0.f;

  // Tiles past the last valid key add p = exp(-1e30 - m) = 0 once some key
  // was valid, so they are skipped; with no valid key every tile counts.
  const int n_tiles = S / kTile;
  const int n_used = len <= 0 ? n_tiles : min(n_tiles, (len + kTile - 1) / kTile);
  for (int t = 0; t < n_used; ++t) {
    const int key0 = t * kTile;
    float k_sc = 1.f, v_sc = 1.f;
    if (sb) {
      k_sc = sb[2 * (key0 / blk)];
      v_sc = sb[2 * (key0 / blk) + 1];
    }
    stage_tile<KT, D>(kb + static_cast<long long>(key0) * D, Ks, LDK, k_sc);
    stage_tile<KT, D>(vb + static_cast<long long>(key0) * D, Vs, D, v_sc);
    __syncthreads();

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i % kTile;
      const float* qr = Qs + g * D;
      const float* kr = Ks + j * LDK;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
      s *= sm_scale;
      Ps[g * kTile + j] = key0 + j < len ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pr = Ps + g * kTile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Ms[g] = m_new;
        Ls[g] = alpha * Ls[g] + sum;
        As[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const int g = g0 + h * kGroups;
      if (g < G) acc[h] *= As[g];
    }
    for (int j = 0; j < kTile; ++j) {
      const float vj = Vs[j * D + col];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const int g = g0 + h * kGroups;
        if (g < G) acc[h] = fmaf(Ps[g * kTile + j], vj, acc[h]);
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    const int g = g0 + h * kGroups;
    if (g < G) acc_out[(row * G + g) * D + col] = acc[h];
  }
  if (tid < G) {
    m_out[row * G + tid] = Ms[tid];
    l_out[row * G + tid] = Ls[tid];
  }
}

struct Args {
  const void *q, *k, *v;
  const float* scales;
  const int* seg_len;
  float *acc, *m, *l;
  int batch, g, s, blk;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D>
cudaError_t launch(const Args& a) {
  auto kernel = flash_segment_kernel<QT, KT, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.batch, kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      a.scales, a.seg_len, a.acc, a.m, a.l, a.g, a.s, a.blk, a.sm_scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_d(const Args& a, int d) {
  return d == 64 ? launch<QT, KT, 64>(a) : launch<QT, KT, 128>(a);
}

template <typename QT>
cudaError_t launch_kv(const Args& a, int d, int kv_dtype) {
  switch (kv_dtype) {
    case 0: return launch_d<QT, float>(a, d);
    case 1: return launch_d<QT, __nv_bfloat16>(a, d);
    default: return launch_d<QT, int8_t>(a, d);
  }
}

}  // namespace

// q: (batch, g, d) fp32 (q_bf16 = 0) or bf16; k, v: (batch, s, d) contiguous,
// 16-byte aligned, kv_dtype 0 = fp32, 1 = bf16, 2 = int8 (scales (batch,
// s / blk, 2) fp32, else null); seg_len: (batch,) int32.  Outputs: acc
// (batch, g, d), m and l (batch, g) fp32.  Requires 1 <= g <= 16,
// d in {64, 128}, blk % 64 == 0 and s % blk == 0.
extern "C" int mp_attention_launch(const void* q, const void* k, const void* v,
                                   const void* scales, const void* seg_len, void* acc,
                                   void* m, void* l, int batch, int g, int d, int s, int blk,
                                   float sm_scale, int q_bf16, int kv_dtype, void* stream) {
  if (batch < 1 || g < 1 || g > kMaxG || (d != 64 && d != 128) || blk < kTile ||
      blk % kTile || s % blk || kv_dtype < 0 || kv_dtype > 2 || (kv_dtype == 2) != (scales != nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(scales), static_cast<const int*>(seg_len),
               static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
               batch, g, s, blk, sm_scale, static_cast<cudaStream_t>(stream)};
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, d, kv_dtype) : launch_kv<float>(a, d, kv_dtype);
}
