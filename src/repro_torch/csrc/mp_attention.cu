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
// 3.35 TB/s (38.4 MB, 11.5 us, per layer of the served llama3.2-1b cache).
// To come near it the card needs many loads in flight on every SM.
//
// What the design does about it:
//   * a split-KV grid (B, n_split): each block takes one chunk of `chunk`
//     keys (a whole number of blk-key blocks, so it reads a contiguous range
//     of scales) of one row, and writes fp32 partials (acc, m, l) of that
//     chunk to a workspace.  The wrapper picks chunk so that the grid has at
//     least ~4 x 132 blocks where the segment allows it, so that several
//     blocks per SM hide each other's latency (kernels/mp_attention/
//     mp_attention.py: split_plan): at the served shape 32 x 19 far blocks
//     and 32 x 9 near;
//   * a second small kernel combines a row's chunks by log-sum-exp into the
//     segment's (acc, m, l), in chunk order, as merge_partials does; with one
//     chunk the first kernel writes the segment's partials itself;
//   * loads overlap math: the next 64-key tile of K and V is copied with
//     cp.async, as stored (int8, bf16 or fp32), into the second of two
//     shared-memory buffers while the current one is dequantized (int8 with
//     its block's scale) into fp32 and scored;
//   * the edge cases of the reference hold chunk by chunk: with no valid key
//     in the segment every chunk reads its keys and reports l = its length
//     (so the combine gives l = S and acc = sum of v); with some valid key,
//     a chunk wholly past seg_len reads nothing and writes (acc = 0,
//     m = -1e30, l = 0), which the combine weights by exp(-1e30 - m) = 0;
//     within a chunk, tiles past the last valid key add exactly 0 and are
//     skipped.
// The math of a tile: q (G x d), the dequantized K and V tiles and the
// scores in shared memory; one warp per query head for the max and sum
// (warp shuffles); in the P V product each of the first (256 / d) d threads
// owns one column of d for up to ceil(16 / (256 / d)) heads of fp32
// accumulators (d = 80: 3 groups of 80 threads, 6 heads each, and threads
// 240-255 sit it out), so that every (head, column) pair has one owner.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per shared-memory tile: two per lane in a warp
constexpr int kMaxG = 16;
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename KT, int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * D * static_cast<int>(sizeof(KT));
}

// Start copying the kTile keys from `src` (K or V rows, as stored) into `dst`.
template <typename KT, int D>
__device__ __forceinline__ void issue_tile(const KT* __restrict__ src, uint8_t* dst) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
  for (int c = threadIdx.x; c < tile_bytes<KT, D>() / 16; c += kThreads)
    cp_async16(dst + 16 * c, s + 16 * c);
}

// A tile as stored in shared memory (`raw`) into fp32 times `scale`, row
// stride `lds`.  16-byte reads; one never crosses a row since D is a
// multiple of 16 / sizeof(KT).
template <typename KT, int D>
__device__ __forceinline__ void dequant_tile(const uint8_t* raw, float* dst, int lds,
                                             float scale) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(KT));
  constexpr int kChunks = kTile * D / kVec;
  const uint4* raw4 = reinterpret_cast<const uint4*>(raw);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const uint4 bits = raw4[c];
    const KT* vals = reinterpret_cast<const KT*>(&bits);
    const int r = (c * kVec) / D, col = (c * kVec) % D;
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * lds + col + i] = to_float(vals[i]) * scale;
  }
}

template <typename KT, int D>
constexpr size_t smem_bytes() {
  return 4 * static_cast<size_t>(tile_bytes<KT, D>()) +
         sizeof(float) *
             (kTile * (D + 1) + kTile * D + kMaxG * D + kMaxG * kTile + 3 * kMaxG);
}

// Partials of chunk blockIdx.y of row blockIdx.x: keys [c0, min(c0 + chunk,
// S)), c0 = blockIdx.y * chunk.  Outputs (row, split) of (B, n_split, G, D)
// and (B, n_split, G).
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
flash_chunk_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const float* __restrict__ scales,
                   const int* __restrict__ seg_len, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int G, int S,
                   int blk, int chunk, float sm_scale) {
  constexpr int LDK = D + 1;             // padded: a warp reads one column of 32 rows
  constexpr int kGroups = kThreads / D;  // threads per column of d
  // heads per thread in the P V product, rounded up: kGroups * kHeads >= kMaxG
  constexpr int kHeads = (kMaxG + kGroups - 1) / kGroups;
  constexpr int kBytes = tile_bytes<KT, D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Kraw = smem_raw;             // 2 stages of a K tile as stored
  uint8_t* Vraw = smem_raw + 2 * kBytes;  // 2 stages of a V tile as stored
  float* Ks = reinterpret_cast<float*>(smem_raw + 4 * kBytes);  // kTile x LDK
  float* Vs = Ks + kTile * LDK;       // kTile x D
  float* Qs = Vs + kTile * D;         // G x D
  float* Ps = Qs + kMaxG * D;         // G x kTile: scores, then probabilities
  float* Ms = Ps + kMaxG * kTile;     // running max per head
  float* Ls = Ms + kMaxG;             // running sum per head
  float* As = Ls + kMaxG;             // rescale factor of the current tile

  const long long row = blockIdx.x;
  const long long part = row * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const QT* qb = q + row * G * D;
  const KT* kb = k + row * S * D;
  const KT* vb = v + row * S * D;
  const float* sb = scales ? scales + row * (S / blk) * 2 : nullptr;
  const int len = seg_len[row];
  const int c0 = blockIdx.y * chunk, c1 = min(c0 + chunk, S);

  // Tiles of the chunk to read: all of them when no key of the segment is
  // valid; none when the chunk lies wholly past a positive seg_len; else up
  // to the tile that holds the last valid key.
  const int t0 = c0 / kTile;
  int t1 = c1 / kTile;
  if (len > 0) t1 = len <= c0 ? t0 : min(t1, (len + kTile - 1) / kTile);
  const int n_used = max(t1 - t0, 0);
  if (n_used > 0) {
    issue_tile<KT, D>(kb + static_cast<long long>(t0) * kTile * D, Kraw);
    issue_tile<KT, D>(vb + static_cast<long long>(t0) * kTile * D, Vraw);
  }
  cp_async_commit();

  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_float(qb[i]);
  if (tid < kMaxG) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  // thread tid owns column col of heads g0, g0 + kGroups, ...; threads at
  // or past kGroups * D (when D does not divide kThreads) own none
  const int col = tid % D, g0 = tid / D;
  const bool owns = tid < kGroups * D;
  float acc[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) acc[h] = 0.f;

  for (int i = 0; i < n_used; ++i) {
    const int stage = i & 1;
    const int key0 = (t0 + i) * kTile;
    if (i + 1 < n_used) {  // the next tile into the other stage, in flight meanwhile
      const long long nxt = static_cast<long long>(key0 + kTile) * D;
      issue_tile<KT, D>(kb + nxt, Kraw + (stage ^ 1) * kBytes);
      issue_tile<KT, D>(vb + nxt, Vraw + (stage ^ 1) * kBytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every thread

    float k_sc = 1.f, v_sc = 1.f;
    if (sb) {
      k_sc = sb[2 * (key0 / blk)];
      v_sc = sb[2 * (key0 / blk) + 1];
    }
    dequant_tile<KT, D>(Kraw + stage * kBytes, Ks, LDK, k_sc);
    dequant_tile<KT, D>(Vraw + stage * kBytes, Vs, D, v_sc);
    __syncthreads();

    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, j = e % kTile;
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

    // heads past G are skipped with a branch that is uniform over the block
    // (h kGroups >= G), not predicated off head by head; a thread that owns
    // no column skips the product
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      if (!owns || h * kGroups >= G) break;
      const int g = g0 + h * kGroups;
      if (g >= G) continue;
      const float* pr = Ps + g * kTile;
      float a = acc[h] * As[g];
#pragma unroll 16
      for (int j = 0; j < kTile; ++j) a = fmaf(pr[j], Vs[j * D + col], a);
      acc[h] = a;
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, Ps and this stage
  }

#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    const int g = g0 + h * kGroups;
    if (owns && g < G) acc_out[(part * G + g) * D + col] = acc[h];
  }
  if (tid < G) {
    m_out[part * G + tid] = Ms[tid];
    l_out[part * G + tid] = Ls[tid];
  }
}

// The segment's (acc, m, l) of row blockIdx.x from its n_split chunk
// partials: m = max m_c, acc = sum acc_c exp(m_c - m), l = sum l_c exp(m_c -
// m), summed in chunk order.
__global__ void __launch_bounds__(kCombineThreads)
combine_chunks_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
                      const float* __restrict__ ws_l, float* __restrict__ acc,
                      float* __restrict__ m, float* __restrict__ l, int G, int D,
                      int n_split) {
  const long long row = blockIdx.x;
  const float* rm = ws_m + row * n_split * G;
  for (int e = threadIdx.x; e < G * (D + 1); e += kCombineThreads) {
    const int g = e % G, c = e / G;  // c == D: the head's m and l
    float mt = rm[g];
    for (int s = 1; s < n_split; ++s) mt = fmaxf(mt, rm[s * G + g]);
    float sum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(rm[s * G + g] - mt);
      const long long ps = (row * n_split + s) * G + g;
      sum += (c < D ? ws_acc[ps * D + c] : ws_l[ps]) * w;
    }
    if (c < D) {
      acc[(row * G + g) * D + c] = sum;
    } else {
      m[row * G + g] = mt;
      l[row * G + g] = sum;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float* scales;
  const int* seg_len;
  float *acc, *m, *l, *ws_acc, *ws_m, *ws_l;
  int batch, g, s, blk, chunk, n_split;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D>
cudaError_t launch(const Args& a) {
  auto kernel = flash_chunk_kernel<QT, KT, D>;
  constexpr size_t smem = smem_bytes<KT, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool split = a.n_split > 1;
  kernel<<<dim3(a.batch, a.n_split), kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      a.scales, a.seg_len, split ? a.ws_acc : a.acc, split ? a.ws_m : a.m,
      split ? a.ws_l : a.l, a.g, a.s, a.blk, a.chunk, a.sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess || !split) return err;
  combine_chunks_kernel<<<a.batch, kCombineThreads, 0, a.stream>>>(
      a.ws_acc, a.ws_m, a.ws_l, a.acc, a.m, a.l, a.g, D, a.n_split);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_d(const Args& a, int d) {
  switch (d) {
    case 64: return launch<QT, KT, 64>(a);
    case 80: return launch<QT, KT, 80>(a);
    default: return launch<QT, KT, 128>(a);
  }
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
// (batch, g, d), m and l (batch, g) fp32.  chunk: keys per block, a multiple
// of blk; with n_split = ceil(s / chunk) > 1 chunks per row the partials go
// to the workspace ws_acc (batch, n_split, g, d), ws_m and ws_l (batch,
// n_split, g) fp32 and a second launch combines them (else the workspace
// may be null).  Requires 1 <= g <= 16, d in {64, 80, 128}, blk % 64 == 0 and
// s % blk == 0.
extern "C" int mp_attention_launch(const void* q, const void* k, const void* v,
                                   const void* scales, const void* seg_len, void* acc,
                                   void* m, void* l, void* ws_acc, void* ws_m, void* ws_l,
                                   int batch, int g, int d, int s, int blk, int chunk,
                                   float sm_scale, int q_bf16, int kv_dtype, void* stream) {
  if (batch < 1 || g < 1 || g > kMaxG || (d != 64 && d != 80 && d != 128) || blk < kTile ||
      blk % kTile || s < 0 || s % blk || chunk < blk || chunk % blk || kv_dtype < 0 ||
      kv_dtype > 2 || (kv_dtype == 2) != (scales != nullptr))
    return cudaErrorInvalidValue;
  const int n_split = s > chunk ? (s + chunk - 1) / chunk : 1;
  if (n_split > 65535 || (n_split > 1 && (!ws_acc || !ws_m || !ws_l)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(scales), static_cast<const int*>(seg_len),
               static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
               static_cast<float*>(ws_acc), static_cast<float*>(ws_m),
               static_cast<float*>(ws_l), batch, g, s, blk, chunk, n_split, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, d, kv_dtype) : launch_kv<float>(a, d, kv_dtype);
}
