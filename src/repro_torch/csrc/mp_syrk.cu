// Banded mixed-precision SYRK U = P P^T, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mp_gemm/mp_gemm.py: _mp_syrk_kernel / mp_syrk_pallas.
//
// Precision routing (the paper's Algorithm 1): an output element (r, c) is
// in the band when |r / tile - c / tile| < band_blocks.  In-band elements
// are IEEE fp32 dot products (FMA, no TF32).  Off-band elements take bf16
// operands, sum their products in fp32, round that sum to bf16 at every
// `round_k` columns of K, and add the rounded partial sums into the fp32
// output.  The TPU kernel tied the classification unit and the rounding unit
// to its own block sizes (bm, bk); here `tile` and `round_k` are arguments and
// the kernel's blocks (BM x BM outputs by BK = 32 columns) must divide them.
//
// What bounds it on the H100: operations.  On the panel path the in-band
// part is fp32 work on the CUDA cores (67 TFLOP/s) and the off-band part is
// bf16 tensor-core work (989 TFLOP/s), so the band bounds the step although
// it holds the smaller share of the products.
//
// What the design does about it: two kernels per call, each over only the
// blocks of its class.
//   * band: a classic SIMT SGEMM, BM x BM outputs per block of 256 threads,
//     each thread (BM/16)^2 outputs in registers, K staged through shared
//     memory transposed so that each k step reads float4s; the grid covers
//     only the block columns within the band of each block row.
//   * off-band: bf16 WMMA (mma.sync) 16x16x16 fragments with fp32
//     accumulators, operands converted to bf16 while they are staged in
//     shared memory; a second set of fragments holds the sum of the
//     bf16-rounded partials.  Blocks inside the band exit at once.
// Both write the full square, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int BK = 32;

__device__ __forceinline__ bool in_band(int row0, int col0, int tile, int band_blocks) {
  const int d = row0 / tile - col0 / tile;
  return (d < 0 ? -d : d) < band_blocks;
}

// ---- in-band blocks: fp32 SIMT -------------------------------------------
template <int BM>
__global__ void __launch_bounds__(kThreads)
syrk_band_kernel(const float* __restrict__ p, float* __restrict__ out, int m, int kdim,
                 int tile, int band_blocks) {
  constexpr int TM = BM / 16;  // outputs per thread along each axis
  constexpr int G = TM / 4;    // groups of 4 rows (cols) per thread, 64 apart
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BM + 4];

  const int row0 = blockIdx.y * BM;
  // block columns of this block row's band: [first tile, last tile] of the band
  const int row_tile = row0 / tile;
  const int n_tiles = m / tile;
  const int first = max(0, row_tile - band_blocks + 1) * tile;
  const int last = min(n_tiles, row_tile + band_blocks) * tile;
  const int col0 = first + blockIdx.x * BM;
  if (col0 >= last) return;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TM] = {};

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    // stage P[row0 : row0 + BM, k0 : k0 + BK] and P[col0 : ...] transposed
    for (int idx = tid; idx < BM * (BK / 4); idx += kThreads) {
      const int r = idx / (BK / 4), c4 = (idx % (BK / 4)) * 4;
      const float4 va = *reinterpret_cast<const float4*>(
          p + static_cast<long long>(row0 + r) * kdim + k0 + c4);
      const float4 vb = *reinterpret_cast<const float4*>(
          p + static_cast<long long>(col0 + r) * kdim + k0 + c4);
      As[c4 + 0][r] = va.x; As[c4 + 1][r] = va.y; As[c4 + 2][r] = va.z; As[c4 + 3][r] = va.w;
      Bs[c4 + 0][r] = vb.x; Bs[c4 + 1][r] = vb.y; Bs[c4 + 2][r] = vb.z; Bs[c4 + 3][r] = vb.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TM];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(&As[kk][g * 64 + ty * 4]);
        const float4 vb = *reinterpret_cast<const float4*>(&Bs[kk][g * 64 + tx * 4]);
        a[g * 4 + 0] = va.x; a[g * 4 + 1] = va.y; a[g * 4 + 2] = va.z; a[g * 4 + 3] = va.w;
        b[g * 4 + 0] = vb.x; b[g * 4 + 1] = vb.y; b[g * 4 + 2] = vb.z; b[g * 4 + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = col0 + g * 64 + tx * 4;
      *reinterpret_cast<float4*>(out + static_cast<long long>(r) * m + c) =
          make_float4(acc[i][g * 4 + 0], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                      acc[i][g * 4 + 3]);
    }
  }
}

// ---- off-band blocks: bf16 tensor cores, fp32 accumulate -----------------
template <int BM>
__global__ void __launch_bounds__(kThreads)
syrk_offband_kernel(const float* __restrict__ p, float* __restrict__ out, int m, int kdim,
                    int tile, int round_k, int band_blocks) {
  constexpr int LDS = BK + 8;      // bf16 row stride in shared memory (80 B)
  constexpr int WARPS_M = 4, WARPS_N = 2;
  constexpr int FM = BM / (16 * WARPS_M);  // fragments per warp along rows
  constexpr int FN = BM / (16 * WARPS_N);  // and along columns
  __shared__ __align__(32) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BM][LDS];

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  if (in_band(row0, col0, tile, band_blocks)) return;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN], total[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(total[i][j], 0.f);
    }

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int idx = tid; idx < BM * (BK / 4); idx += kThreads) {
      const int r = idx / (BK / 4), c4 = (idx % (BK / 4)) * 4;
      const float4 va = *reinterpret_cast<const float4*>(
          p + static_cast<long long>(row0 + r) * kdim + k0 + c4);
      const float4 vb = *reinterpret_cast<const float4*>(
          p + static_cast<long long>(col0 + r) * kdim + k0 + c4);
      As[r][c4 + 0] = __float2bfloat16_rn(va.x); As[r][c4 + 1] = __float2bfloat16_rn(va.y);
      As[r][c4 + 2] = __float2bfloat16_rn(va.z); As[r][c4 + 3] = __float2bfloat16_rn(va.w);
      Bs[r][c4 + 0] = __float2bfloat16_rn(vb.x); Bs[r][c4 + 1] = __float2bfloat16_rn(vb.y);
      Bs[r][c4 + 2] = __float2bfloat16_rn(vb.z); Bs[r][c4 + 3] = __float2bfloat16_rn(vb.w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      // B = P^T: element (k, c) is P[c][k], i.e. the staged rows read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * FM + i) * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[(wn * FN + j) * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if ((k0 + BK) % round_k == 0) {  // the lo store of a round_k partial sum
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            total[i][j].x[e] += __bfloat162float(__float2bfloat16_rn(acc[i][j].x[e]));
          wmma::fill_fragment(acc[i][j], 0.f);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const long long r = row0 + (wm * FM + i) * 16;
      const int c = col0 + (wn * FN + j) * 16;
      wmma::store_matrix_sync(out + r * m + c, total[i][j], m, wmma::mem_row_major);
    }
}

template <int BM>
cudaError_t launch(const float* p, float* out, int m, int kdim, int tile, int round_k,
                   int band_blocks, int lo_bf16, cudaStream_t stream) {
  const int n_tiles = m / tile;
  if (!lo_bf16) band_blocks = n_tiles;  // lo == hi: every block takes the fp32 path
  const int band_cols = min(2 * band_blocks - 1, n_tiles) * tile / BM;
  syrk_band_kernel<BM><<<dim3(band_cols, m / BM), kThreads, 0, stream>>>(
      p, out, m, kdim, tile, band_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || band_blocks >= n_tiles) return err;
  syrk_offband_kernel<BM><<<dim3(m / BM, m / BM), kThreads, 0, stream>>>(
      p, out, m, kdim, tile, round_k, band_blocks);
  return cudaGetLastError();
}

}  // namespace

// p: (m, kdim) fp32 contiguous; out: (m, m) fp32 contiguous.
// Requires tile % 64 == 0, m % tile == 0, round_k % 32 == 0, kdim % round_k == 0.
extern "C" int mp_syrk_launch(const void* p, void* out, int m, int kdim, int tile,
                              int round_k, int band_blocks, int lo_bf16, void* stream) {
  if (tile % 64 || m % tile || round_k % BK || kdim % round_k || band_blocks < 1)
    return cudaErrorInvalidValue;
  const float* pp = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile % 128 == 0) return launch<128>(pp, o, m, kdim, tile, round_k, band_blocks, lo_bf16, s);
  return launch<64>(pp, o, m, kdim, tile, round_k, band_blocks, lo_bf16, s);
}
