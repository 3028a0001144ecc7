// Cholesky factor (lower) of a batch of SPD tiles, one thread block per tile,
// written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/blocked_potrf/blocked_potrf.py: _potrf_kernel /
//   potrf_pallas.
//
// What bounds it on the H100: operations on one SM.  The panel engine
// factors one nb x nb diagonal tile per step, so a launch has one block and
// the other 131 SMs idle; nb^3/6 fp32 FMAs (1.8e8 at nb = 1024) on one SM's
// 128 FMA/clock are ~0.8 ms, and each step's POTRF sits on the critical path.
//
// What the design does about it: a right-looking sweep blocked by panels of
// W = 32 columns, so the trailing matrix is read and written once per panel
// rather than once per column.  For each panel:
//   1. the W x W diagonal block is factored in shared memory column by
//      column, like the TPU kernel: rsqrt(max(d, 1e-30)) scales the column,
//      l_jj = sqrt(max(d, 0)), then a rank-1 update of the block;
//   2. the rows below are solved against it (X L11^T = A21) in shared memory,
//      one row per thread, with coalesced loads and stores around it;
//   3. the trailing lower triangle takes A22 -= L21 L21^T from the panel held
//      in shared memory, 4 x 4 outputs per thread.
// A tile with nb <= 128 (64 KiB) is copied into shared memory and factored
// there; a larger one (up to 1024, 4 MiB, which stays in L2) is factored in
// place in the output buffer, with __syncthreads between the phases.
//
// Unlike the TPU kernel, which clamps the pivot and never reports a failure,
// a non-positive (or NaN) pivot sets info[b] to its 1-based column, and the
// whole tile is then written as NaN, as a failed LAPACK factorization is
// turned into NaN by the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int W = 32;             // panel width
constexpr int LDP = W + 1;        // padded row stride of panels in shared memory
constexpr int kSmemTileMax = 128; // nb up to this: the whole tile in shared memory
constexpr int kMaxNb = 1024;

__device__ void factor_tile(float* A, int lda, int nb, float* diag, float* inv,
                            float* panel, int* s_info) {
  const int tid = threadIdx.x;
  for (int k0 = 0; k0 < nb; k0 += W) {
    const int w = min(W, nb - k0);
    // 1. diagonal block: load, then an unblocked right-looking sweep
    for (int e = tid; e < w * w; e += kThreads) {
      const int r = e / w, c = e % w;
      diag[r * LDP + c] = A[(k0 + r) * lda + k0 + c];
    }
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      const float d = diag[j * LDP + j];
      const float iv = rsqrtf(fmaxf(d, 1e-30f));
      __syncthreads();  // every thread has read d before it is overwritten
      if (tid == 0) {
        if (!(d > 0.f) && *s_info == 0) *s_info = k0 + j + 1;
        diag[j * LDP + j] = sqrtf(fmaxf(d, 0.f));
        inv[j] = iv;
      }
      for (int r = j + 1 + tid; r < w; r += kThreads) diag[r * LDP + j] *= iv;
      __syncthreads();
      const int m = w - j - 1;
      for (int e = tid; e < m * m; e += kThreads) {
        const int r = j + 1 + e / m, c = j + 1 + e % m;
        if (c <= r) diag[r * LDP + c] -= diag[r * LDP + j] * diag[c * LDP + j];
      }
      __syncthreads();
    }
    for (int e = tid; e < w * w; e += kThreads) {
      const int r = e / w, c = e % w;
      A[(k0 + r) * lda + k0 + c] = c <= r ? diag[r * LDP + c] : 0.f;
    }
    const int m = nb - k0 - w;  // rows below the diagonal block (w == W if m > 0)
    if (m <= 0) break;

    // 2. panel solve X L11^T = A21, one row per thread, staged in shared memory
    float* a21 = A + (k0 + w) * lda + k0;
    for (int e = tid; e < m * W; e += kThreads) {
      const int r = e / W, c = e % W;
      panel[r * LDP + c] = a21[r * lda + c];
    }
    __syncthreads();
    for (int r = tid; r < m; r += kThreads) {
      float x[W];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        float s = panel[r * LDP + c];
#pragma unroll
        for (int q = 0; q < c; ++q) s -= x[q] * diag[c * LDP + q];
        x[c] = s * inv[c];
      }
#pragma unroll
      for (int c = 0; c < W; ++c) panel[r * LDP + c] = x[c];
    }
    __syncthreads();
    for (int e = tid; e < m * W; e += kThreads) {
      const int r = e / W, c = e % W;
      a21[r * lda + c] = panel[r * LDP + c];
    }

    // 3. trailing update A22 -= L21 L21^T on the lower triangle, 64 x 64
    //    blocks, each thread 4 x 4 outputs (rows ty + 16 i, cols tx + 16 j)
    float* a22 = A + (k0 + w) * lda + k0 + w;
    const int tx = tid % 16, ty = tid / 16;
    const int nblk = (m + 63) / 64;
    for (int bi = 0; bi < nblk; ++bi) {
      for (int bj = 0; bj <= bi; ++bj) {
        float acc[4][4] = {};
#pragma unroll 4
        for (int q = 0; q < W; ++q) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = bi * 64 + ty + 16 * i;
            a[i] = r < m ? panel[r * LDP + q] : 0.f;
            const int c = bj * 64 + tx + 16 * i;
            b[i] = c < m ? panel[c * LDP + q] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = bi * 64 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = bj * 64 + tx + 16 * j;
            if (r < m && c <= r) a22[r * lda + c] -= acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
blocked_potrf_kernel(const float* __restrict__ a, float* __restrict__ out,
                     int* __restrict__ info, int nb) {
  extern __shared__ float smem[];
  __shared__ int s_info;
  float* diag = smem;
  float* inv = diag + W * LDP;
  float* panel = inv + W;
  const long long off = static_cast<long long>(blockIdx.x) * nb * nb;
  const float* src = a + off;
  float* dst = out + off;
  const int tid = threadIdx.x;
  if (tid == 0) s_info = 0;

  const bool in_smem = nb <= kSmemTileMax;
  float* work = in_smem ? panel + nb * LDP : dst;
  for (int e = tid; e < nb * nb; e += kThreads) {
    const int r = e / nb, c = e % nb;
    work[e] = c <= r ? src[e] : 0.f;
  }
  __syncthreads();
  factor_tile(work, nb, nb, diag, inv, panel, &s_info);
  __syncthreads();
  const bool failed = s_info != 0;
  if (in_smem || failed) {
    for (int e = tid; e < nb * nb; e += kThreads) dst[e] = failed ? __int_as_float(0x7fc00000) : work[e];
  }
  if (tid == 0) info[blockIdx.x] = s_info;
}

}  // namespace

// a, out: (batch, nb, nb) fp32, contiguous; info: (batch,) int32.
extern "C" int blocked_potrf_launch(const void* a, void* out, void* info, int batch, int nb,
                                    void* stream) {
  if (nb < 1 || nb > kMaxNb || batch < 1) return cudaErrorInvalidValue;
  int smem_floats = W * LDP + W + nb * LDP;
  if (nb <= kSmemTileMax) smem_floats += nb * nb;
  const int bytes = smem_floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      blocked_potrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  blocked_potrf_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), static_cast<int*>(info), nb);
  return cudaGetLastError();
}
