// Cholesky factor (lower) of a batch of SPD tiles, written for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/blocked_potrf/blocked_potrf.py: _potrf_kernel /
//   potrf_pallas.
//
// What bounds it on the H100: latency and operations.  The panel engine
// factors one fp32 1024 x 1024 tile per step, on its critical path.  The
// work is nb^3 / 3 flops (3.6e8 at nb = 1024): ~5 us at the card's 67
// TFLOP/s fp32 peak, but ~0.7 ms on one SM, which is where a one-block-per-
// tile kernel leaves it.  Spread over the SMs, what is left is the chain of
// dependent steps: each panel's diagonal block must be factored before its
// rows can be solved, and they must be solved before the trailing update.
// The 64 column steps of each panel's sweep are that chain's longest part
// (kernels/blocked_potrf/phase_profile.py measures each phase).
//
// What the design does about it: a blocked right-looking factorization in
// panels of P = 64 columns whose phases use many blocks, in ONE cooperative
// launch (cudaLaunchCooperativeKernel; the grid is at most the blocks that
// can be resident at once, from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// and cooperative_groups::this_grid().sync() separates the phases).  Chosen
// over a chain of launches per panel, whose ~3 launches x 16 panels would
// each add a launch latency, and over a look-ahead, which needs the same
// barriers plus a second schedule.  A hand-rolled global barrier is not used:
// it can deadlock when not every block is resident.  Per panel k0:
//   1. every block that has rows to solve sweeps the panel for its 64 rows:
//      the P x P diagonal block (each block factors it itself, with the
//      same arithmetic, so the same result) and its rows of X L11^T = A21,
//      in one sweep of 64 dependent column steps by 128 threads, each
//      holding one row in registers, with one named barrier per step (scale
//      by rsqrt(max(d, 1e-30)), rank-1 update, as the TPU kernel).  The loop
//      stays rolled: this code runs once per panel, and fully unrolled it
//      was bound by instruction fetch.  Block 0 records the first bad
//      pivot, and writes L11 once no block reads A11 any more.  Redundant
//      diagonal factors save a grid barrier per panel;
//   2. grid barrier;
//   3. the trailing lower triangle takes A22 -= L21 L21^T, one 64 x 64
//      output tile per block (4 x 4 outputs per thread from the two row
//      panels staged in shared memory), IEEE fp32 FMAs, no TF32;
//   4. grid barrier.
// So 2 barriers per panel, 32 at nb = 1024, one device launch per call.  The
// tile is factored in place in the output buffer (4 MiB at nb = 1024, which
// stays in the 50 MB L2); every read of it goes through __ldcg (L2, not the
// SM's L1), since other blocks wrote it before the barrier.  A batch of
// large tiles is factored one tile after the other by the same grid.
//
// A tile with nb <= 128 (64 KiB) takes the one-block path: the tile is
// copied into shared memory and factored there by panels of W = 32, one
// block per tile of the batch.
//
// Unlike the TPU kernel, which clamps the pivot and never reports a failure,
// a non-positive (or NaN) pivot sets info[b] to its 1-based column, and the
// whole tile is then written as NaN, as a failed LAPACK factorization is
// turned into NaN by the plain version.  On the grid path the flag is set by
// block 0 in phase 1 and read by the others only after the last barrier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int W = 32;             // panel width of the one-block path
constexpr int LDP = W + 1;        // padded row stride of panels in shared memory
constexpr int kSmemTileMax = 128; // nb up to this: the one-block path
constexpr int kMaxNb = 1024;
constexpr int P = 64;             // panel width (and output tile) of the grid path
constexpr int LDT = P + 1;        // padded row stride of 64-wide tiles

// ----------------------------- one-block path -----------------------------

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

  float* work = panel + nb * LDP;
  for (int e = tid; e < nb * nb; e += kThreads) {
    const int r = e / nb, c = e % nb;
    work[e] = c <= r ? src[e] : 0.f;
  }
  __syncthreads();
  factor_tile(work, nb, nb, diag, inv, panel, &s_info);
  __syncthreads();
  const bool failed = s_info != 0;
  for (int e = tid; e < nb * nb; e += kThreads)
    dst[e] = failed ? __int_as_float(0x7fc00000) : work[e];
  if (tid == 0) info[blockIdx.x] = s_info;
}

// ------------------------------- grid path --------------------------------

// Rows [r0, r0 + P) and columns [k0, k0 + cols) of A into the P x LDT shared
// buffer S, zero past row nb and column k0 + cols: all of a thread's loads
// before its stores (a load behind a store to shared memory waits for it).
__device__ __forceinline__ void stage_rows(const float* A, int lda, int nb, int r0, int k0,
                                           int cols, float* S) {
  constexpr int kPer = P * P / kThreads;
  float t[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / P, c = e % P;
    t[i] = r0 + r < nb && c < cols ? __ldcg(A + (r0 + r) * lda + k0 + c) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    S[(e / P) * LDT + e % P] = t[i];
  }
}

// Barrier of the 2 P threads that sweep a panel (named barrier 1; the rest
// of the block waits at __syncthreads).
__device__ __forceinline__ void panel_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(2 * P) : "memory");
}

// Factor the panel at column k0 for the rows [r0, r0 + P) below its w x w
// diagonal block: L11 of the diagonal block into Ls (row stride LDT, 0 above
// the diagonal) and the rows' X = A21 L11^-T into Xs (rows past nb are zero
// and unused).  One sweep of w dependent column steps does both: thread
// t < P holds row k0 + t of the diagonal block (zero past w), thread P + t
// row r0 + t, each in registers.  Step j: the diagonal rows publish their
// column-j entries to a double-buffered shared vector, one named barrier,
// then every thread reads the column, takes d = a_jj, scales its own entry,
// l = a_tj rsqrt(max(d, 1e-30)) (for a row below: x_tj = a_tj / l_jj), and
// updates its row, a_tc -= (l_t rsqrt(max(d, 1e-30))) a_cj: the TPU
// kernel's rank-1 update l_t l_c with one rounding elsewhere.  l_jj =
// max(d, 0) rsqrt(max(d, 1e-30)), within a few ulp of sqrt(max(d, 0)): an
// IEEE sqrtf, with its slow-path branch, cost a third of a step.  The loop
// over steps is rolled, since straight-line code run once per panel is
// bound by instruction fetch: a row's registers rotate, x[k] holding column
// j + k at step j, and a step reads the published column with 16-byte loads
// (shifted, so that it starts aligned), all issued before the pivot's
// rsqrt, and updates all the registers without branches.  The entries of
// columns past w and those above the diagonal take garbage that no lower
// entry reads, and are written as 0.  Returns, in every thread, the 1-based
// column (within the block) of the first non-positive or NaN pivot, or 0.
__device__ int factor_panel(const float* A, int lda, int nb, int k0, int w, int r0,
                            float* Ls, float* Xs, float* colbuf, int* s_bad) {
  stage_rows(A, lda, k0 + w, k0, k0, w, Ls);
  stage_rows(A, lda, nb, r0, k0, P, Xs);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < 2 * P) {
    const bool diag = tid < P;
    const int t = diag ? tid : tid - P;
    float* S = diag ? Ls : Xs;
    float x[P];
#pragma unroll
    for (int c = 0; c < P; ++c) x[c] = S[t * LDT + c];
    int bad = 0;
    for (int j = 0; j < w; ++j) {
      float* col = colbuf + (j & 1) * P;  // col[k] = a_{j + k, j}
      if (diag && t >= j) col[t - j] = x[0];
      panel_barrier();
      float lc[P];
#pragma unroll
      for (int g = 0; g < P / 4; ++g) {
        const float4 v = reinterpret_cast<const float4*>(col)[g];
        lc[4 * g] = v.x;
        lc[4 * g + 1] = v.y;
        lc[4 * g + 2] = v.z;
        lc[4 * g + 3] = v.w;
      }
      const float d = lc[0];
      const float iv = rsqrtf(fmaxf(d, 1e-30f));
      if (!(d > 0.f) && bad == 0) bad = j + 1;
      const float l = x[0] * iv;
      S[t * LDT + j] = !diag || t > j ? l : (t == j ? fmaxf(d, 0.f) * iv : 0.f);
      const float sl = l * iv;
#pragma unroll
      for (int k = 1; k < P; ++k) x[k - 1] = x[k] - sl * lc[k];
    }
    if (tid == 0) *s_bad = bad;
  }
  __syncthreads();
  return *s_bad;
}

// A[tile (ti, tj) of the trailing matrix at (k1, k1)] -= L21_i L21_j^T, where
// L21 is the P-wide panel at column k0 = k1 - P; lower triangle only on a
// diagonal tile.
__device__ void update_tile(float* A, int lda, int nb, int k0, int ti, int tj, float* As,
                            float* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k1 = k0 + P;
  const int ri = k1 + ti * P, rj = k1 + tj * P;
  stage_rows(A, lda, nb, ri, k0, P, As);
  if (ti != tj) stage_rows(A, lda, nb, rj, k0, P, Bs);
  // the tile's current values, loaded before the product so that their
  // latency overlaps it
  float old[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool in = ri + r < nb && rj + c < nb && (ti != tj || c <= r);
      old[i][j] = in ? __ldcg(A + (ri + r) * lda + rj + c) : 0.f;
    }
  }
  __syncthreads();
  const float* B = ti == tj ? As : Bs;
  float acc[4][4] = {};
#pragma unroll 8
  for (int s = 0; s < P; ++s) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = As[(ty + 16 * i) * LDT + s];
      y[i] = B[(tx + 16 * i) * LDT + s];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (ri + r < nb && rj + c < nb && (ti != tj || c <= r))
        A[(ri + r) * lda + rj + c] = old[i][j] - acc[i][j];
    }
  }
  __syncthreads();  // As, Bs are reused by the block's next tile
}

__global__ void __launch_bounds__(kThreads)
potrf_grid_kernel(const float* __restrict__ a, float* __restrict__ out,
                  int* __restrict__ info, int batch, int nb) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float buf0[P * LDT];  // L11, then the update's first row panel
  __shared__ float buf1[P * LDT];  // the rows being solved, then the second row panel
  __shared__ __align__(16) float colbuf[2 * P];
  __shared__ int s_bad;
  __shared__ int s_info;  // block 0: the current tile's info
  const int tid = threadIdx.x;
  const long long n2 = static_cast<long long>(nb) * nb;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  for (int b = 0; b < batch; ++b) {
    const float* src = a + b * n2;
    float* A = out + b * n2;
    for (long long e = blockIdx.x * kThreads + tid; e < n2; e += gstride) {
      const int r = static_cast<int>(e / nb), c = static_cast<int>(e % nb);
      A[e] = c <= r ? src[e] : 0.f;
    }
    if (tid == 0) s_info = 0;
    grid.sync();
    for (int k0 = 0; k0 < nb; k0 += P) {
      const int w = min(P, nb - k0);
      const int m = nb - k0 - w;           // rows below the diagonal block
      const int n_chunks = (m + P - 1) / P;  // 64-row chunks of the panel solve
      for (int ch = blockIdx.x; ch < max(n_chunks, 1); ch += gridDim.x) {
        const int r0 = k0 + P + ch * P;
        const int bad = factor_panel(A, nb, nb, k0, w, r0, buf0, buf1, colbuf, &s_bad);
        if (blockIdx.x == 0 && tid == 0 && bad && s_info == 0) s_info = k0 + bad;
        for (int e = tid; e < P * P; e += kThreads) {
          const int r = e / P, c = e % P;
          if (r0 + r < nb) A[(r0 + r) * nb + k0 + c] = buf1[r * LDT + c];
        }
        __syncthreads();  // buf1 is restaged by the block's next chunk
      }
      // Block 0 writes L11 over A11 once no block reads A11 any more: after
      // the barrier, or at once in the last panel, which only block 0 factors.
      if (m > 0) grid.sync();
      if (blockIdx.x == 0) {
        for (int e = tid; e < w * w; e += kThreads) {
          const int r = e / w, c = e % w;
          A[(k0 + r) * nb + k0 + c] = buf0[r * LDT + c];
        }
        __syncthreads();  // buf0 is restaged by the update below
      }
      if (m <= 0) break;
      const int n_tiles = n_chunks * (n_chunks + 1) / 2;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while (ti * (ti + 1) / 2 > t) --ti;
        while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
        update_tile(A, nb, nb, k0, ti, t - ti * (ti + 1) / 2, buf0, buf1);
      }
      grid.sync();
    }
    if (blockIdx.x == 0 && tid == 0) info[b] = s_info;
    grid.sync();  // info[b] is read by every block only after this barrier
    if (__ldcg(info + b) != 0) {
      for (long long e = blockIdx.x * kThreads + tid; e < n2; e += gstride)
        A[e] = __int_as_float(0x7fc00000);
    }
    grid.sync();  // the next tile reuses the blocks' shared memory and flags
  }
}

struct GridLimit {
  int device = -1;
  int blocks = 0;
};

// Blocks of potrf_grid_kernel that can be resident at once on the current
// device (cached per device), or 0 if it cannot take a cooperative launch.
cudaError_t coresident_blocks(int* blocks) {
  static GridLimit cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  GridLimit& c = cache[dev % 64];
  if (c.device != dev) {
    int sms = 0, coop = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, potrf_grid_kernel,
                                                             kThreads, 0)))
      return err;
    c.blocks = coop ? sms * per_sm : 0;
    c.device = dev;
  }
  *blocks = c.blocks;
  return cudaSuccess;
}

}  // namespace

// a, out: (batch, nb, nb) fp32, contiguous; info: (batch,) int32.  max_blocks:
// the most blocks any phase of the grid path can use (the launch plan of
// kernels/blocked_potrf/blocked_potrf.py); the grid is that, capped at the
// blocks that can be resident at once.  Unused for nb <= 128.
extern "C" int blocked_potrf_launch(const void* a, void* out, void* info, int batch, int nb,
                                    int max_blocks, void* stream) {
  if (nb < 1 || nb > kMaxNb || batch < 1 || max_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb <= kSmemTileMax) {
    const int bytes = (W * LDP + W + nb * LDP + nb * nb) * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        blocked_potrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    blocked_potrf_kernel<<<batch, kThreads, bytes, st>>>(
        static_cast<const float*>(a), static_cast<float*>(out), static_cast<int*>(info), nb);
    return cudaGetLastError();
  }
  int resident = 0;
  cudaError_t err = coresident_blocks(&resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = max_blocks < resident ? max_blocks : resident;
  const float* a_ptr = static_cast<const float*>(a);
  float* out_ptr = static_cast<float*>(out);
  int* info_ptr = static_cast<int*>(info);
  void* args[] = {&a_ptr, &out_ptr, &info_ptr, &batch, &nb};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(potrf_grid_kernel),
                                    dim3(grid), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
