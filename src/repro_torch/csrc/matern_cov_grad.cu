// The backward in theta of the Matern covariance kernels of
// csrc/matern_cov.cu (matern_cov_grad_kernel), written for sm_90a: the
// gradient in (theta1, theta2) of sum G * C over one tile, a zip stack of
// tiles or the lower tiles of the off-band storage, Euclidean or
// haversine.  It replaces the derivative XLA takes of
// src/repro/covariance/matern.py: matern (the JAX package has no kernel for
// it).  What bounds it and what its design does about it: csrc/matern_cov.cu's
// header, which describes both; the device arithmetic they share is in
// csrc/matern_cov.cuh.  A separate source so that the forward's and the
// backward's 84 instantiations compile in two nvcc processes side by side.
#include "matern_cov.cuh"

namespace {

constexpr int kSumThreads = 1024;  // threads of the backward's second pass

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(static_cast<uint32_t>(
                   __cvta_generic_to_shared(dst))), "l"(src), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One stage of the backward's pipeline in shared memory: the row and column
// sites of a 64 x 64 block of G and, in the symmetric form, G's mirror
// block (J, I), stored as read ([c][r] = G(J 64 + c, I 64 + r)).
template <typename T, bool SYM, bool HAV>
struct GradStage {
  typename SiteOf<T, HAV>::type row[kB], col[kB];
  T g[SYM ? kB : 1][kB + 1];
};

// A G entry in the locations' precision (exact for every pair taken)
__device__ __forceinline__ float to_t(float v, float*) { return v; }
__device__ __forceinline__ float to_t(__nv_bfloat16 v, float*) { return __bfloat162float(v); }
__device__ __forceinline__ double to_t(double v, double*) { return v; }
__device__ __forceinline__ double to_t(float v, double*) { return static_cast<double>(v); }

// N contiguous G entries, loaded as one vector (8 or 16 bytes)
template <typename G, int N>
struct alignas(N * sizeof(G)) GVec {
  G v[N];
};

// A work item of the backward: its tile's offsets (row locations, column
// locations, G) and its 64 x 64 block (I, J) within the tile
struct GradWork {
  long long la, lb, g;
  int2 ij;
};

// Work item k: tile k / tile_blocks (zip for lag < 0: row and column tile
// z; lower for lag >= 0: the z-th tile (ti, tj), ti - tj >= lag, row by
// row) and its block k % tile_blocks (the lower blocks in the symmetric
// form, all of them row by row in the general one).
template <bool SYM>
__device__ __forceinline__ GradWork grad_work(long long k, long long tile_blocks, int n_bc,
                                              int lag, int rows, int cols, long long gs_i,
                                              long long gs_j) {
  const long long z = k / tile_blocks, kb = k - z * tile_blocks;
  long long ti = z, tj = z;
  if (lag >= 0) {
    const int2 t = lower_pair(z);
    ti = t.x + lag;
    tj = t.y;
  }
  GradWork w;
  w.la = ti * rows;
  w.lb = tj * cols;
  w.g = ti * gs_i + tj * gs_j;
  if (SYM) {
    w.ij = lower_pair(kb);
  } else {
    const unsigned u = static_cast<unsigned>(kb);  // tile_blocks < 2^31
    w.ij = make_int2(static_cast<int>(u / n_bc), static_cast<int>(u % n_bc));
  }
  return w;
}

// Start the loads of block ij of one tile (la, lb, g at the tile): its
// locations into stage st by cp.async, or for haversine into the register
// `pend` (converted to sites at the top of the next iteration); in the
// symmetric form (G is T) its mirror into st by cp.async; one commit group;
// its own G entries into gv, converted to T (0 outside G).
template <typename T, typename G, bool SYM, bool HAV>
__device__ __forceinline__ void grad_issue(GradStage<T, SYM, HAV>& st,
                                           Pack<T> (&gv)[Micro<T>::RM],
                                           typename Loc2<T>::type& pend,
                                           const typename Loc2<T>::type* la,
                                           const typename Loc2<T>::type* lb, const G* g,
                                           int rows, int cols, int2 ij, int vec) {
  using M = Micro<T>;
  using L2 = typename Loc2<T>::type;
  const int r0 = ij.x * kB, c0 = ij.y * kB, t = threadIdx.x;
  if (t < kB) {
    if constexpr (HAV) {
      pend = r0 + t < rows ? la[r0 + t] : L2{};
    } else {
      if (r0 + t < rows) cp_async<sizeof(L2)>(&st.row[t], la + r0 + t);
      else st.row[t] = L2{};
    }
  } else if (t < 2 * kB) {
    if constexpr (HAV) {
      pend = c0 + t - kB < cols ? lb[c0 + t - kB] : L2{};
    } else {
      if (c0 + t - kB < cols) cp_async<sizeof(L2)>(&st.col[t - kB], lb + c0 + t - kB);
      else st.col[t - kB] = L2{};
    }
  }
  if constexpr (SYM) {
    static_assert(std::is_same<T, G>::value, "the symmetric form reads G in T");
    if (ij.x != ij.y) {
      // G rows c0 .. c0 + 64, columns r0 .. r0 + 64 (rows == cols here),
      // consecutive threads on consecutive elements of a row
      constexpr int kStep = kThreads / kB;  // rows per pass
      const int rr = t / kB, cc = t % kB;
      if (c0 + kB <= rows && r0 + kB <= cols) {  // a whole block: no checks
        const T* src = g + static_cast<long long>(c0 + rr) * cols + r0 + cc;
#pragma unroll
        for (int m = 0; m < kB / kStep; ++m)
          cp_async<sizeof(T)>(&st.g[rr + kStep * m][cc],
                              src + static_cast<long long>(kStep * m) * cols);
      } else {
#pragma unroll 4
        for (int m = 0; m < kB / kStep; ++m) {
          const int r = rr + kStep * m;
          if (c0 + r < rows && r0 + cc < cols)
            cp_async<sizeof(T)>(&st.g[r][cc],
                                g + static_cast<long long>(c0 + r) * cols + r0 + cc);
          else
            st.g[r][cc] = T(0);
        }
      }
    }
  }
  cp_async_commit();
  const int c = c0 + M::V * (t % M::TC), row0 = r0 + t / M::TC;
  const G* p = g + static_cast<long long>(row0) * cols + c;
  if (vec && r0 + kB <= rows && c0 + kB <= cols) {  // a whole block: vector loads
#pragma unroll
    for (int k = 0; k < M::RM; ++k) {
      const GVec<G, M::V> v =
          *reinterpret_cast<const GVec<G, M::V>*>(p + static_cast<long long>(M::TR * k) * cols);
#pragma unroll
      for (int q = 0; q < M::V; ++q) gv[k].v[q] = to_t(v.v[q], static_cast<T*>(nullptr));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < M::RM; ++k) {
    const int row = row0 + M::TR * k;
    const G* pk = p + static_cast<long long>(M::TR * k) * cols;
#pragma unroll
    for (int q = 0; q < M::V; ++q)
      gv[k].v[q] = row < rows && c + q < cols ? to_t(pk[q], static_cast<T*>(nullptr)) : T(0);
  }
}

// The backward: sums over the G tiles of G_rc dK_rc/dtheta1 = G corr and
// of G_rc x g(x), the forward's distance and correlation recomputed with
// the forward's arithmetic, in T; the products summed in fp64.  Each block
// walks the work items k = blockIdx.x, + gridDim.x, ... (grad_work), a
// two-stage pipeline: while it evaluates item k, the locations and mirror
// of item k + gridDim.x land in the other stage and its own G entries in
// registers.  In the symmetric form (each tile's row and column locations
// the same, rows == cols) block (I, J), I > J, adds G_IJ and the
// transposed G_JI against one evaluation.  Each block writes its two sums
// (per thread in a fixed order, warp shuffles, then its warps in order) to
// partials[2 b], [2 b + 1]; the second pass sums them in a fixed order: no
// atomics, the same bits from run to run.
template <typename T, typename G, int TWO_NU, bool SYM, bool HAV>
__global__ void __launch_bounds__(kThreads)
matern_cov_grad_kernel(const T* __restrict__ locs_a, const T* __restrict__ locs_b,
                       const G* __restrict__ g, int rows, int cols, T th2, long long n_blocks,
                       long long tile_blocks, int lag, long long gs_i, long long gs_j, int vec,
                       double* __restrict__ partials) {
  using L2 = typename Loc2<T>::type;
  using S = typename SiteOf<T, HAV>::type;
  using M = Micro<T>;
  using Stage = GradStage<T, SYM, HAV>;
  extern __shared__ __align__(16) unsigned char grad_smem[];
  Stage* stage = reinterpret_cast<Stage*>(grad_smem);
  const L2* la = reinterpret_cast<const L2*>(locs_a);
  const L2* lb = reinterpret_cast<const L2*>(locs_b);
  const int n_bc = (cols + kB - 1) / kB;
  const int tc = threadIdx.x % M::TC, tr = threadIdx.x / M::TC;
  const T rcp2 = rcp_rn(th2);
  double s_corr = 0.0, s_term = 0.0;
  Pack<T> gv_next[M::RM];
  L2 pend{};
  long long blk = blockIdx.x;
  GradWork w = grad_work<SYM>(blk, tile_blocks, n_bc, lag, rows, cols, gs_i, gs_j);
  if (blk < n_blocks)
    grad_issue<T, G, SYM, HAV>(stage[0], gv_next, pend, la + w.la, lb + w.lb, g + w.g, rows,
                               cols, w.ij, vec);
  for (int buf = 0; blk < n_blocks; blk += gridDim.x, buf ^= 1) {
    const bool mirror = SYM && w.ij.x != w.ij.y;
    if constexpr (HAV) {  // this item's locations, held since its issue
      const int t = threadIdx.x;
      if (t < kB) stage[buf].row[t] = make_site<T, true>(pend);
      else if (t < 2 * kB) stage[buf].col[t - kB] = make_site<T, true>(pend);
    }
    cp_async_wait_all();
    __syncthreads();  // stage buf landed; every thread is done with stage buf ^ 1
    Pack<T> gv[M::RM];
#pragma unroll
    for (int k = 0; k < M::RM; ++k) gv[k] = gv_next[k];
    const GradWork w_next =
        grad_work<SYM>(blk + gridDim.x, tile_blocks, n_bc, lag, rows, cols, gs_i, gs_j);
    if (blk + gridDim.x < n_blocks)
      grad_issue<T, G, SYM, HAV>(stage[buf ^ 1], gv_next, pend, la + w_next.la,
                                 lb + w_next.lb, g + w_next.g, rows, cols, w_next.ij, vec);
    const Stage& st = stage[buf];
    S xj[M::V];
#pragma unroll
    for (int q = 0; q < M::V; ++q) xj[q] = st.col[M::V * tc + q];
#pragma unroll
    for (int k = 0; k < M::RM; ++k) {
      const S xi = st.row[tr + M::TR * k];
#pragma unroll
      for (int q = 0; q < M::V; ++q) {
        // G_ij + G_ji in fp64 (0 for an element outside G: its locations
        // are (0, 0), so its terms are finite)
        double gs = static_cast<double>(gv[k].v[q]);
        if (mirror) gs += static_cast<double>(st.g[M::V * tc + q][tr + M::TR * k]);
        const T dist = distance<T>(xi, xj[q]);
        const T x = div_by(dist, th2, rcp2);
        const T e = exp_rn(-x);
        // K = theta1 at r = 0: dK/dtheta1 = 1, dK/dtheta2 = 0
        const T corr = dist == T(0) ? T(1) : matern_corr_e<TWO_NU>(x, e);
        const T term = dist == T(0) ? T(0) : matern_grad_term_e<TWO_NU>(x, e);
        s_corr += gs * static_cast<double>(corr);
        s_term += gs * static_cast<double>(term);
      }
    }
    w = w_next;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s_corr += __shfl_down_sync(0xffffffffu, s_corr, off);
    s_term += __shfl_down_sync(0xffffffffu, s_term, off);
  }
  __shared__ double warp_sums[kThreads / 32][2];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_sums[warp][0] = s_corr;
    warp_sums[warp][1] = s_term;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w8 = 0; w8 < kThreads / 32; ++w8) {
      a += warp_sums[w8][0];
      b += warp_sums[w8][1];
    }
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = b;
  }
}

// out[0] = the sum of the partials' first halves, out[1] = (th1 / th2) times
// the sum of their second halves; one block, a fixed-order tree
__global__ void __launch_bounds__(kSumThreads)
matern_grad_sum_kernel(const double* __restrict__ partials, long long n_blocks,
                       double th1, double th2, double* __restrict__ out) {
  __shared__ double sums[2][kSumThreads];
  double a = 0.0, b = 0.0;
  for (long long i = threadIdx.x; i < n_blocks; i += kSumThreads) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  sums[0][threadIdx.x] = a;
  sums[1][threadIdx.x] = b;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sums[0][threadIdx.x] += sums[0][threadIdx.x + half];
      sums[1][threadIdx.x] += sums[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = sums[0][0];
    out[1] = sums[1][0] * (th1 / th2);
  }
}

// One backward launch of instantiation `kernel`, with its two pipeline
// stages of `stage_bytes` each in dynamic shared memory: as many blocks as
// fit on the card at once (at most n_blocks and n_partials / 2), each
// walking the work items with a stride of the grid.
template <typename T, typename G>
cudaError_t launch_grad_kernel(void (*kernel)(const T*, const T*, const G*, int, int, T,
                                              long long, long long, int, long long, long long,
                                              int, double*),
                               size_t stage_bytes, const T* a, const T* b, const G* g,
                               int rows, int cols, T th2, long long n_blocks,
                               long long tile_blocks, int lag, long long gs_i, long long gs_j,
                               int vec, double* partials, long long n_partials, long long* grid,
                               cudaStream_t stream) {
  const size_t smem = 2 * stage_bytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  long long n = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (n > n_blocks) n = n_blocks;
  if (n > n_partials / 2) n = n_partials / 2;
  if (n <= 0) return cudaErrorInvalidValue;
  *grid = n;
  kernel<<<static_cast<unsigned>(n), kThreads, smem, stream>>>(
      a, b, g, rows, cols, th2, n_blocks, tile_blocks, lag, gs_i, gs_j, vec, partials);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_grad(const void* la, const void* lb, const void* g_, double* partials,
                        long long n_partials, double* out, int rows, int cols, int n_tiles,
                        int lag, long long gs_i, long long gs_j, T th1, T th2, int two_nu,
                        int sym, int hav, cudaStream_t stream) {
  constexpr int V = Micro<T>::V;
  const long long n_br = (rows + kB - 1) / kB, n_bc = (cols + kB - 1) / kB;
  if (rows <= 0 || cols <= 0 || n_tiles <= 0 || (sym && (rows != cols || lag >= 0)))
    return cudaErrorInvalidValue;
  const long long tile_blocks = sym ? n_br * (n_br + 1) / 2 : n_br * n_bc;
  const long long n_blocks = tile_blocks * n_tiles;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(la);
  const T* b = static_cast<const T*>(lb);
  const G* g = static_cast<const G*>(g_);
  const int vec = cols % V == 0 && gs_i % V == 0 && gs_j % V == 0 &&
                  reinterpret_cast<std::uintptr_t>(g_) % (V * sizeof(G)) == 0;
  long long grid = 0;
  cudaError_t err;
  const int key = (two_nu * 2 + (sym ? 1 : 0)) * 2 + (hav ? 1 : 0);
#define REPRO_GRAD(NU, S, H)                                                              \
  launch_grad_kernel<T, G>(matern_cov_grad_kernel<T, G, NU, S, H>,                        \
                           sizeof(GradStage<T, S, H>), a, b, g, rows, cols, th2, n_blocks, \
                           tile_blocks, lag, gs_i, gs_j, vec, partials, n_partials, &grid, \
                           stream)
  switch (key) {
    case 4: err = REPRO_GRAD(1, false, false); break;
    case 5: err = REPRO_GRAD(1, false, true); break;
    case 12: err = REPRO_GRAD(3, false, false); break;
    case 13: err = REPRO_GRAD(3, false, true); break;
    case 20: err = REPRO_GRAD(5, false, false); break;
    case 21: err = REPRO_GRAD(5, false, true); break;
    default:
      if constexpr (std::is_same<T, G>::value) {  // the symmetric form reads G in T
        switch (key) {
          case 6: err = REPRO_GRAD(1, true, false); break;
          case 7: err = REPRO_GRAD(1, true, true); break;
          case 14: err = REPRO_GRAD(3, true, false); break;
          case 15: err = REPRO_GRAD(3, true, true); break;
          case 22: err = REPRO_GRAD(5, true, false); break;
          case 23: err = REPRO_GRAD(5, true, true); break;
          default: return cudaErrorInvalidValue;
        }
      } else {
        return cudaErrorInvalidValue;
      }
  }
#undef REPRO_GRAD
  if (err != cudaSuccess) return err;
  matern_grad_sum_kernel<<<1, kSumThreads, 0, stream>>>(
      partials, grid, static_cast<double>(th1), static_cast<double>(th2), out);
  return cudaGetLastError();
}

}  // namespace

// The backward of matern_cov_launch: out[k] = sum over the G tiles of
// sum_rc G_rc dK_rc/dtheta_{k+1} for k = 0, 1 (fp64), K = C(row tile,
// column tile), locations (tiles, rows, 2) and (tiles, cols, 2), each G
// tile (rows, cols) row-major:
//   * n_tiles = 1, lag = -1: one tile (G_stride_i unread);
//   * zip, lag = -1: n_tiles pairs, pair z the row tile z, the column tile
//     z and G at grad + z g_stride_i;
//   * lower, lag >= 0: the n_tiles tiles (ti, tj), ti - tj >= lag, row by
//     row, G at grad + ti g_stride_i + tj g_stride_j.
// sym = 1 (zip only): row tile z is column tile z (rows == cols), and only
// each tile's lower 64 x 64 blocks are evaluated, against G's two mirrored
// blocks.  dtypes: 0 -> fp32 locations, fp32 G; 1 -> fp32 locations, bf16
// G; 2 -> fp64 locations, fp64 G; 3 -> fp64 locations, fp32 G (the
// symmetric form takes 0 and 2).  hav = 1: haversine distance in degrees
// on lon/lat locations.  th1, th2 are rounded to fp32 for the fp32
// locations, as the forward's are.  partials: n_partials fp64 scratch, two
// per block of the first pass; the grid is cut to n_partials / 2 blocks.
extern "C" int matern_cov_grad_launch(const void* locs_a, const void* locs_b,
                                      const void* grad, void* partials,
                                      long long n_partials, void* out, int rows, int cols,
                                      int n_tiles, int lag, long long g_stride_i,
                                      long long g_stride_j, double th1, double th2,
                                      int two_nu, int dtypes, int sym, int hav,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(partials);
  double* o = static_cast<double*>(out);
  const float f1 = static_cast<float>(th1), f2 = static_cast<float>(th2);
  switch (dtypes) {
    case 0:
      return launch_grad<float, float>(locs_a, locs_b, grad, p, n_partials, o, rows, cols,
                                       n_tiles, lag, g_stride_i, g_stride_j, f1, f2, two_nu,
                                       sym, hav, s);
    case 1:
      return launch_grad<float, __nv_bfloat16>(locs_a, locs_b, grad, p, n_partials, o, rows,
                                               cols, n_tiles, lag, g_stride_i, g_stride_j,
                                               f1, f2, two_nu, sym, hav, s);
    case 2:
      return launch_grad<double, double>(locs_a, locs_b, grad, p, n_partials, o, rows, cols,
                                         n_tiles, lag, g_stride_i, g_stride_j, th1, th2,
                                         two_nu, sym, hav, s);
    case 3:
      return launch_grad<double, float>(locs_a, locs_b, grad, p, n_partials, o, rows, cols,
                                        n_tiles, lag, g_stride_i, g_stride_j, th1, th2,
                                        two_nu, sym, hav, s);
    default:
      return cudaErrorInvalidValue;
  }
}
