// Banded mixed-precision SYRK U = P P^T, written for sm_90a, and its
// backward dP = S P (mp_syrk_grad_launch; its design is described where its
// kernels begin, below the forward's).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mp_gemm/mp_gemm.py: _mp_syrk_kernel / mp_syrk_pallas.
//
// Precision routing (the paper's Algorithm 1): an output element (r, c) is
// in the band when |r / tile - c / tile| < band_blocks.  Four (hi, lo,
// accum) pairs:
//   0  (fp32, bf16, fp32): in-band elements are IEEE fp32 dot products (FMA,
//      no TF32); off-band elements take bf16 operands, sum their products in
//      fp32, round that sum to bf16 at every `round_k` columns of K, and add
//      the rounded partial sums into the fp32 output;
//   1  (fp32, fp32, fp32): every element in the band;
//   2  (fp64, fp32, fp32), the paper's DP/SP pair: in-band elements are fp64
//      dot products on the fp64 tensor cores; off-band elements take P
//      rounded to fp32 and sum their products in one IEEE fp32 FMA chain over
//      K (rounding a partial sum to lo = fp32 changes nothing, so round_k
//      plays no part), stored into the fp64 output;
//   3  (fp64, fp64, fp64): every element in the band.
// The TPU kernel tied the classification unit and the rounding unit to its
// own block sizes (bm, bk); here `tile` and `round_k` are arguments and the
// kernels' blocks (BM x BM outputs, K in steps of 16, 32 or 64) divide them.
//
// What bounds it on the H100: on the panel path the in-band part is fp32
// work on the CUDA cores (67 TFLOP/s) and bounds the call by its operations;
// the off-band part is bf16 tensor-core work (989 TFLOP/s) whose least time
// is set by the bytes of its fp32 output (lower block and mirror), not by its
// products.  As written, the off-band kernel is held by L2 traffic: each
// 128 x 128 block reads 512 KiB of operands for 128 KiB of output.  Under the
// fp64 pair both parts are bound by operations, at one peak: fp64 in the
// band, 67 TFLOP/s only on the tensor cores (DMMA; fp64 FMA outside them has
// half that), and IEEE fp32 off it, 67 TFLOP/s on the CUDA cores.  Their
// second limits: a 128 x 128 fp64 block reads 2 x 128 rows of P from L2 for
// 2 * 128^2 flops per column of K, 16 flops a byte, so DMMA at its peak needs
// ~4 TB/s of L2; an fp32 SIMT thread of 8 x 8 outputs reads 64 bytes of
// shared memory per 64 FMAs, so 128 FMA lanes an SM clock would need 128
// bytes of it a clock, all it has, unless the lanes of a warp share loads.
//
// What the design does about it:
//   * U is symmetric, so each kernel computes only the lower blocks (bi >= bj)
//     of its class and writes each block twice, to (bi, bj) and transposed to
//     (bj, bi), the transpose through shared memory so that it too is
//     written in whole rows.  The
//     result is still the full square the TPU kernel returns, and it is
//     exactly symmetric.  Each kernel's 1-D grid covers exactly its own lower
//     blocks, tile row by tile row (mp_syrk_launch sizes it from the
//     tile-row offsets below); a block finds its (bi, bj) from its linear
//     index (band_block, off_block).
//   * fp32 band (pairs 0, 1): SIMT, 256 threads per BM x BM block,
//     (BM / 16)^2 outputs per thread in registers.  K goes in steps of 16
//     through two shared-memory buffers, transposed so that each k step
//     reads four consecutive values; the next step's operands are loaded
//     into registers while the current one's FMAs run.  Each element is one
//     FMA chain over k in order, so a diagonal block is symmetric bit for
//     bit.
//   * fp64 band (pairs 2, 3): mma.sync m16n8k4 in fp64 (DMMA: wgmma has no
//     fp64 form).  A 128 x 128 block (64 x 64 where 128 does not divide the
//     tile) has 8 warps of 64 x 32 outputs (4 of 32 x 32), 64 fp64
//     accumulators a thread.  Its operands, K-major rows of P, come by
//     16-byte cp.async into a ring of 4 shared-memory stages of 16 columns,
//     3 in flight while one is read: they never pass through registers.
//     ldmatrix takes only 16-bit elements, so fragments are 8-byte shared
//     loads; staged rows are 20 doubles apart, so the 16 lanes of a
//     half-warp (4 rows x 4 columns of a fragment) hit 16 distinct bank
//     pairs.  Per 4 columns of K a warp issues 16 DMMA for 12 fragment
//     loads (m16n8k8 and m16n8k16 measured no faster on the H100).  DMMA
//     sums in no stated order, so a diagonal block is written as its lower
//     triangle and the mirror of those same values.
//   * off-band under the fp64 pair: P is written once as fp32 into a scratch
//     (to_fp32_kernel); the off-band kernel sums in one IEEE fp32 FMA chain
//     per element, k in order, and stores fp64.  A 128 x 128 block has 8
//     warps of 32 x 64, a warp's lanes 4 x 8 threads of 8 x 8 outputs (rows
//     4 apart, columns 8 apart), 64 accumulators a thread with the
//     registers to hold them (one block per SM: no spill).  Operands come by
//     cp.async into a ring of 4 stages of 32 columns; rows are 36 floats
//     apart, so a warp's 16-byte load (4 columns of K) of 4 A rows or of 8
//     B rows falls in as many distinct 16-byte bank groups as it has rows,
//     and the lanes that share a row share the load: one shared-memory wavefront per 16-byte load, 16 of them per
//     256 FMAs of a warp.  What still holds it below the peak is issue,
//     not memory: stage depths of 3 to 6, 16 to 64 columns a stage and the
//     order of the FMAs all measured the same ~41 TFLOP/s, the rate of the
//     fp32 band kernel above.
//   * off-band under the bf16 pair: P is written once as bf16 into a
//     scratch (to_bf16_kernel).
//     One producer warp fills a ring of shared-memory stages with TMA loads
//     of BM x 64 boxes of both operands (rows of P, K-major, 128-byte
//     swizzle); BM / 64 consumer warpgroups run wgmma m64nBMk16 with fp32
//     accumulators in registers; mbarriers hand the stages back and forth.
//     The bf16 rounding is applied to the accumulator at every round_k
//     boundary; with round_k == kdim (the panel path) there is one rounding
//     and no second accumulator.
// The tensor map comes from cuTensorMapEncodeTiled in libcuda (linked with
// -lcuda).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block grid of one call: BM x BM blocks, r = tile / BM of them along
// each side of a tile, n_tiles = m / tile tiles, band = band_blocks.
struct Grid {
  int r;
  int n_tiles;
  int band;
};

// Lower band blocks in tile rows < T.  Tile row ti holds the lower half of
// its diagonal tile (r (r + 1) / 2 blocks, the diagonal included) and
// min(ti, band - 1) whole tiles to its left.
__host__ __device__ inline long long band_row_start(const Grid& g, long long T) {
  const long long b1 = g.band - 1;
  const long long whole = T <= b1 + 1 ? T * (T - 1) / 2 : b1 * (b1 + 1) / 2 + (T - b1 - 1) * b1;
  return T * g.r * (g.r + 1) / 2 + whole * g.r * g.r;
}

// Off-band blocks in tile rows < T: tile row ti holds max(0, ti - band + 1)
// whole tiles.
__host__ __device__ inline long long off_row_start(const Grid& g, long long T) {
  const long long x = T > g.band ? T - g.band : 0;
  return x * (x + 1) / 2 * g.r * g.r;
}

// The largest tile row T with start(T) <= idx (rows without blocks are skipped).
template <bool BAND>
__device__ __forceinline__ int tile_row_of(const Grid& g, long long idx) {
  int lo = 0, hi = g.n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    const long long s = BAND ? band_row_start(g, mid) : off_row_start(g, mid);
    if (s <= idx) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// (bi, bj) of band block idx: within its tile row, block row a holds the
// wr = min(ti, band - 1) r whole-tile blocks and a + 1 blocks of the diagonal
// tile, in column order.
__device__ __forceinline__ int2 band_block(const Grid& g, long long idx) {
  const int ti = tile_row_of<true>(g, idx);
  int q = static_cast<int>(idx - band_row_start(g, ti));
  const int wr = min(ti, g.band - 1) * g.r;
  int a = 0;
  while (a + 1 < g.r && q >= wr + a + 1) {
    q -= wr + a + 1;
    ++a;
  }
  return make_int2(ti * g.r + a, ti * g.r - wr + q);
}

// (bi, bj) of off-band block idx: within its tile row, column-major, so that
// the r blocks in a row of the grid share one B operand in L2.
__device__ __forceinline__ int2 off_block(const Grid& g, long long idx) {
  const int ti = tile_row_of<false>(g, idx);
  const int q = static_cast<int>(idx - off_row_start(g, ti));
  return make_int2(ti * g.r + q % g.r, q / g.r);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- the fp32 band: SIMT blocks ------------------------------------------
constexpr int kSimtThreads = 256;
constexpr int BK = 16;  // K step of the SIMT kernel

// the fp32 in-band lower blocks (bi >= bj), BM x BM, each written with its
// mirror
template <int BM>
__global__ void __launch_bounds__(kSimtThreads, 2)
syrk_band_lower_kernel(const float* __restrict__ p, float* __restrict__ out, int m, int kdim,
                       Grid g) {
  constexpr int TM = BM / 16;  // outputs per thread along each axis
  constexpr int G = TM / 4;    // groups of 4 rows (cols) per thread, 64 apart
  constexpr int LD = BM + 4;
  constexpr int LOADS = BM * BK / 4 / kSimtThreads;  // float4s per operand per thread
  constexpr int SLD = BM + 1;  // the mirror's staging rows: conflict-free column reads
  static_assert(LOADS >= 1 && 64 * SLD <= 2 * 2 * BK * LD, "SIMT kernel shapes");
  __shared__ __align__(16) float sm[2][2][BK][LD];  // [buffer][A, B][k][row]
  using V = float4;  // four consecutive values, loaded and stored 16 bytes at a time

  const int2 blk = band_block(g, blockIdx.x);
  const int row0 = blk.x * BM, col0 = blk.y * BM;
  const float* pa = p + static_cast<long long>(row0) * kdim;
  const float* pb = p + static_cast<long long>(col0) * kdim;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  V ra[LOADS], rb[LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * kSimtThreads;
      const int r = idx / (BK / 4), c4 = (idx % (BK / 4)) * 4;
      ra[l] = *reinterpret_cast<const V*>(pa + static_cast<long long>(r) * kdim + k0 + c4);
      rb[l] = *reinterpret_cast<const V*>(pb + static_cast<long long>(r) * kdim + k0 + c4);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * kSimtThreads;
      const int r = idx / (BK / 4), c4 = (idx % (BK / 4)) * 4;
      sm[buf][0][c4 + 0][r] = ra[l].x; sm[buf][0][c4 + 1][r] = ra[l].y;
      sm[buf][0][c4 + 2][r] = ra[l].z; sm[buf][0][c4 + 3][r] = ra[l].w;
      sm[buf][1][c4 + 0][r] = rb[l].x; sm[buf][1][c4 + 1][r] = rb[l].y;
      sm[buf][1][c4 + 2][r] = rb[l].z; sm[buf][1][c4 + 3][r] = rb[l].w;
    }
  };

  float acc[TM][TM] = {};
  load(0);
  stage(0);
  __syncthreads();
  const int nkt = kdim / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nkt) load((kt + 1) * BK);  // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TM];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const V va = *reinterpret_cast<const V*>(&sm[cur][0][kk][gg * 64 + ty * 4]);
        const V vb = *reinterpret_cast<const V*>(&sm[cur][1][kk][gg * 64 + tx * 4]);
        a[gg * 4 + 0] = va.x; a[gg * 4 + 1] = va.y; a[gg * 4 + 2] = va.z; a[gg * 4 + 3] = va.w;
        b[gg * 4 + 0] = vb.x; b[gg * 4 + 1] = vb.y; b[gg * 4 + 2] = vb.z; b[gg * 4 + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nkt) stage(cur ^ 1);
    __syncthreads();
  }

  // the lower block (bi, bj), straight from the registers
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const int c = col0 + gg * 64 + tx * 4;
      *reinterpret_cast<V*>(out + r * m + c) =
          make_float4(acc[i][gg * 4 + 0], acc[i][gg * 4 + 1], acc[i][gg * 4 + 2],
                      acc[i][gg * 4 + 3]);
    }
  }
  if (row0 == col0) return;  // a diagonal block is whole and symmetric

  // its mirror (bj, bi), 64 rows of the block at a time through shared
  // memory: row c of the mirror is column c of the block
  float* S = &sm[0][0][0][0];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        S[(ty * 4 + ii) * SLD + (j / 4) * 64 + tx * 4 + j % 4] = acc[gi * 4 + ii][j];
    __syncthreads();
    for (int idx = tid; idx < 64 * BM; idx += kSimtThreads) {
      const int c = idx / 64, lr = idx % 64;
      out[static_cast<long long>(col0 + c) * m + row0 + gi * 64 + lr] = S[lr * SLD + c];
    }
  }
}

// ---- off-band blocks: bf16 wgmma fed by TMA ------------------------------
constexpr int KC = 64;  // K columns per stage: one 128-byte swizzle row of bf16

__global__ void to_bf16_kernel(const float4* __restrict__ src, uint2* __restrict__ dst,
                               long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = src[i];
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    dst[i] = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO),
// the tile 1,024-byte aligned.  Advancing K by 16 bf16 adds 32 bytes (2 in
// the 16-byte units of the address field).
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;            // leading byte offset (unused with this swizzle)
  d |= uint64_t(1024 >> 4) << 32;    // stride byte offset
  d |= uint64_t(1) << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32 registers) = A (64 x 16) B^T (N x 16), both K-major bf16 in
// shared memory; scale_d = 0 ignores D's old value.
template <int TA = 0>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int TA = 0>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// D (64 x N) = A (64 x 16) B^T (N x 16); TA = 1 reads A MN-major (its 64
// rows contiguous in each K row) instead of K-major
template <int N, int TA = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 128) wgmma_m64n128<TA>(d, da, db, scale_d);
  else wgmma_m64n64<TA>(d, da, db, scale_d);
}

template <int BM>
struct OffCfg {
  static constexpr int NWG = BM / 64;             // consumer warpgroups, 64 rows each
  static constexpr int THREADS = NWG * 128 + 32;  // and one producer warp
  static constexpr int STAGES = BM == 128 ? 3 : 4;
  static constexpr int TILE_BYTES = BM * KC * 2;  // one operand's BM x 64 bf16 box
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + RING_BYTES + 2 * STAGES * 8;  // + alignment, barriers
  static_assert(BM * (BM + 1) * 4 <= RING_BYTES, "the epilogue's staging reuses the ring");
};

template <int BM, bool ONE_ROUND>
__global__ void __launch_bounds__(OffCfg<BM>::THREADS, ONE_ROUND ? 2 : 1)
syrk_offband_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap pmap,
                               float* __restrict__ out, int m, int kdim, int round_k, Grid g) {
  using C = OffCfg<BM>;
  constexpr int R = BM / 2;  // accumulator registers per thread (64 x BM per warpgroup)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::RING_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int2 blk = off_block(g, blockIdx.x);
  const int bi = blk.x, bj = blk.y;
  const int nk = kdim / KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == C::NWG * 4) {  // the producer warp: one thread issues the loads
    if (lane == 0) {
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % C::STAGES;
        if (kc >= C::STAGES) mbar_wait(&empty[s], (kc / C::STAGES - 1) & 1);
        uint8_t* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_2d(st, &pmap, &full[s], kc * KC, bi * BM);
        tma_load_2d(st + C::TILE_BYTES, &pmap, &full[s], kc * KC, bj * BM);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. wg * 64 + 63 of the block
  const int wg = warp / 4;
  float acc[R];
  float total[ONE_ROUND ? 1 : R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  if constexpr (!ONE_ROUND) {
#pragma unroll
    for (int i = 0; i < R; ++i) total[i] = 0.f;
  }
  const int per_round = round_k / KC;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % C::STAGES;
    mbar_wait(&full[s], (kc / C::STAGES) & 1);
    const uint8_t* st = ring + s * C::STAGE_BYTES;
    const uint64_t da = smem_desc(st + wg * 64 * 128);
    const uint64_t db = smem_desc(st + C::TILE_BYTES);
    const bool fresh = kc % per_round == 0;  // the first K step of a rounded partial
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      wgmma_bf16<BM>(acc, da + 2 * kk, db + 2 * kk, (fresh && kk == 0) ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: free its stage
    fence_regs(acc);
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(kc - 1) % C::STAGES]);
    if constexpr (!ONE_ROUND) {
      if ((kc + 1) % per_round == 0) {  // the lo store of a round_k partial sum
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < R; ++i) total[i] += round_bf16(acc[i]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: stage the block in the ring (every wgmma of both warpgroups
  // has read its operands once all consumers pass the barrier), then write
  // it and its transpose row by row
  constexpr int LD = BM + 1;
  constexpr int NC = C::NWG * 128;
  float* S = reinterpret_cast<float*>(ring);
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
  const int w = warp % 4;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = wg * 64 + w * 16 + lane / 4 + 8 * h;
        const int col = 8 * j + 2 * (lane % 4) + e;
        float v;
        if constexpr (ONE_ROUND) v = round_bf16(acc[4 * j + 2 * h + e]);
        else v = total[4 * j + 2 * h + e];
        S[row * LD + col] = v;
      }
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
  float* lower = out + static_cast<long long>(bi) * BM * m + static_cast<long long>(bj) * BM;
  float* mirror = out + static_cast<long long>(bj) * BM * m + static_cast<long long>(bi) * BM;
  for (int idx = threadIdx.x; idx < BM * BM; idx += NC) {
    const int r = idx / BM, c = idx % BM;
    lower[static_cast<long long>(r) * m + c] = S[r * LD + c];
    mirror[static_cast<long long>(r) * m + c] = S[c * LD + r];
  }
}

// ---- the fp64 pair: cp.async rings feeding DMMA and fp32 SIMT -------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ROWS rows of P from `src`, columns k0 .. k0 + BK, into a [ROWS][LD] tile:
// 16 bytes per cp.async, neighbouring threads on neighbouring bytes of a row.
template <typename T, int ROWS, int BK, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int kdim, int k0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = BK / V;  // 16-byte chunks of a row
  static_assert(ROWS * CH % THREADS == 0 && LD % V == 0, "ring shapes");
#pragma unroll
  for (int l = 0; l < ROWS * CH / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / CH, c = (idx % CH) * V;
    cp_async16(dst + r * LD + c, src + static_cast<long long>(r) * kdim + k0 + c);
  }
}

// The K loop over a ring of STAGES stages, each the A rows then the B rows of
// one block ([2][BM][LD]), BK columns of K: STAGES - 1 stages in flight
// while consume(A, B) reads one.  Returns with every copy landed and every
// thread past its last read, so the caller may reuse the ring.
template <typename T, int BM, int BK, int LD, int STAGES, int THREADS, typename F>
__device__ __forceinline__ void ring_k_loop(T* ring, const T* pa, const T* pb, int kdim,
                                            F&& consume) {
  constexpr int STAGE = 2 * BM * LD;
  const int nkt = kdim / BK;
  auto fill = [&](int kt) {
    T* st = ring + (kt % STAGES) * STAGE;
    stage_rows<T, BM, BK, LD, THREADS>(st, pa, kdim, kt * BK);
    stage_rows<T, BM, BK, LD, THREADS>(st + BM * LD, pb, kdim, kt * BK);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) fill(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed for every thread; kt - 1 is read
    if (kt + STAGES - 1 < nkt) fill(kt + STAGES - 1);
    cp_async_commit();
    const T* st = ring + (kt % STAGES) * STAGE;
    consume(st, st + BM * LD);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A BM x BM lower block staged in S ([BM][SLD]) written as fp64 at (row0,
// col0) with its mirror at (col0, row0); a diagonal block as its lower
// triangle and the mirror of that triangle, so U = U^T bit for bit whatever
// order the products were summed in.  Rows of both go out whole; SLD is odd,
// so the column reads of the mirror are free of bank conflicts.
template <typename S_T, int BM, int SLD, int THREADS>
__device__ __forceinline__ void store_block_f64(const S_T* S, double* __restrict__ out, int m,
                                                int row0, int col0) {
  double* lower = out + static_cast<long long>(row0) * m + col0;
  if (row0 == col0) {
    for (int idx = threadIdx.x; idx < BM * BM; idx += THREADS) {
      const int r = idx / BM, c = idx % BM;
      lower[static_cast<long long>(r) * m + c] = r >= c ? S[r * SLD + c] : S[c * SLD + r];
    }
    return;
  }
  double* mirror = out + static_cast<long long>(col0) * m + row0;
  for (int idx = threadIdx.x; idx < BM * BM; idx += THREADS) {
    const int r = idx / BM, c = idx % BM;
    lower[static_cast<long long>(r) * m + c] = S[r * SLD + c];
    mirror[static_cast<long long>(r) * m + c] = S[c * SLD + r];
  }
}

// D (16 x 8) += A (16 x 4, row) B (4 x 8, col) in fp64 on the tensor cores.
// Lane l holds, with g = l / 4 and t = l % 4: a = A[g][t], A[g + 8][t];
// b = B[t][g]; d = D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void dmma_m16n8k4(double (&d)[4], const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int BM>
struct DmmaCfg {
  static constexpr int WM = BM == 128 ? 64 : 32;  // warp tile: WM x 32 outputs
  static constexpr int WN = 32;
  static constexpr int MT = WM / 16, NT = WN / 8;  // m16n8 tiles of a warp
  static constexpr int WARPS_M = BM / WM;
  static constexpr int THREADS = WARPS_M * (BM / WN) * 32;
  static constexpr int BK = 16;      // K columns per stage: 128 bytes of a row
  static constexpr int LD = BK + 4;  // doubles per staged row
  static constexpr int STAGES = 4;
  static constexpr int SLD = BM + 1;  // the epilogue's staging rows
  static constexpr int SMEM = STAGES * 2 * BM * LD * 8;
  static_assert(BM * SLD <= STAGES * 2 * BM * LD, "the epilogue's staging reuses the ring");
};

// the fp64 in-band lower blocks (pairs 2 and 3) on the fp64 tensor cores
template <int BM>
__global__ void __launch_bounds__(DmmaCfg<BM>::THREADS, 1)
syrk_band_f64_dmma_kernel(const double* __restrict__ p, double* __restrict__ out, int m,
                          int kdim, Grid g) {
  using C = DmmaCfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  const int2 blk = band_block(g, blockIdx.x);
  const int row0 = blk.x * BM, col0 = blk.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp % C::WARPS_M) * C::WM + lane / 4;  // + 16 i (+ 8)
  const int wc = (warp / C::WARPS_M) * C::WN + lane / 4;  // + 8 j
  const int tq = lane % 4;

  double acc[C::MT][C::NT][4] = {};
  ring_k_loop<double, BM, C::BK, C::LD, C::STAGES, C::THREADS>(
      ring, p + static_cast<long long>(row0) * kdim, p + static_cast<long long>(col0) * kdim,
      kdim, [&](const double* A, const double* B) {
#pragma unroll
        for (int kk = 0; kk < C::BK; kk += 4) {
          double a[C::MT][2], b[C::NT];
#pragma unroll
          for (int i = 0; i < C::MT; ++i) {
            a[i][0] = A[(wr + 16 * i) * C::LD + kk + tq];
            a[i][1] = A[(wr + 16 * i + 8) * C::LD + kk + tq];
          }
#pragma unroll
          for (int j = 0; j < C::NT; ++j) b[j] = B[(wc + 8 * j) * C::LD + kk + tq];
#pragma unroll
          for (int i = 0; i < C::MT; ++i)
#pragma unroll
            for (int j = 0; j < C::NT; ++j) dmma_m16n8k4(acc[i][j], a[i], b[j]);
        }
      });

  double* S = ring;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int r = wr + 16 * i, c = wc - lane / 4 + 8 * j + 2 * tq;
      S[r * C::SLD + c] = acc[i][j][0];
      S[r * C::SLD + c + 1] = acc[i][j][1];
      S[(r + 8) * C::SLD + c] = acc[i][j][2];
      S[(r + 8) * C::SLD + c + 1] = acc[i][j][3];
    }
  __syncthreads();
  store_block_f64<double, BM, C::SLD, C::THREADS>(S, out, m, row0, col0);
}

template <int BM>
struct F32Cfg {
  static constexpr int WM = 32, WN = 64;  // warp tile: 4 x 8 lanes of 8 x 8 outputs
  static constexpr int WARPS_M = BM / WM;
  static constexpr int THREADS = WARPS_M * (BM / WN) * 32;
  static constexpr int BK = 32;           // K columns per stage
  static constexpr int LD = BK + 4;       // floats per staged row: LD / 4 odd
  static constexpr int STAGES = 4;
  static constexpr int SLD = BM + 9;  // the epilogue's staging rows
  static constexpr int SMEM = STAGES * 2 * BM * LD * 4;
  static_assert(BM * SLD <= STAGES * 2 * BM * LD, "the epilogue's staging reuses the ring");
};

// the fp64 pair's off-band lower blocks: fp32 operands, one IEEE fp32 FMA
// chain per element over k in order, fp64 out
template <int BM>
__global__ void __launch_bounds__(F32Cfg<BM>::THREADS, 1)
syrk_offband_fp32_pipelined_kernel(const float* __restrict__ p, double* __restrict__ out, int m,
                                   int kdim, Grid g) {
  using C = F32Cfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int2 blk = off_block(g, blockIdx.x);
  const int row0 = blk.x * BM, col0 = blk.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp % C::WARPS_M) * C::WM + lane / 8;  // rows wr + 4 i
  const int wc = (warp / C::WARPS_M) * C::WN + lane % 8;  // cols wc + 8 j

  float acc[8][8] = {};
  ring_k_loop<float, BM, C::BK, C::LD, C::STAGES, C::THREADS>(
      ring, p + static_cast<long long>(row0) * kdim, p + static_cast<long long>(col0) * kdim,
      kdim, [&](const float* A, const float* B) {
        const float* a_row = A + wr * C::LD;
        const float* b_row = B + wc * C::LD;
#pragma unroll
        for (int k4 = 0; k4 < C::BK; k4 += 4) {
          float4 b[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            b[j] = *reinterpret_cast<const float4*>(b_row + 8 * j * C::LD + k4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(a_row + 4 * i * C::LD + k4);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float s = __fmaf_rn(a.x, b[j].x, acc[i][j]);
              s = __fmaf_rn(a.y, b[j].y, s);
              s = __fmaf_rn(a.z, b[j].z, s);
              acc[i][j] = __fmaf_rn(a.w, b[j].w, s);
            }
          }
        }
      });

  float* S = ring;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) S[(wr + 4 * i) * C::SLD + wc + 8 * j] = acc[i][j];
  __syncthreads();
  store_block_f64<float, BM, C::SLD, C::THREADS>(S, out, m, row0, col0);
}

__global__ void to_fp32_kernel(const double2* __restrict__ src, float2* __restrict__ dst,
                               long long n2) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n2;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const double2 v = src[i];
    dst[i] = make_float2(__double2float_rn(v.x), __double2float_rn(v.y));
  }
}

// the (hi, lo, accum) pairs of mp_syrk_launch
enum Pair { kF32Bf16 = 0, kF32F32 = 1, kF64F32 = 2, kF64F64 = 3 };

// The grid of the kernels with BM x BM blocks: with an all-hi pair every tile
// is in the band.
Grid make_grid(int m, int tile, int band_blocks, int pair, int bm) {
  const int n_tiles = m / tile;
  const bool split = pair == kF32Bf16 || pair == kF64F32;
  return Grid{tile / bm, n_tiles,
              split ? (band_blocks < n_tiles ? band_blocks : n_tiles) : n_tiles};
}

// a grid-stride pass over n elements: at most 16 blocks per SM
unsigned pass_blocks(long long n) {
  const long long blocks = (n + 255) / 256;
  return static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
}

// a kernel with `smem` bytes of dynamic shared memory over `blocks` blocks
template <typename K, typename... Args>
cudaError_t launch_ring(K kernel, long long blocks, int threads, int smem, cudaStream_t stream,
                        Args... args) {
  if (blocks == 0) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_band(const float* p, float* out, int m, int kdim, Grid g, long long n_band,
                        cudaStream_t stream) {
  if (n_band == 0) return cudaSuccess;
  syrk_band_lower_kernel<BM>
      <<<static_cast<unsigned>(n_band), kSimtThreads, 0, stream>>>(p, out, m, kdim, g);
  return cudaGetLastError();
}

// the fp32-hi pairs: the fp32 band kernel, then (bf16 pair) P as bf16 and
// the wgmma kernel
template <int BM>
cudaError_t launch_fp32_hi(const float* p, __nv_bfloat16* scratch, float* out, int m, int kdim,
                           int round_k, Grid g, long long n_band, long long n_off,
                           cudaStream_t stream) {
  cudaError_t err = launch_band<BM>(p, out, m, kdim, g, n_band, stream);
  if (err != cudaSuccess || n_off == 0) return err;
  const long long n4 = static_cast<long long>(m) * kdim / 4;
  to_bf16_kernel<<<pass_blocks(n4), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<uint2*>(scratch), n4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kdim), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kdim) * 2};
  const cuuint32_t box[2] = {KC, BM};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (cuTensorMapEncodeTiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, scratch, dims, strides,
                             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (round_k == kdim)
    return launch_ring(syrk_offband_bf16_wgmma_kernel<BM, true>, n_off, OffCfg<BM>::THREADS,
                       OffCfg<BM>::SMEM, stream, map, out, m, kdim, round_k, g);
  return launch_ring(syrk_offband_bf16_wgmma_kernel<BM, false>, n_off, OffCfg<BM>::THREADS,
                     OffCfg<BM>::SMEM, stream, map, out, m, kdim, round_k, g);
}

// the fp64-hi pairs: the fp64 band on DMMA, then (pair 2) P as fp32 and the
// fp32 off-band kernel
template <int BM>
cudaError_t launch_fp64_hi(const double* p, float* scratch, double* out, int m, int kdim, Grid g,
                           long long n_band, long long n_off, cudaStream_t stream) {
  cudaError_t err = launch_ring(syrk_band_f64_dmma_kernel<BM>, n_band, DmmaCfg<BM>::THREADS,
                                DmmaCfg<BM>::SMEM, stream, p, out, m, kdim, g);
  if (err != cudaSuccess || n_off == 0) return err;
  const long long n2 = static_cast<long long>(m) * kdim / 2;
  to_fp32_kernel<<<pass_blocks(n2), 256, 0, stream>>>(
      reinterpret_cast<const double2*>(p), reinterpret_cast<float2*>(scratch), n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ring(syrk_offband_fp32_pipelined_kernel<BM>, n_off, F32Cfg<BM>::THREADS,
                     F32Cfg<BM>::SMEM, stream, static_cast<const float*>(scratch), out, m, kdim,
                     g);
}


// ---- the backward: dP = S P, S = L(dU) + L(dU)^T --------------------------
// It has no TPU counterpart (the JAX package differentiates its jnp
// engines).  Row r of tile row ti takes S[r][j] from dU's lower tiles:
// dU[r][j] left of the diagonal tile (K-major), dU[j][r] right of it
// (MN-major), D + D^T in the diagonal tile D = dU[ti][ti].  The rounding
// points are ref.mp_syrk_grad's: the band (|ti - tj| < band) is S_band P in
// hi; off the band each S element (one dU element, since band >= 1) and P
// are rounded to lo, the products summed in fp32 and the sum rounded once
// to lo; dP = hi(band) + hi(lo(off)).
//
// What bounds it at the tile path's step 0 (39,936 x 1,024, band 2): 2 m^2
// kdim = 3.27 TFLOP, of which 0.25 in the band; under {fp32, bf16} the
// band's fp32 operations (67 TFLOP/s), the off-band's bf16 ones at 989
// below them; under the paper pair its IEEE fp32 off-band (67 on the CUDA
// cores) beside an fp64 band on the tensor cores (DMMA, 67 too); all-hi
// pairs their one class.  The design is the forward's three engines, each
// adapted from U = P P^T to dP = S P (K along the m axis, B = rows of P):
//   * a pre-pass per call writes D + D^T in hi for every diagonal tile
//     (mp_syrk_grad_diag_kernel), and under the split pairs lo(dU) for
//     every lower off-band tile, packed tile by tile in row order
//     (mp_syrk_grad_lo_tiles_kernel), and lo(P) (mp_syrk_grad_lo_p_kernel:
//     transposed to (kdim, m) for bf16, so that wgmma's B is K-major);
//   * the {fp32, bf16} off-band on bf16 wgmma fed by TMA
//     (mp_syrk_grad_offband_wgmma_kernel): a producer warp, a ring of 4
//     stages of 64 columns of K and mbarriers, as the forward's kernel.  A
//     tile left of the band is a K-major box of its packed lo tile; a tile
//     right of it is the packed tile (tj, ti) read MN-major, two boxes of
//     64 rows, through wgmma's transpose bit.  The tensor cores sum 4
//     stages (256 products a term) into one accumulator, which is added
//     with IEEE fp32 adds into a second: their internal alignment then
//     touches only short partial sums, whatever the K length (39,936);
//   * the fp64 band (the pair, all-fp64) on DMMA, mma.sync m16n8k4 .f64
//     (mp_syrk_grad_dmma_kernel), a 4-stage cp.async ring, both operands
//     staged [k][row] with rows 4 doubles longer than the block, so that
//     fragment loads and the 8-byte copies that transpose a tile left of
//     the diagonal meet no bank conflict;
//   * IEEE fp32 on the CUDA cores (mp_syrk_grad_fp32_kernel): the fp32 band
//     ({fp32, bf16}, all-fp32) from dU and P, and the paper pair's off-band
//     from the lo scratch: a 4-stage cp.async ring of 32 columns of K, 8 x
//     8 outputs a thread (rows in two groups of 4, 16 apart; columns in two
//     groups of 4, 32 apart), so that a warp's 16-byte loads of A are 64
//     contiguous bytes and of B 128: one wavefront each; tiles left of the
//     diagonal are transposed by 4-byte copies, 4 rows x 8 columns a warp,
//     without bank conflicts.  No TF32.  (Staging fp64 dU for the pair and
//     rounding it in shared memory, with no fp32 copy, measured 21 %
//     slower at step 0.)
// Every block is 128 x 128 outputs of dP (64 where the tile or kdim is not
// a multiple of 128), its kdim / BN column blocks next to each other so
// that they share their rows of S in L2.  The class with an off-band writes
// hi(lo(off)) into dP first (0 for a row with none); the band's kernel
// then adds its hi sum in its epilogue, or writes it when the call has no
// off-band.  No atomics: the same bits on every launch.  Only dU's lower
// tiles are read.

// Lower off-band tiles (a, b), a - b >= band, packed in row order: the
// x = a - band rows before row a hold x (x + 1) / 2 of them.
__host__ __device__ __forceinline__ long long tri(long long x) { return x * (x + 1) / 2; }
__host__ __device__ __forceinline__ long long packed_index(int a, int b, int band) {
  return tri(a - band) + b;
}

// ---- the pre-pass --------------------------------------------------------
__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* src, double (&v)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(src);
  const double2 y = *reinterpret_cast<const double2*>(src + 2);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}
__device__ __forceinline__ void store4_lo(__nv_bfloat16* dst, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}
__device__ __forceinline__ void store4_lo(float* dst, const double (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(__double2float_rn(v[0]), __double2float_rn(v[1]),
                                                __double2float_rn(v[2]), __double2float_rn(v[3]));
}
__device__ __forceinline__ float to_lo(float x) { return round_bf16(x); }
__device__ __forceinline__ float to_lo(double x) { return __double2float_rn(x); }

constexpr int kPassThreads = 256;
constexpr int kPassElems = 4 * 4 * kPassThreads;  // elements of a tile per block and step

// lo(dU[a][b]) for every packed tile q = packed_index(a, b): blockIdx.y
// walks the tiles, blockIdx.x the 4,096-element runs of one
template <typename Hi, typename Lo>
__global__ void __launch_bounds__(kPassThreads)
mp_syrk_grad_lo_tiles_kernel(const Hi* __restrict__ g, Lo* __restrict__ out, int m, int tile,
                             int band, long long n_packed) {
  const long long tt = static_cast<long long>(tile) * tile;
  for (long long q = blockIdx.y; q < n_packed; q += gridDim.y) {
    long long x = static_cast<long long>((sqrt(8.0 * static_cast<double>(q) + 1.0) - 1.0) / 2.0);
    while (tri(x) > q) --x;
    while (tri(x + 1) <= q) ++x;
    const long long a = x + band, b = q - tri(x);
    const Hi* src = g + a * tile * m + b * tile;
    Lo* dst = out + q * tt;
    for (long long e = (blockIdx.x * static_cast<long long>(kPassThreads) + threadIdx.x) * 4;
         e < tt; e += static_cast<long long>(gridDim.x) * kPassThreads * 4) {
      const long long r = e / tile, c = e % tile;
      Hi v[4];
      load4(src + r * m + c, v);
      store4_lo(dst + e, v);
    }
  }
}

// D + D^T in hi for every diagonal tile, 32 x 32 at a time through shared
// memory: dd[i][r][c] = D[r][c] + D[c][r], D = dU[i][i]
template <typename Hi>
__global__ void __launch_bounds__(256)
mp_syrk_grad_diag_kernel(const Hi* __restrict__ g, Hi* __restrict__ dd, int m, int tile) {
  __shared__ Hi t[32][33];
  const int i = blockIdx.z, r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const Hi* d = g + static_cast<long long>(i) * tile * m + static_cast<long long>(i) * tile;
  for (int y = ty; y < 32; y += 8) t[y][tx] = d[static_cast<long long>(c0 + y) * m + r0 + tx];
  __syncthreads();
  Hi* o = dd + static_cast<long long>(i) * tile * tile;
  for (int y = ty; y < 32; y += 8)
    o[static_cast<long long>(r0 + y) * tile + c0 + tx] =
        d[static_cast<long long>(r0 + y) * m + c0 + tx] + t[tx][y];
}

// lo(P), 32 x 32 at a time: transposed to (kdim, m) when TRANS (bf16 for
// wgmma's K-major B), else in P's (m, kdim) layout
template <typename Hi, typename Lo, bool TRANS>
__global__ void __launch_bounds__(256)
mp_syrk_grad_lo_p_kernel(const Hi* __restrict__ p, Lo* __restrict__ out, int m, int kdim) {
  __shared__ float t[32][33];
  const int j0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int y = ty; y < 32; y += 8) {
    const float v = to_lo(p[static_cast<long long>(j0 + y) * kdim + c0 + tx]);
    if constexpr (TRANS) t[y][tx] = v;
    else out[static_cast<long long>(j0 + y) * kdim + c0 + tx] = v;
  }
  if constexpr (TRANS) {
    __syncthreads();
    for (int y = ty; y < 32; y += 8)
      out[static_cast<long long>(c0 + y) * m + j0 + tx] = __float2bfloat16_rn(t[tx][y]);
  }
}

// ---- staging for the cp.async engines ------------------------------------
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src), "n"(N)
               : "memory");
}

// dst[kk][mm] (row length LD) = src[kk * ld + mm], ROWS x COLS: 16-byte
// copies, neighbouring threads on neighbouring bytes of a row
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void stage_natural(T* dst, const T* src, long long ld) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = COLS / V;
  static_assert(ROWS * CH % THREADS == 0 && LD % V == 0, "staging shapes");
#pragma unroll
  for (int l = 0; l < ROWS * CH / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / CH, c = (idx % CH) * V;
    cp_async16(dst + r * LD + c, src + r * ld + c);
  }
}

// dst[kk][mm] = src[mm * ld + kk]: one element per copy, each 32 of them
// 4 rows mm x 8 columns kk, so that with LD = 4 (mod 32) floats (mod 16
// doubles) the stores of a warp (half-warp) fall in distinct banks
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void stage_transposed(T* dst, const T* src, long long ld) {
  static_assert(ROWS % 8 == 0 && COLS % 4 == 0 && ROWS * COLS % THREADS == 0 && THREADS % 32 == 0,
                "staging shapes");
#pragma unroll
  for (int l = 0; l < ROWS * COLS / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int grp = idx / 32, ln = idx % 32;
    const int mm = 4 * (grp % (COLS / 4)) + ln % 4, kk = 8 * (grp / (COLS / 4)) + ln / 4;
    cp_async_ca<sizeof(T)>(dst + kk * LD + mm, src + mm * ld + kk);
  }
}

// The K loop over a ring of STAGES stages: fill(kt, stage) stages chunk kt,
// consume(stage) reads one; STAGES - 1 chunks in flight.  Returns with
// every copy landed and every thread past its last read.
template <int STAGES, typename Fill, typename Consume>
__device__ __forceinline__ void grad_ring_loop(int nkt, Fill&& fill, Consume&& consume) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) fill(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kt has landed for every thread; kt - 1 is read
    if (kt + STAGES - 1 < nkt) fill(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    consume(kt % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Where the block (rows r0 .. r0 + BM of tile row ti) finds chunk j of K
// (the S columns j .. j + BK, all in one tile tj): the A operand staged
// [k][row] and the B operand P[j ..][c0 ..].
struct GradBlock {
  int r0, c0, ti, rl;  // first row, first column, tile row, first row within the tile
  int n_t, b0, b1;     // tiles, the band's K range [b0, b1)
};

__device__ __forceinline__ GradBlock grad_block(int bm, int bn, int m, int kdim, int tile,
                                                int band) {
  const int nbn = kdim / bn;
  GradBlock b;
  b.r0 = (blockIdx.x / nbn) * bm;
  b.c0 = (blockIdx.x % nbn) * bn;
  b.ti = b.r0 / tile;
  b.rl = b.r0 - b.ti * tile;
  b.n_t = m / tile;
  b.b0 = max(0, b.ti - band + 1) * tile;
  b.b1 = min(b.n_t, b.ti + band) * tile;
  return b;
}

// ---- IEEE fp32 on the CUDA cores -----------------------------------------
template <int BM, int BN>
struct GradF32Cfg {
  static constexpr int WARPS_M = BM / 32, WARPS_N = BN / 64;  // warp tile 32 x 64
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int BK = 32;                        // K columns per stage
  static constexpr int LDA = BM + 4, LDB = BN + 4;     // = 4 (mod 32)
  static constexpr int STAGES = 4;
  static constexpr int STAGE = BK * (LDA + LDB);       // floats
  static constexpr int SMEM = STAGES * STAGE * 4;
};

// OFF: the paper pair's off-band (A the packed lo tiles, B lo(P), fp64 out,
// written); else the fp32 band (A from dU and the D + D^T tiles, B = P,
// fp32 out, added when `add`)
template <int BM, int BN, bool OFF>
__global__ void __launch_bounds__(GradF32Cfg<BM, BN>::THREADS, 1)
mp_syrk_grad_fp32_kernel(const float* __restrict__ a_src, const float* __restrict__ dd,
                         const float* __restrict__ p, void* __restrict__ out, int m, int kdim,
                         int tile, int band, int add) {
  using C = GradF32Cfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const GradBlock blk = grad_block(BM, BN, m, kdim, tile, band);
  const long long tt = static_cast<long long>(tile) * tile;
  // K chunks: the band [b0, b1), or the off-band [0, b0) then [b1, m)
  const int nl = OFF ? blk.b0 / C::BK : 0;
  const int nkt = OFF ? (blk.b0 + m - blk.b1) / C::BK : (blk.b1 - blk.b0) / C::BK;

  auto fill = [&](int kt, int s) {
    float* A = ring + s * C::STAGE;
    float* B = A + C::BK * C::LDA;
    const int j = OFF ? (kt < nl ? kt * C::BK : blk.b1 + (kt - nl) * C::BK) : blk.b0 + kt * C::BK;
    const int tj = j / tile, jl = j - tj * tile;
    if constexpr (OFF) {
      if (tj < blk.ti)  // packed tile (ti, tj) as it is: [row][k]
        stage_transposed<float, C::BK, BM, C::LDA, C::THREADS>(
            A, a_src + packed_index(blk.ti, tj, band) * tt + static_cast<long long>(blk.rl) * tile + jl,
            tile);
      else              // packed tile (tj, ti): [k][row]
        stage_natural<float, C::BK, BM, C::LDA, C::THREADS>(
            A, a_src + packed_index(tj, blk.ti, band) * tt + static_cast<long long>(jl) * tile + blk.rl,
            tile);
    } else {
      if (tj < blk.ti)
        stage_transposed<float, C::BK, BM, C::LDA, C::THREADS>(
            A, a_src + static_cast<long long>(blk.r0) * m + j, m);
      else if (tj == blk.ti)
        stage_natural<float, C::BK, BM, C::LDA, C::THREADS>(
            A, dd + blk.ti * tt + static_cast<long long>(jl) * tile + blk.rl, tile);
      else
        stage_natural<float, C::BK, BM, C::LDA, C::THREADS>(
            A, a_src + static_cast<long long>(j) * m + blk.r0, m);
    }
    stage_natural<float, C::BK, BN, C::LDB, C::THREADS>(
        B, p + static_cast<long long>(j) * kdim + blk.c0, kdim);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ar = (warp % C::WARPS_M) * 32 + (lane / 8) * 4;  // rows ar + i, ar + 16 + i
  const int bc = (warp / C::WARPS_M) * 64 + (lane % 8) * 4;  // cols bc + j, bc + 32 + j
  float acc[8][8] = {};
  grad_ring_loop<C::STAGES>(nkt, fill, [&](int s) {
    const float* A = ring + s * C::STAGE;
    const float* B = A + C::BK * C::LDA;
#pragma unroll 8
    for (int kk = 0; kk < C::BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + kk * C::LDA + ar);
      const float4 a1 = *reinterpret_cast<const float4*>(A + kk * C::LDA + ar + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(B + kk * C::LDB + bc);
      const float4 b1 = *reinterpret_cast<const float4*>(B + kk * C::LDB + bc + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = __fmaf_rn(a[i], b[jj], acc[i][jj]);
    }
  });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = blk.r0 + ar + (i < 4 ? i : 12 + i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = row * kdim + blk.c0 + bc + 32 * h;
      const float* v = &acc[i][4 * h];
      if constexpr (OFF) {  // lo = fp32: the fp32 sum is its own rounding
        double* d = static_cast<double*>(out) + o;
        *reinterpret_cast<double2*>(d) = make_double2(v[0], v[1]);
        *reinterpret_cast<double2*>(d + 2) = make_double2(v[2], v[3]);
      } else {
        float4* d = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
        float4 x = make_float4(v[0], v[1], v[2], v[3]);
        if (add) {
          const float4 y = *d;
          x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
        }
        *d = x;
      }
    }
  }
}

// ---- the fp64 band on DMMA -----------------------------------------------
template <int BM, int BN>
struct GradDmmaCfg {
  static constexpr int WM = BM == 128 ? 64 : 32, WN = 32;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;           // m16n8 tiles of a warp
  static constexpr int WARPS_M = BM / WM;
  static constexpr int THREADS = WARPS_M * (BN / WN) * 32;
  static constexpr int BK = 16;                     // K columns per stage
  static constexpr int LDA = BM + 4, LDB = BN + 4;  // = 4 (mod 16) doubles
  static constexpr int STAGES = 4;
  static constexpr int STAGE = BK * (LDA + LDB);    // doubles
  static constexpr int SMEM = STAGES * STAGE * 8;
};

template <int BM, int BN>
__global__ void __launch_bounds__(GradDmmaCfg<BM, BN>::THREADS, 1)
mp_syrk_grad_dmma_kernel(const double* __restrict__ g, const double* __restrict__ dd,
                         const double* __restrict__ p, double* __restrict__ out, int m, int kdim,
                         int tile, int band, int add) {
  using C = GradDmmaCfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  const GradBlock blk = grad_block(BM, BN, m, kdim, tile, band);
  const long long tt = static_cast<long long>(tile) * tile;
  const int nkt = (blk.b1 - blk.b0) / C::BK;

  auto fill = [&](int kt, int s) {
    double* A = ring + s * C::STAGE;
    double* B = A + C::BK * C::LDA;
    const int j = blk.b0 + kt * C::BK;
    const int tj = j / tile, jl = j - tj * tile;
    if (tj < blk.ti)
      stage_transposed<double, C::BK, BM, C::LDA, C::THREADS>(
          A, g + static_cast<long long>(blk.r0) * m + j, m);
    else if (tj == blk.ti)
      stage_natural<double, C::BK, BM, C::LDA, C::THREADS>(
          A, dd + blk.ti * tt + static_cast<long long>(jl) * tile + blk.rl, tile);
    else
      stage_natural<double, C::BK, BM, C::LDA, C::THREADS>(
          A, g + static_cast<long long>(j) * m + blk.r0, m);
    stage_natural<double, C::BK, BN, C::LDB, C::THREADS>(
        B, p + static_cast<long long>(j) * kdim + blk.c0, kdim);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % C::WARPS_M) * C::WM, wn = (warp / C::WARPS_M) * C::WN;
  const int gq = lane / 4, tq = lane % 4;
  double acc[C::MT][C::NT][4] = {};
  grad_ring_loop<C::STAGES>(nkt, fill, [&](int s) {
    const double* A = ring + s * C::STAGE;
    const double* B = A + C::BK * C::LDA;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 4) {
      const double* ak = A + (kk + tq) * C::LDA + wm + gq;
      const double* bk = B + (kk + tq) * C::LDB + wn + gq;
      double a[C::MT][2], b[C::NT];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        a[i][0] = ak[16 * i];
        a[i][1] = ak[16 * i + 8];
      }
#pragma unroll
      for (int jj = 0; jj < C::NT; ++jj) b[jj] = bk[8 * jj];
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int jj = 0; jj < C::NT; ++jj) dmma_m16n8k4(acc[i][jj], a[i], b[jj]);
    }
  });

#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int jj = 0; jj < C::NT; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = blk.r0 + wm + 16 * i + gq + 8 * h;
        double2* d = reinterpret_cast<double2*>(out + row * kdim + blk.c0 + wn + 8 * jj + 2 * tq);
        double2 x = make_double2(acc[i][jj][2 * h], acc[i][jj][2 * h + 1]);
        if (add) {
          const double2 y = *d;
          x = make_double2(x.x + y.x, x.y + y.y);
        }
        *d = x;
      }
}

// ---- the {fp32, bf16} off-band on bf16 wgmma -----------------------------
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of an MN-major tile written by TMA with the 128-byte
// swizzle: K rows of 64 bf16 (128 bytes), 8-row groups 1,024 bytes apart;
// one 64-element MN atom, so the leading offset (the next atom) is unused
// and holds the same 1,024.  Advancing K by 16 rows adds 2,048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t(1024 >> 4) << 16;
  d |= uint64_t(1024 >> 4) << 32;
  d |= uint64_t(1) << 62;
  return d;
}

template <int BM, int BN>
struct GradWgCfg {
  static constexpr int NWG = BM / 64;             // consumer warpgroups, 64 rows each
  static constexpr int THREADS = NWG * 128 + 32;  // and one producer warp
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = BM * KC * 2;     // K-major BM x 64, or BM / 64 MN-major 64 x 64
  static constexpr int B_BYTES = BN * KC * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static constexpr int FLUSH = 4;                 // stages summed in the tensor cores per IEEE add
};

template <int BM, int BN>
__global__ void __launch_bounds__(GradWgCfg<BM, BN>::THREADS, 1)
mp_syrk_grad_offband_wgmma_kernel(const __grid_constant__ CUtensorMap smap_k,
                                  const __grid_constant__ CUtensorMap smap_mn,
                                  const __grid_constant__ CUtensorMap pmap,
                                  float* __restrict__ dp, int m, int kdim, int tile, int band) {
  using C = GradWgCfg<BM, BN>;
  constexpr int R = BN / 2;  // accumulator registers per thread (64 x BN per warpgroup)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  const GradBlock blk = grad_block(BM, BN, m, kdim, tile, band);
  const int per_tile = tile / KC;
  const int nlc = blk.b0 / KC;                   // chunks left of the band
  const int n = nlc + (m - blk.b1) / KC;         // and right of it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == C::NWG * 4) {  // the producer warp: one thread issues the loads
    if (lane == 0) {
      for (int kc = 0; kc < n; ++kc) {
        const int s = kc % C::STAGES;
        if (kc >= C::STAGES) mbar_wait(&empty[s], (kc / C::STAGES - 1) & 1);
        uint8_t* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        const bool left = kc < nlc;
        const int x = left ? kc : kc - nlc;
        const int tj = left ? x / per_tile : blk.ti + band + x / per_tile;
        const int k0 = (x % per_tile) * KC;
        if (left) {
          tma_load_3d(st, &smap_k, &full[s], k0, blk.rl,
                      static_cast<int>(packed_index(blk.ti, tj, band)));
        } else {
          const int q = static_cast<int>(packed_index(tj, blk.ti, band));
#pragma unroll
          for (int h = 0; h < C::NWG; ++h)
            tma_load_3d(st + h * 64 * 128, &smap_mn, &full[s], blk.rl + 64 * h, k0, q);
        }
        tma_load_2d(st + C::A_BYTES, &pmap, &full[s], tj * tile + k0, blk.c0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. wg * 64 + 63 of the block
  const int wg = warp / 4;
  float acc[R], total[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = total[i] = 0.f;
  for (int kc = 0; kc < n; ++kc) {
    const int s = kc % C::STAGES;
    mbar_wait(&full[s], (kc / C::STAGES) & 1);
    const uint8_t* st = ring + s * C::STAGE_BYTES;
    const uint64_t db = smem_desc(st + C::A_BYTES);
    const bool fresh = kc % C::FLUSH == 0;
    fence_regs(acc);
    wgmma_fence();
    if (kc < nlc) {  // K-major A: the next 16 columns are 32 bytes on
      const uint64_t da = smem_desc(st + wg * 64 * 128);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_bf16<BN, 0>(acc, da + 2 * kk, db + 2 * kk, (fresh && kk == 0) ? 0 : 1);
    } else {         // MN-major A: the next 16 K rows are 2,048 bytes on
      const uint64_t da = smem_desc_mn(st + wg * 64 * 128);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_bf16<BN, 1>(acc, da + 128 * kk, db + 2 * kk, (fresh && kk == 0) ? 0 : 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: free its stage
    fence_regs(acc);
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(kc - 1) % C::STAGES]);
    if ((kc + 1) % C::FLUSH == 0 || kc + 1 == n) {  // IEEE fp32 adds of the partial
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < R; ++i) total[i] += acc[i];
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: the sum rounded once to bf16, stored as fp32, straight from
  // the registers (lane pairs of columns)
  const int w = warp % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = blk.r0 + wg * 64 + w * 16 + lane / 4 + 8 * h;
      const int col = blk.c0 + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(dp + row * kdim + col) =
          make_float2(round_bf16(total[4 * j + 2 * h]), round_bf16(total[4 * j + 2 * h + 1]));
    }
}

// ---- the backward's launch -----------------------------------------------
// The scratch of one call, each part 1,024-byte aligned: the D + D^T tiles
// (n_t tile^2 in hi), then under the split pairs with an off-band the
// packed lo tiles (n_packed tile^2 in lo) and lo(P) (m kdim in lo).
// kernels/mp_gemm/mp_gemm.py:grad_scratch_layout computes the same.
struct GradScratch {
  long long dd, s_lo, p_lo, total;
};

inline long long align1k(long long x) { return (x + 1023) / 1024 * 1024; }

GradScratch grad_scratch(int m, int kdim, int tile, int pair, long long n_packed) {
  const long long hi = pair == kF32Bf16 || pair == kF32F32 ? 4 : 8;
  const long long lo = pair == kF32Bf16 ? 2 : 4;
  const long long tt = static_cast<long long>(tile) * tile;
  GradScratch sc{0, 0, 0, 0};
  sc.total = static_cast<long long>(m / tile) * tt * hi;
  if (n_packed > 0) {
    sc.s_lo = align1k(sc.total);
    sc.p_lo = align1k(sc.s_lo + n_packed * tt * lo);
    sc.total = sc.p_lo + static_cast<long long>(m) * kdim * lo;
  }
  return sc;
}

template <typename Hi>
cudaError_t launch_grad_prepass(const Hi* g, Hi* dd, int m, int tile, cudaStream_t stream) {
  mp_syrk_grad_diag_kernel<Hi><<<dim3(tile / 32, tile / 32, m / tile), 256, 0, stream>>>(
      g, dd, m, tile);
  return cudaGetLastError();
}

template <typename Hi, typename Lo, bool TRANS>
cudaError_t launch_grad_lo(const Hi* g, const Hi* p, Lo* s_lo, Lo* p_lo, int m, int kdim,
                           int tile, int band, long long n_packed, cudaStream_t stream) {
  const long long tt = static_cast<long long>(tile) * tile;
  const unsigned runs = static_cast<unsigned>((tt + kPassElems - 1) / kPassElems);
  const unsigned tiles = static_cast<unsigned>(n_packed < 65535 ? n_packed : 65535);
  mp_syrk_grad_lo_tiles_kernel<Hi, Lo><<<dim3(runs, tiles), kPassThreads, 0, stream>>>(
      g, s_lo, m, tile, band, n_packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mp_syrk_grad_lo_p_kernel<Hi, Lo, TRANS><<<dim3(m / 32, kdim / 32), 256, 0, stream>>>(
      p, p_lo, m, kdim);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled for a bf16 tensor with the 128-byte swizzle
bool bf16_map(CUtensorMap* map, void* base, cuuint32_t rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, dims, strides,
                                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
cudaError_t launch_grad_bf16_off(__nv_bfloat16* s_lo, __nv_bfloat16* pt_lo, float* dp, int m,
                                 int kdim, int tile, int band, long long n_packed,
                                 cudaStream_t stream) {
  CUtensorMap smap_k, smap_mn, pmap;
  const cuuint64_t sdims[3] = {static_cast<cuuint64_t>(tile), static_cast<cuuint64_t>(tile),
                               static_cast<cuuint64_t>(n_packed)};
  const cuuint64_t sstrides[2] = {static_cast<cuuint64_t>(tile) * 2,
                                  static_cast<cuuint64_t>(tile) * tile * 2};
  const cuuint32_t box_k[3] = {KC, BM, 1}, box_mn[3] = {64, KC, 1};
  const cuuint64_t pdims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(kdim)};
  const cuuint64_t pstrides[1] = {static_cast<cuuint64_t>(m) * 2};
  const cuuint32_t pbox[2] = {KC, BN};
  if (!bf16_map(&smap_k, s_lo, 3, sdims, sstrides, box_k) ||
      !bf16_map(&smap_mn, s_lo, 3, sdims, sstrides, box_mn) ||
      !bf16_map(&pmap, pt_lo, 2, pdims, pstrides, pbox))
    return cudaErrorInvalidValue;
  using C = GradWgCfg<BM, BN>;
  return launch_ring(mp_syrk_grad_offband_wgmma_kernel<BM, BN>,
                     static_cast<long long>(m / BM) * (kdim / BN), C::THREADS, C::SMEM, stream,
                     smap_k, smap_mn, pmap, dp, m, kdim, tile, band);
}

template <int BM, int BN>
cudaError_t launch_grad_engines(const void* g, const void* p, void* dp, const GradScratch& sc,
                                uint8_t* scratch, int m, int kdim, int tile, int band, int pair,
                                long long n_packed, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(m / BM) * (kdim / BN);
  const int add = n_packed > 0;
  cudaError_t err;
  if (pair == kF32Bf16 || pair == kF32F32) {
    const auto* gg = static_cast<const float*>(g);
    const auto* pp = static_cast<const float*>(p);
    auto* dd = reinterpret_cast<float*>(scratch + sc.dd);
    if ((err = launch_grad_prepass(gg, dd, m, tile, stream)) != cudaSuccess) return err;
    if (add) {
      auto* s_lo = reinterpret_cast<__nv_bfloat16*>(scratch + sc.s_lo);
      auto* p_lo = reinterpret_cast<__nv_bfloat16*>(scratch + sc.p_lo);
      err = launch_grad_lo<float, __nv_bfloat16, true>(gg, pp, s_lo, p_lo, m, kdim, tile, band,
                                                       n_packed, stream);
      if (err == cudaSuccess)
        err = launch_grad_bf16_off<BM, BN>(s_lo, p_lo, static_cast<float*>(dp), m, kdim, tile,
                                           band, n_packed, stream);
      if (err != cudaSuccess) return err;
    }
    using C = GradF32Cfg<BM, BN>;
    return launch_ring(mp_syrk_grad_fp32_kernel<BM, BN, false>, blocks, C::THREADS, C::SMEM,
                       stream, gg, static_cast<const float*>(dd), pp, dp, m, kdim, tile, band,
                       add);
  }
  const auto* gg = static_cast<const double*>(g);
  const auto* pp = static_cast<const double*>(p);
  auto* dd = reinterpret_cast<double*>(scratch + sc.dd);
  if ((err = launch_grad_prepass(gg, dd, m, tile, stream)) != cudaSuccess) return err;
  if (add) {
    auto* s_lo = reinterpret_cast<float*>(scratch + sc.s_lo);
    auto* p_lo = reinterpret_cast<float*>(scratch + sc.p_lo);
    err = launch_grad_lo<double, float, false>(gg, pp, s_lo, p_lo, m, kdim, tile, band, n_packed,
                                               stream);
    if (err != cudaSuccess) return err;
    using C = GradF32Cfg<BM, BN>;
    err = launch_ring(mp_syrk_grad_fp32_kernel<BM, BN, true>, blocks, C::THREADS, C::SMEM, stream,
                      static_cast<const float*>(s_lo), static_cast<const float*>(nullptr),
                      static_cast<const float*>(p_lo), dp, m, kdim, tile, band, 0);
    if (err != cudaSuccess) return err;
  }
  using C = GradDmmaCfg<BM, BN>;
  return launch_ring(mp_syrk_grad_dmma_kernel<BM, BN>, blocks, C::THREADS, C::SMEM, stream, gg,
                     static_cast<const double*>(dd), pp, static_cast<double*>(dp), m, kdim, tile,
                     band, add);
}

}  // namespace

// p: (m, kdim) contiguous in hi (fp32 for pairs 0 and 1, fp64 for 2 and 3);
// scratch: (m, kdim) in lo (bf16 for pair 0, fp32 for pair 2), written here
// (may be null when the call has no off-band block); out: (m, m) contiguous
// in hi.  Requires tile % 64 == 0, m % tile == 0, round_k % 64 == 0,
// kdim % round_k == 0 and bm in {64, 128} dividing tile; bm is the block
// side of every kernel of the call.  Each kernel's grid is its number of
// lower blocks, from the same tile-row offsets its blocks use to find their
// (bi, bj).
extern "C" int mp_syrk_launch(const void* p, void* scratch, void* out, int m, int kdim,
                              int tile, int round_k, int band_blocks, int pair, int bm,
                              void* stream) {
  if (tile <= 0 || tile % 64 || m % tile || round_k <= 0 || round_k % KC || kdim % round_k ||
      band_blocks < 1 || (bm != 64 && bm != 128) || tile % bm || pair < 0 || pair > 3)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g = make_grid(m, tile, band_blocks, pair, bm);
  const long long n_band = band_row_start(g, g.n_tiles);
  const long long n_off = off_row_start(g, g.n_tiles);  // 0 for the all-hi pairs
  if (n_off > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  if (pair == kF32Bf16 || pair == kF32F32) {
    const float* pp = static_cast<const float*>(p);
    auto* sc = static_cast<__nv_bfloat16*>(scratch);
    float* o = static_cast<float*>(out);
    if (bm == 128) return launch_fp32_hi<128>(pp, sc, o, m, kdim, round_k, g, n_band, n_off, s);
    return launch_fp32_hi<64>(pp, sc, o, m, kdim, round_k, g, n_band, n_off, s);
  }
  const double* pp = static_cast<const double*>(p);
  auto* sc = static_cast<float*>(scratch);
  double* o = static_cast<double*>(out);
  if (bm == 128) return launch_fp64_hi<128>(pp, sc, o, m, kdim, g, n_band, n_off, s);
  return launch_fp64_hi<64>(pp, sc, o, m, kdim, g, n_band, n_off, s);
}

// g: dU (m, m) contiguous in hi, only its lower tiles read; p: (m, kdim)
// contiguous in hi; dp: (m, kdim) in hi, written here; scratch: at least
// scratch_bytes = grad_scratch(...).total bytes (the D + D^T tiles, the
// packed lo tiles and lo(P)), written here.  Requires tile % 64 == 0, m %
// tile == 0, kdim % 64 == 0 and m / 64 <= 65535; pair as mp_syrk_launch's.
// Blocks are BM x BN of dP: 128 where it divides the tile (kdim), else 64.
extern "C" int mp_syrk_grad_launch(const void* g, const void* p, void* dp, void* scratch,
                                   long long scratch_bytes, int m, int kdim, int tile,
                                   int band_blocks, int pair, void* stream) {
  if (tile <= 0 || tile % 64 || m <= 0 || m % tile || kdim <= 0 || kdim % 64 ||
      m / 64 > 65535 || kdim / 32 > 65535 || band_blocks < 1 || pair < 0 || pair > 3)
    return cudaErrorInvalidValue;
  const int n_tiles = m / tile;
  const bool split = pair == kF32Bf16 || pair == kF64F32;
  const int band = split && band_blocks < n_tiles ? band_blocks : n_tiles;
  const long long n_packed = tri(n_tiles - band);  // 0 for the all-hi pairs
  const GradScratch sc = grad_scratch(m, kdim, tile, pair, n_packed);
  if (scratch == nullptr || scratch_bytes < sc.total) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<uint8_t*>(scratch);
  const bool bm128 = tile % 128 == 0, bn128 = kdim % 128 == 0;
  if (bm128 && bn128)
    return launch_grad_engines<128, 128>(g, p, dp, sc, sp, m, kdim, tile, band, pair, n_packed, s);
  if (bm128)
    return launch_grad_engines<128, 64>(g, p, dp, sc, sp, m, kdim, tile, band, pair, n_packed, s);
  if (bn128)
    return launch_grad_engines<64, 128>(g, p, dp, sc, sp, m, kdim, tile, band, pair, n_packed, s);
  return launch_grad_engines<64, 64>(g, p, dp, sc, sp, m, kdim, tile, band, pair, n_packed, s);
}
