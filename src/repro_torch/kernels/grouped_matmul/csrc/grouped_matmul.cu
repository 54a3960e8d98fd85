// Grouped (per-expert) matrix product for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul/kernel.py
// (grouped_matmul_kernel, body _gmm_kernel): for every expert e,
// out[e] = x[e] @ w[e] with x (E, C, D), w (E, D, F), out (E, C, F), the sum
// over D taken in f32 and rounded once to x's dtype.
//
// What bounds it on this card: the MoE layer's capacity C is small against
// D and F. In a 4-slot decode step C = 2, so each call is a read of every
// expert's weights (33.6 MB at granite's widths, ~10 us at 3.35 TB/s): bound
// by bytes. At a 1024-token prefill C = 320, ~10.7 GFLOP against ~65 MB for
// the wi/wg products: still bound by bytes at the tensor-core rate
// (11 us of operations against 19 us of bytes). Every design here:
//   * runs the loop over D inside the block with f32 accumulators in
//     registers: the TPU's sequential fourth grid axis and its VMEM
//     accumulator become that loop;
//   * masks the ragged edges of C, D and F in the tile loads and the store,
//     so no padded copies of x or w are made (the TPU wrapper pads).
//
// bf16 (the serving path): two kernels on the tensor cores, bf16 operands
// and f32 accumulation, their tiles copied with 16-byte cp.async into a
// ring in shared memory (D and F are multiples of 8); the wrapper picks one
// by C (ops.py, STREAM_MAX_C):
//   * tile kernel (prefill, C > 16): wgmma. A block of one warpgroup owns
//     a 64 x 128 output tile and walks D in steps of 64 through a 3-stage
//     ring: x tiles K-major and w tiles MN-major (the transposed B
//     operand), both in 128-byte-swizzled rows. The C tiles of
//     one (expert, F tile) are neighbours in launch order, so the weight
//     stripe is read from device memory about once. What holds it back at
//     granite's prefill: every block reads its x and w tiles from the L2
//     (x once per F tile, w once per C tile: ~250 MB at C = 320 against
//     65 MB from device memory); sharing tiles between blocks (clusters,
//     TMA multicast) is the next step;
//   * streaming kernel (decode, C <= 16): the call is a read of every
//     expert's weights. One block streams a 64-column stripe of one
//     expert's w through a 6-stage ring (five 8 KB tiles in flight), with
//     x[e]'s C rows zero-filled to 16 in the same ring, and multiplies with
//     mma.sync.m16n8k16 (a 64-row wgmma would be 3/4 padding at C = 16).
//     Granite's decode calls give 256 (wi/wg) and 512 (wo) such blocks for
//     the 132 SMs, so every block walks the whole of D.
//
// The backward, bf16 (the training path): autograd's dx = dy . w^T and
// dw = x^T . dy, two launches of the tile kernel's body (gmm_dx_kernel,
// gmm_dw_kernel). What bounds it: at granite's training capacity
// (C = 2560, d 1024, f 512) the two products are ~172 GFLOP against ~200
// MB of x, w, dy, dx and dw: operations, 0.174 ms at the bf16 peak. The
// earlier design ran the forward kernel on contiguous copies of w^T and
// x^T (x^T alone 168 MB written and read again) and zero-padded C to a
// multiple of 8, so the copies cost more than the products' own reads.
// Here nothing is copied: wgmma takes a shared-memory operand K-major or
// MN-major (its transpose flag), so dx reads w's (d, f) rows as a K-major
// B (the contraction f is contiguous) and dw reads x as an MN-major A and
// dy as an MN-major B, all through the same swizzled cp.async ring; dw's
// contraction C is masked by zero-fill in the tile loads, so C need not
// be a multiple of 8. At C = 2560 a 64 x 128 dw tile walks 40 depth steps
// and the grid is 16 x 4 x 32 blocks.
//
// f32 (the parity runs, where TF32 would change tokens): f32 FMAs on the
// CUDA cores, one block per (expert, 64-row C tile, 64-column F tile); its
// backward (off the timed path) runs this kernel on transposed copies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
namespace f32 {

constexpr int BM = 64;          // rows of C per block
constexpr int BN = 64;          // columns of F per block
constexpr int BK = 32;          // depth of one D tile
constexpr int TPR = 16;         // 16 x 16 threads
constexpr int NT = TPR * TPR;
constexpr int RM = BM / TPR;    // rows per thread
constexpr int RN = BN / TPR;    // columns per thread

// Thread (ty, tx) owns output rows m0 + ty + 16 i and columns n0 + tx + 16 j.
__global__ void __launch_bounds__(NT)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ o, int C, int D, int F) {
  __shared__ float sX[BK][BM + 1];   // x tile, transposed; odd stride
  __shared__ float sW[BK][BN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / TPR, tx = tid % TPR;
  const float* xe = x + size_t(e) * C * D;
  const float* we = w + size_t(e) * D * F;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      sX[k][m] = (gm < C && gk < D) ? xe[size_t(gm) * D + gk] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      sW[k][n] = (gk < D && gn < F) ? we[size_t(gk) * F + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sX[k][ty + TPR * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = sW[k][tx + TPR * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* oe = o + size_t(e) * C * F;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty + TPR * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx + TPR * j;
      if (gn < F) oe[size_t(gm) * F + gn] = acc[i][j];
    }
  }
}

cudaError_t launch(const void* x, const void* w, void* o, int E, int C,
                   int D, int F, cudaStream_t stream) {
  if (E > 65535 || (C + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_f32_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(o), C, D, F);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 streaming kernel: mma.sync.m16n8k16 over a deep cp.async ring
namespace bf16stream {

using namespace mma_bf16;

constexpr int BM = 16;            // rows of C the kernel holds (C <= BM)
constexpr int BN = 64;            // columns of F a block: its weight stripe
constexpr int BK = 64;            // depth of one stage (128-byte rows)
constexpr int NWARP = 4;          // each warp 16 of the BN columns
constexpr int NT = NWARP * 32;
constexpr int STAGES = 6;         // five 8 KB weight tiles in flight
constexpr int LDA = BK + PAD, LDB = BN + PAD;
constexpr int STAGE_ELEMS = BM * LDA + BK * LDB;
constexpr size_t SMEM = sizeof(bf16) * STAGES * STAGE_ELEMS;

// x[e]'s C rows (zero-filled to BM) and the w stripe over depth k0.. into
// one stage; columns past D or F are zero-filled.
__device__ __forceinline__ void load_stage(bf16* st, const bf16* xe,
                                           const bf16* we, int n0, int k0,
                                           int C, int D, int F, int tid) {
  bf16* sA = st;
  bf16* sB = st + BM * LDA;
  constexpr int ACH = BM * BK / 8, BCH = BK * BN / 8;
  static_assert(ACH % NT == 0 && BCH % NT == 0, "even split");
#pragma unroll
  for (int j = 0; j < ACH / NT; ++j) {
    const int i = tid + j * NT, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const bool ok = r < C && k0 + c < D;
    cp_async16(sA + r * LDA + c, xe + (ok ? size_t(r) * D + k0 + c : 0), ok);
  }
#pragma unroll
  for (int j = 0; j < BCH / NT; ++j) {
    const int i = tid + j * NT, r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const bool ok = k0 + r < D && n0 + c < F;
    cp_async16(sB + r * LDB + c,
               we + (ok ? size_t(k0 + r) * F + n0 + c : 0), ok);
  }
}

// grid (F stripes, E). Warp w owns columns n0 + 16 w .. n0 + 16 w + 15 of
// all BM rows (two n8 blocks).
__global__ void __launch_bounds__(NT)
gmm_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ o, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, e = blockIdx.y;
  const int n_k = (D + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* xe = x + size_t(e) * C * D;
  const bf16* we = w + size_t(e) * D * F;

  float acc[2][4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;

  // prologue: STAGES - 1 tiles in flight (empty groups keep the count)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k)
      load_stage(smem + s * STAGE_ELEMS, xe, we, n0, s * BK, C, D, F, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt has landed; every warp is done with kt - 1
    const int nk = kt + STAGES - 1;   // into the stage kt - 1 used
    if (nk < n_k)
      load_stage(smem + (nk % STAGES) * STAGE_ELEMS, xe, we, n0, nk * BK, C,
                 D, F, tid);
    cp_async_commit();

    const bf16* sA = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* sB = sA + BM * LDA + warp * 16;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4], b0, b1, b2, b3;
      ldsm_x4(sA + (lane % 16) * LDA + kk * 16 + (lane / 16) * 8, a[0], a[1],
              a[2], a[3]);
      // B = the w stripe (depth rows, F contiguous): ldmatrix.trans
      ldsm_x4_t(sB + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDB +
                    (lane / 16) * 8,
                b0, b1, b2, b3);
      mma(acc[0], a, b0, b1);
      mma(acc[1], a, b2, b3);
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none behind

  // store rows < C (F % 8 == 0, so a thread's column pair is wholly in or
  // out)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = g + 8 * r;
    if (gm >= C) continue;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int gn = n0 + warp * 16 + nb * 8 + 2 * t;
      if (gn >= F) continue;
      *reinterpret_cast<uint32_t*>(o + (size_t(e) * C + gm) * F + gn) =
          pack_bf16(acc[nb][2 * r], acc[nb][2 * r + 1]);
    }
  }
}

cudaError_t launch(const void* x, const void* w, void* o, int E, int C,
                   int D, int F, cudaStream_t stream) {
  if (C > BM || E > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((F + BN - 1) / BN, E);
  gmm_stream_kernel<<<grid, NT, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(o), C, D, F);
  return cudaGetLastError();
}

}  // namespace bf16stream

// ---------------------------------------------------------------------------
// bf16 tile kernels: warpgroup tensor-core products (wgmma), cp.async ring.
// One body serves the forward and both gradients of the backward. They
// differ only in how each operand lies in device memory: K-major (its rows
// run along the contraction) or MN-major (its rows run along the output).
// wgmma reads either from shared memory, the MN-major one through the
// instruction's transpose, so every tensor is read where it lies:
//   forward  out (C, F) = x (C, D) . w (D, F)     A K-major,  B MN-major
//   dx       dx (C, D) = dy (C, F) . w^T          A K-major,  B K-major
//   dw       dw (D, F) = x^T . dy (C, F)          A MN-major, B MN-major
namespace bf16wg {

using namespace mma_bf16;

// One warpgroup a block (three blocks share an SM; two warpgroups sharing
// a 128-row tile were slower, though they read each w tile half as often)
constexpr int NT = 128;
constexpr int BM = 64;            // output rows a block
constexpr int BN = 128;           // output columns a block
constexpr int BK = 64;            // depth a stage: one 128-byte swizzle row
// 3 stages, each step's products waited for before the next copy is
// issued: three blocks share an SM and run out of step. (Four stages with
// one step's products left in flight, two blocks an SM, were no faster for
// the backward's dx and dw.)
constexpr int STAGES = 3;
constexpr int A_ELEMS = BM * BK;  // A tile, [BM][64] or [64][BM]
constexpr int B_ELEMS = BK * BN;  // B tile, [BN][64] or [BN / 64][BK][64]
// the stages and 1024 bytes of slack to align the swizzle blocks
constexpr size_t SMEM = sizeof(bf16) * STAGES * (A_ELEMS + B_ELEMS) + 1024;

// A K-major tile: rows r0.. of a (rows, K) row-major matrix, depth k0..,
// into [ROWS][64], 128-byte swizzled; rows past `rows` and depth past K
// zero-filled
template <int ROWS>
__device__ __forceinline__ void load_kmajor(bf16* dst, const bf16* src,
                                            int r0, int k0, int rows, int K,
                                            int tid) {
  static_assert(ROWS * 8 % NT == 0, "even split");
#pragma unroll
  for (int j = 0; j < ROWS * 8 / NT; ++j) {
    const int i = tid + j * NT, r = i / 8, c = i % 8;
    const bool ok = r0 + r < rows && k0 + c * 8 < K;
    cp_async16(dst + sw128(r, c),
               src + (ok ? size_t(r0 + r) * K + k0 + c * 8 : 0), ok);
  }
}

// An MN-major tile: depth rows k0.. of a (K, cols) row-major matrix,
// columns c0.., into [COLS / 64][BK][64], 128-byte swizzled; depth past K
// (a ragged contraction then adds nothing) and columns past `cols`
// zero-filled
template <int COLS>
__device__ __forceinline__ void load_mnmajor(bf16* dst, const bf16* src,
                                             int k0, int c0, int K, int cols,
                                             int tid) {
  static_assert(BK * COLS / 8 % NT == 0, "even split");
#pragma unroll
  for (int j = 0; j < BK * COLS / 8 / NT; ++j) {
    const int i = tid + j * NT, r = i / (COLS / 8), c = i % (COLS / 8);
    const bool ok = k0 + r < K && c0 + c * 8 < cols;
    cp_async16(dst + (c / 8) * BK * 64 + sw128(r, c % 8),
               src + (ok ? size_t(k0 + r) * cols + c0 + c * 8 : 0), ok);
  }
}

// Descriptor of one k16 step of a stage's tile: K-major, 32 bytes into the
// swizzle rows; MN-major, 16 rows down, its 64-column blocks BK rows apart
template <bool MN>
__device__ __forceinline__ uint64_t step_desc(const bf16* tile, int kk) {
  if constexpr (MN)
    return gmma_desc(tile + kk * 16 * 64, BK * 64 * sizeof(bf16), 1024);
  else
    return gmma_desc(tile + kk * 16, 16, 1024);
}

// out (M, N) = A (M x K) . B (K x N) for expert blockIdx.z, in a's dtype:
// A stored (M, K), or (K, M) if A_MN; B stored (N, K), or (K, N) if B_MN.
// grid (M tiles, N tiles, E), M tiles fastest: the blocks that share a B
// stripe run together. Warp w owns rows m0 + 16 w .. m0 + 16 w + 15, lane
// (g, t) rows g and g + 8 of those.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void tile_body(const bf16* __restrict__ a,
                                          const bf16* __restrict__ b,
                                          bf16* __restrict__ o, int M, int N,
                                          int K) {
  extern __shared__ unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int tid = threadIdx.x;
  const bf16* ae = a + size_t(e) * M * K;
  const bf16* be = b + size_t(e) * K * N;
  const int n_k = (K + BK - 1) / BK;
  auto stage_a = [&](int s) { return smem + s * (A_ELEMS + B_ELEMS); };
  auto stage_b = [&](int s) { return stage_a(s) + A_ELEMS; };
  auto load_stage = [&](int s, int k0) {
    if constexpr (A_MN) load_mnmajor<BM>(stage_a(s), ae, k0, m0, K, M, tid);
    else load_kmajor<BM>(stage_a(s), ae, m0, k0, M, K, tid);
    if constexpr (B_MN) load_mnmajor<BN>(stage_b(s), be, k0, n0, K, N, tid);
    else load_kmajor<BN>(stage_b(s), be, n0, k0, N, K, tid);
  };

  // prologue: STAGES - 1 tiles in flight (empty groups keep the count)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s * BK);
    cp_async_commit();
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();   // tile kt has landed; every warp is done with kt - 1
    const int nk = kt + STAGES - 1;   // into the stage kt - 1 used
    if (nk < n_k) load_stage(nk % STAGES, nk * BK);
    cp_async_commit();

    const bf16* sA = stage_a(kt % STAGES);
    const bf16* sB = stage_b(kt % STAGES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n128<int(A_MN), int(B_MN)>(acc, step_desc<A_MN>(sA, kk),
                                          step_desc<B_MN>(sB, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();   // only empty groups remain; leave none behind

  // store: rows past M and columns past N masked (N % 8 == 0, so a
  // thread's column pair is wholly in or out)
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row = m0 + (tid / 32) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = row + 8 * r;
    if (gm >= M) continue;
    bf16* orow = o + (size_t(e) * M + gm) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gn = n0 + 8 * j + 2 * t;
      if (gn < N)
        *reinterpret_cast<uint32_t*>(orow + gn) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// the forward: out (E, C, F) = x (E, C, D) . w (E, D, F)
__global__ void __launch_bounds__(NT)
gmm_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ o, int C, int D, int F) {
  tile_body<false, true>(x, w, o, C, F, D);
}

// dx (E, C, D) = dy (E, C, F) . w^T: w's rows (d) are the K-major B
__global__ void __launch_bounds__(NT)
gmm_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
              bf16* __restrict__ dx, int C, int D, int F) {
  tile_body<false, false>(dy, w, dx, C, D, F);
}

// dw (E, D, F) = x^T . dy: x (E, C, D) is the MN-major A, dy (E, C, F)
// the MN-major B, the contraction C masked
__global__ void __launch_bounds__(NT)
gmm_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
              bf16* __restrict__ dw, int C, int D, int F) {
  tile_body<true, true>(x, dy, dw, D, F, C);
}

// one of the three kernels over an (M tiles, N tiles, E) grid; every
// kernel takes its tensors and (C, D, F)
using TileKernel = void (*)(const bf16*, const bf16*, bf16*, int, int, int);

cudaError_t launch(TileKernel kernel, const void* a, const void* b, void* o,
                   int E, int C, int D, int F, int M, int N,
                   cudaStream_t stream) {
  if (E > 65535 || (N + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  kernel<<<grid, NT, SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(o), C, D, F);
  return cudaGetLastError();
}

}  // namespace bf16wg

bool bad_shape(int E, int C, int D, int F) {
  return E <= 0 || C <= 0 || D <= 0 || F <= 0;
}

}  // namespace

// x: (E, C, D), w: (E, D, F), o: (E, C, F), all contiguous, one dtype
// (0 = float32, 1 = bfloat16). bf16 runs the tile kernel (D and F multiples
// of 8). Returns the cudaError_t of the launch.
extern "C" int grouped_matmul_fwd(const void* x, const void* w, void* o,
                                  int dtype, int E, int C, int D, int F,
                                  void* stream) {
  if (bad_shape(E, C, D, F)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(f32::launch(x, w, o, E, C, D, F, st));
    case 1:
      if (D % 8 || F % 8) return int(cudaErrorInvalidValue);
      return int(bf16wg::launch(bf16wg::gmm_tile_kernel, x, w, o, E, C, D,
                                F, C, F, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// The bf16 streaming kernel, C <= 16: x, w, o as above.
extern "C" int grouped_matmul_stream_fwd(const void* x, const void* w,
                                         void* o, int E, int C, int D, int F,
                                         void* stream) {
  if (bad_shape(E, C, D, F) || D % 8 || F % 8)
    return int(cudaErrorInvalidValue);
  return int(bf16stream::launch(x, w, o, E, C, D, F,
                                static_cast<cudaStream_t>(stream)));
}

// The bf16 backward of out = x . w for the output gradient dy (E, C, F),
// every tensor read in place: dx (E, C, D) = dy . w^T. D and F multiples
// of 8, any C.
extern "C" int grouped_matmul_bwd_dx(const void* dy, const void* w, void* dx,
                                     int E, int C, int D, int F,
                                     void* stream) {
  if (bad_shape(E, C, D, F) || D % 8 || F % 8)
    return int(cudaErrorInvalidValue);
  return int(bf16wg::launch(bf16wg::gmm_dx_kernel, dy, w, dx, E, C, D, F, C,
                            D, static_cast<cudaStream_t>(stream)));
}

// dw (E, D, F) = x^T . dy, x (E, C, D): as grouped_matmul_bwd_dx.
extern "C" int grouped_matmul_bwd_dw(const void* x, const void* dy, void* dw,
                                     int E, int C, int D, int F,
                                     void* stream) {
  if (bad_shape(E, C, D, F) || D % 8 || F % 8)
    return int(cudaErrorInvalidValue);
  return int(bf16wg::launch(bf16wg::gmm_dw_kernel, x, dy, dw, E, C, D, F, D,
                            F, static_cast<cudaStream_t>(stream)));
}
