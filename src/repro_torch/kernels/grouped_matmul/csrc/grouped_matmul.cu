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
// f32 (the parity runs, where TF32 would change tokens): f32 FMAs on the
// CUDA cores, one block per (expert, 64-row C tile, 64-column F tile).

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
// bf16 tile kernel: warpgroup tensor-core products (wgmma), cp.async ring
namespace bf16wg {

using namespace mma_bf16;

// One warpgroup a block (three blocks share an SM; two warpgroups sharing
// a 128-row tile were slower, though they read each w tile half as often)
constexpr int NT = 128;
constexpr int BM = 64;            // rows of C a block
constexpr int BN = 128;           // columns of F a block
constexpr int BK = 64;            // depth a stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int A_ELEMS = BM * BK;  // x tile, [BM][64]
constexpr int B_ELEMS = BK * BN;  // w tile, [BN / 64][BK][64]
// the stages and 1024 bytes of slack to align the swizzle blocks
constexpr size_t SMEM = sizeof(bf16) * STAGES * (A_ELEMS + B_ELEMS) + 1024;

// the x tile (rows m0.., depth k0..) and the w tile (depth k0.., columns
// n0..) into one stage, 128-byte swizzled; rows past C and columns past D
// or F zero-filled
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* xe,
                                           const bf16* we, int m0, int n0,
                                           int k0, int C, int D, int F,
                                           int tid) {
  static_assert(BM * 8 % NT == 0 && BK * BN / 8 % NT == 0, "even split");
#pragma unroll
  for (int j = 0; j < BM * 8 / NT; ++j) {
    const int i = tid + j * NT, r = i / 8, c = i % 8;
    const bool ok = m0 + r < C && k0 + c * 8 < D;
    cp_async16(sA + sw128(r, c),
               xe + (ok ? size_t(m0 + r) * D + k0 + c * 8 : 0), ok);
  }
#pragma unroll
  for (int j = 0; j < BK * BN / 8 / NT; ++j) {
    const int i = tid + j * NT, r = i / (BN / 8), c = i % (BN / 8);
    const bool ok = k0 + r < D && n0 + c * 8 < F;
    cp_async16(sB + (c / 8) * BK * 64 + sw128(r, c % 8),
               we + (ok ? size_t(k0 + r) * F + n0 + c * 8 : 0), ok);
  }
}

// grid (C tiles, F tiles, E), C tiles fastest: the blocks that share a
// weight stripe run together. Warp w owns rows m0 + 16 w .. m0 + 16 w + 15,
// lane (g, t) rows g and g + 8 of those.
__global__ void __launch_bounds__(NT)
gmm_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ o, int C, int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int tid = threadIdx.x;
  const bf16* xe = x + size_t(e) * C * D;
  const bf16* we = w + size_t(e) * D * F;
  const int n_k = (D + BK - 1) / BK;
  auto stage_a = [&](int s) { return smem + s * (A_ELEMS + B_ELEMS); };
  auto stage_b = [&](int s) { return stage_a(s) + A_ELEMS; };

  // prologue: STAGES - 1 tiles in flight (empty groups keep the count)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k)
      load_stage(stage_a(s), stage_b(s), xe, we, m0, n0, s * BK, C, D, F,
                 tid);
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
    if (nk < n_k)
      load_stage(stage_a(nk % STAGES), stage_b(nk % STAGES), xe, we, m0, n0,
                 nk * BK, C, D, F, tid);
    cp_async_commit();

    // x K-major (a k16 step is 32 bytes into a swizzle row), w MN-major
    // (its rows run along the depth: a k16 step is 16 rows)
    const bf16* sA = stage_a(kt % STAGES);
    const bf16* sB = stage_b(kt % STAGES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n128<1>(acc, gmma_desc(sA + kk * 16, 16, 1024),
                       gmma_desc(sB + kk * 16 * 64, BK * 64 * sizeof(bf16),
                                 1024),
                       1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();   // only empty groups remain; leave none behind

  // store: rows past C and columns past F masked (F % 8 == 0, so a
  // thread's column pair is wholly in or out)
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row = m0 + (tid / 32) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = row + 8 * r;
    if (gm >= C) continue;
    bf16* orow = o + (size_t(e) * C + gm) * F;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gn = n0 + 8 * j + 2 * t;
      if (gn < F)
        *reinterpret_cast<uint32_t*>(orow + gn) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

cudaError_t launch_tile(const void* x, const void* w, void* o, int E, int C,
                        int D, int F, cudaStream_t stream) {
  if (E > 65535 || (F + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
  gmm_tile_kernel<<<grid, NT, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
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
      return int(bf16wg::launch_tile(x, w, o, E, C, D, F, st));
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
