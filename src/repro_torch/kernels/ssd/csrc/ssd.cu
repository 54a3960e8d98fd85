// SSD (state-space duality) intra-chunk kernel for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py (ssd_intra_chunk,
// body _ssd_kernel). Per (batch, head, chunk), with acs = cumsum(a):
//   y[i]    = sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) xdt_j     (c, hd)
//   S[s, p] = sum_j B_j[s] exp(acs_end - acs_j) xdt_j[p]            (ds, hd)
// All inputs and outputs are f32; B and C (ngroups = 1) are shared by every
// head.
//
// What bounds it on this card: at mamba2-370m's prefill shape (1 x 1024
// tokens, 32 heads, chunk 256, d_state 128, head dim 64) the function moves
// ~22 MB (~7 us at 3.35 TB/s) and needs ~1.1 GFLOP on the causal triangle
// with C.B^T shared over heads (~17 us at 67 TFLOP/s f32): bound by
// operations. The TPU kernel holds the whole (c x c) decay matrix and the
// (c x ds) B and C tiles in VMEM, ~0.5 MB in f32; a Hopper block has at most
// 227 KB. What the design does:
//   * one block per (batch-head, chunk, tile): a row tile of 64 chunk rows
//     for y, or a tile of 64 state rows for S;
//   * a y block walks the key tiles j <= i only (the tiles above the causal
//     diagonal are skipped, not masked), building the (64 x 64) tile of
//     (C_i . B_j) exp(acs_i - acs_j) in shared memory and multiplying it by
//     xdt_j at once: the full decay matrix is never formed;
//   * S is its own reduction over the chunk's rows, in separate blocks, so no
//     block carries a second set of accumulators;
//   * every block scans a over the chunk itself (a warp-shuffle prefix sum),
//     so no block waits on another;
//   * accumulators are in registers (head dim is a template parameter);
//     shared-memory rows are padded to an odd stride against bank conflicts.
// The products are f32 FMAs on the CUDA cores; reuse of C.B^T across heads,
// tensor cores (TF32 or split bf16) and TMA are left for a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;          // chunk rows per y block
constexpr int BKT = 64;         // key rows per tile
constexpr int BS = 64;          // state rows per S block
constexpr int TPR = 16;         // 16 x 16 threads
constexpr int NT = TPR * TPR;
constexpr int RM = 4;           // rows per thread (64 / 16)
static_assert(BR == TPR * RM && BKT == TPR * RM && BS == TPR * RM,
              "tiles are 64 rows: 4 per thread");

size_t smem_floats(int c, int ds, int hd) {
  const size_t y_block = size_t(BR) * (ds + 1) + size_t(BKT) * (ds + 1) +
                         size_t(BKT) * hd + size_t(BR) * (BKT + 1);
  const size_t s_block = size_t(BKT) * (BS + 1) + size_t(BKT) * hd;
  return size_t(c) + 32 + (y_block > s_block ? y_block : s_block);
}

// Inclusive prefix sum of a[0:c] into acs[0:c] by the whole block, in
// segments of NT; warp_sums holds 32 floats of scratch.
__device__ void chunk_cumsum(const float* __restrict__ a, float* acs,
                             float* warp_sums, int c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < c; base += NT) {
    const int i = base + tid;
    float v = i < c ? a[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < NT / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < NT / 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += t;
      }
      if (lane < NT / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_sums[warp - 1];
    v += carry;
    if (i < c) acs[i] = v;
    __syncthreads();
    carry = acs[min(base + NT, c) - 1];
    __syncthreads();
  }
}

// grid: x = row tiles of y then tiles of S, y = chunk, z = batch * nh + head.
template <int HD>
__global__ void __launch_bounds__(NT)
ssd_intra_kernel(const float* __restrict__ a, const float* __restrict__ xdt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ S, int nh, int nc,
                 int c, int ds) {
  constexpr int RN = HD / TPR;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* acs = smem;
  float* warp_sums = acs + c;
  float* tiles = warp_sums + 32;

  const int tid = threadIdx.x;
  const int ty = tid / TPR, tx = tid % TPR;
  const int n = blockIdx.y;
  const int bh = blockIdx.z;
  const int bi = bh / nh;
  const size_t chunk = size_t(bh) * nc + n;            // (b, h, n)
  const size_t bc_chunk = size_t(bi) * nc + n;         // (b, n)
  const float* a_c = a + chunk * c;
  const float* x_c = xdt + chunk * c * HD;
  const float* B_c = Bm + bc_chunk * c * ds;
  const float* C_c = Cm + bc_chunk * c * ds;
  const int n_row_tiles = (c + BR - 1) / BR;

  chunk_cumsum(a_c, acs, warp_sums, c);

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int LD = ds + 1;
  if (int(blockIdx.x) < n_row_tiles) {
    // ---- y rows [r0, r0 + BR) ----
    const int r0 = blockIdx.x * BR;
    float* sC = tiles;                     // BR x LD
    float* sB = sC + BR * LD;              // BKT x LD
    float* sX = sB + BKT * LD;             // BKT x HD
    float* sP = sX + BKT * HD;             // BR x (BKT + 1)
    for (int idx = tid; idx < BR * ds; idx += NT) {
      const int i = idx / ds, k = idx % ds;
      sC[i * LD + k] = r0 + i < c ? C_c[size_t(r0 + i) * ds + k] : 0.f;
    }
    for (int j0 = 0; j0 <= r0; j0 += BKT) {  // key tiles on or below the diagonal
      for (int idx = tid; idx < BKT * ds; idx += NT) {
        const int j = idx / ds, k = idx % ds;
        sB[j * LD + k] = j0 + j < c ? B_c[size_t(j0 + j) * ds + k] : 0.f;
      }
      for (int idx = tid; idx < BKT * HD; idx += NT) {
        const int j = idx / HD, p = idx % HD;
        sX[idx] = j0 + j < c ? x_c[size_t(j0 + j) * HD + p] : 0.f;
      }
      __syncthreads();
      float sc[RM][RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) sc[i][j] = 0.f;
      for (int k = 0; k < ds; ++k) {
        float cv[RM], bv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) cv[i] = sC[(ty + TPR * i) * LD + k];
#pragma unroll
        for (int j = 0; j < RM; ++j) bv[j] = sB[(tx + TPR * j) * LD + k];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RM; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int gi = r0 + ty + TPR * i;
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const int gj = j0 + tx + TPR * j;
          const bool live = gj <= gi && gi < c;
          sP[(ty + TPR * i) * (BKT + 1) + tx + TPR * j] =
              live ? sc[i][j] * expf(acs[gi] - acs[gj]) : 0.f;
        }
      }
      __syncthreads();
      for (int j = 0; j < BKT; ++j) {
        float pv[RM], xv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) pv[i] = sP[(ty + TPR * i) * (BKT + 1) + j];
#pragma unroll
        for (int q = 0; q < RN; ++q) xv[q] = sX[j * HD + tx + TPR * q];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[i][q] = fmaf(pv[i], xv[q], acc[i][q]);
      }
      __syncthreads();
    }
    float* y_c = y + chunk * c * HD;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gi = r0 + ty + TPR * i;
      if (gi >= c) continue;
#pragma unroll
      for (int q = 0; q < RN; ++q) y_c[size_t(gi) * HD + tx + TPR * q] = acc[i][q];
    }
  } else {
    // ---- S rows [s0, s0 + BS): S[s, p] = sum_j B_j[s] w_j xdt_j[p] ----
    const int s0 = (blockIdx.x - n_row_tiles) * BS;
    constexpr int LW = BS + 1;
    float* sW = tiles;                     // BKT x LW: B_j[s0 + s] w_j
    float* sX = sW + BKT * LW;             // BKT x HD
    const float a_end = acs[c - 1];
    for (int j0 = 0; j0 < c; j0 += BKT) {
      for (int idx = tid; idx < BKT * BS; idx += NT) {
        const int j = idx / BS, s = idx % BS;
        const bool live = j0 + j < c && s0 + s < ds;
        sW[j * LW + s] = live ? B_c[size_t(j0 + j) * ds + s0 + s] *
                                    expf(a_end - acs[j0 + j])
                              : 0.f;
      }
      for (int idx = tid; idx < BKT * HD; idx += NT) {
        const int j = idx / HD, p = idx % HD;
        sX[idx] = j0 + j < c ? x_c[size_t(j0 + j) * HD + p] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < BKT; ++j) {
        float wv[RM], xv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) wv[i] = sW[j * LW + ty + TPR * i];
#pragma unroll
        for (int q = 0; q < RN; ++q) xv[q] = sX[j * HD + tx + TPR * q];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[i][q] = fmaf(wv[i], xv[q], acc[i][q]);
      }
      __syncthreads();
    }
    float* S_c = S + chunk * size_t(ds) * HD;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gs = s0 + ty + TPR * i;
      if (gs >= ds) continue;
#pragma unroll
      for (int q = 0; q < RN; ++q) S_c[size_t(gs) * HD + tx + TPR * q] = acc[i][q];
    }
  }
}

template <int HD>
cudaError_t launch(const float* a, const float* xdt, const float* B,
                   const float* C, float* y, float* S, int b, int nh, int nc,
                   int c, int ds, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(c, ds, HD);
  auto kernel = ssd_intra_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((c + BR - 1) / BR + (ds + BS - 1) / BS, nc, b * nh);
  kernel<<<grid, NT, smem, stream>>>(a, xdt, B, C, y, S, nh, nc, c, ds);
  return cudaGetLastError();
}

}  // namespace

// a: (b, nh, nc, c); xdt: (b, nh, nc, c, hd); B, C: (b, nc, c, ds);
// y: (b, nh, nc, c, hd); S: (b, nh, nc, ds, hd). All float32, contiguous.
// Returns the cudaError_t of the launch.
extern "C" int ssd_intra_chunk_fwd(const void* a, const void* xdt,
                                   const void* B, const void* C, void* y,
                                   void* S, int b, int nh, int nc, int c,
                                   int hd, int ds, void* stream) {
  if (b <= 0 || nh <= 0 || nc <= 0 || c <= 0 || ds <= 0 || nc > 65535 ||
      b * nh > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fx = static_cast<const float*>(xdt);
  const float* fB = static_cast<const float*>(B);
  const float* fC = static_cast<const float*>(C);
  float* fy = static_cast<float*>(y);
  float* fS = static_cast<float*>(S);
  switch (hd) {
    case 16: return int(launch<16>(fa, fx, fB, fC, fy, fS, b, nh, nc, c, ds, st));
    case 32: return int(launch<32>(fa, fx, fB, fC, fy, fS, b, nh, nc, c, ds, st));
    case 64: return int(launch<64>(fa, fx, fB, fC, fy, fS, b, nh, nc, c, ds, st));
    case 128: return int(launch<128>(fa, fx, fB, fC, fy, fS, b, nh, nc, c, ds, st));
    default: return int(cudaErrorInvalidValue);
  }
}
