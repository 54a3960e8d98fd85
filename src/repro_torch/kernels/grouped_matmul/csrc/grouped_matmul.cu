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
// (11 us of operations against 19 us of bytes). This first version does its
// products as f32 FMAs on the CUDA cores, so at prefill it is bound by the
// FMA rate instead. What the design does:
//   * one block per (expert, C tile, F tile) runs the loop over D itself,
//     with its f32 accumulators in registers: the TPU's sequential fourth
//     grid axis and its VMEM accumulator become that loop;
//   * the ragged edges of C, D and F are masked in the tile loads and the
//     store, so no padded copies of x or w are made (the TPU wrapper pads);
//   * w tiles are read row by row (neighbouring threads on neighbouring
//     addresses), each weight byte once per C tile: at decode that is once.
// mma.sync or wgmma with TMA, and a split over D for the tiny-C decode
// calls, are left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows of C per block
constexpr int BN = 64;          // columns of F per block
constexpr int BK = 32;          // depth of one D tile
constexpr int TPR = 16;         // 16 x 16 threads
constexpr int NT = TPR * TPR;
constexpr int RM = BM / TPR;    // rows per thread
constexpr int RN = BN / TPR;    // columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Thread (ty, tx) owns output rows m0 + ty + 16 i and columns n0 + tx + 16 j.
template <typename T>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ o, int C, int D, int F) {
  __shared__ float sX[BK][BM + 1];   // x tile, transposed; odd stride
  __shared__ float sW[BK][BN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / TPR, tx = tid % TPR;
  const T* xe = x + size_t(e) * C * D;
  const T* we = w + size_t(e) * D * F;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      sX[k][m] = (gm < C && gk < D) ? to_f32(xe[size_t(gm) * D + gk]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      sW[k][n] = (gk < D && gn < F) ? to_f32(we[size_t(gk) * F + gn]) : 0.f;
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

  T* oe = o + size_t(e) * C * F;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty + TPR * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx + TPR * j;
      if (gn < F) oe[size_t(gm) * F + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* o, int E, int C,
                   int D, int F, cudaStream_t stream) {
  dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      C, D, F);
  return cudaGetLastError();
}

}  // namespace

// x: (E, C, D), w: (E, D, F), o: (E, C, F), all contiguous, one dtype
// (0 = float32, 1 = bfloat16). Returns the cudaError_t of the launch.
extern "C" int grouped_matmul_fwd(const void* x, const void* w, void* o,
                                  int dtype, int E, int C, int D, int F,
                                  void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + BM - 1) / BM > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch<float>(x, w, o, E, C, D, F, st));
    case 1: return int(launch<__nv_bfloat16>(x, w, o, E, C, D, F, st));
    default: return int(cudaErrorInvalidValue);
  }
}
