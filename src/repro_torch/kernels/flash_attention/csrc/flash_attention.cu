// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _flash_kernel): causal attention with an
// online softmax over KV tiles, the running (m, l, acc) state in f32, scale
// 1/sqrt(D), optional tanh logit softcap, optional sliding window, and a
// kpos < S mask on the ragged tail.
//
// What bounds it on this card: at the serving prefill shape (bf16, B=4,
// S=1024, H=32, KV=4, D=128, causal) the work is ~34 GFLOP against ~76 MB of
// q/k/v/o traffic, so the tensor cores would bound it (~35 us at 989 TFLOP/s).
// This first version does not use them: both products run as f32 FMAs on the
// CUDA cores from shared-memory tiles, so it is bound by the FMA rate and the
// shared-memory bandwidth that feeds it, far above the tensor-core bound.
// What the design does about the rest:
//   * score/probability tiles never reach device memory (shared memory only);
//   * KV tiles wholly above the causal diagonal or wholly outside the window
//     are skipped, not visited and masked as the TPU grid does;
//   * GQA maps q head h to kv head h / (H / KV): K and V are never repeated;
//   * q, k, v are read in place in the model's (B, S, H, D) / (B, S, KV, D)
//     layout (no transpose, no padding copy); the kernel masks the tail;
//   * q tiles are issued last-first so the long causal rows start early.
// wgmma, TMA and warp specialisation are left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int TPR = 16;         // threads per tile row/column (16 x 16 = 256)
constexpr int NT = TPR * TPR;   // threads per block
constexpr int RI = BQ / TPR;    // query rows per thread
constexpr int CJ = BK / TPR;    // score columns per thread
constexpr int NWARP = NT / 32;
static_assert(BK == 64, "the softmax pass gives each lane two columns");
static_assert(BQ % NWARP == 0, "the softmax pass splits rows over warps");

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

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK padded to D + 1 (odd stride: conflict-free column reads),
  // sV unpadded (read along rows), sP padded to BK + 1, then m, l, alpha.
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1) + 3 * BQ);
}

// One block per (q tile, b * H + h). Thread (ty, tx) owns query rows
// ty + 16 i and score columns tx + 16 j; for the output it owns rows
// ty + 16 i and head-dim columns tx + 16 j.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, float scale, int causal, int window, float softcap) {
  static_assert(D % TPR == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int DJ = D / TPR;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * D;
  float* sM = sP + BQ * LP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const long q_stride = long(H) * D;     // between sequence positions
  const long kv_stride = long(KV) * D;
  const T* qb = q + (long(b) * S * H + h) * D;
  const T* kb = k + (long(b) * S * KV + kvh) * D;
  const T* vb = v + (long(b) * S * KV + kvh) * D;
  T* ob = o + (long(b) * S * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[r * LD + c] = s < S ? to_f32(qb[s * q_stride + c]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // KV range that can be unmasked for some row of this q tile.
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;                 // exclusive
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // previous tile's sK/sV/sP reads are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < S;
      sK[r * LD + c] = ok ? to_f32(kb[s * kv_stride + c]) : 0.f;
      sV[r * D + c] = ok ? to_f32(vb[s * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    // scores = Q K^T for this thread's RI x CJ entries
    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + TPR * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + TPR * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TPR * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + TPR * j, kpos = k0 + c;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kpos < S;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        sP[r * LP + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: each warp owns BQ / NWARP rows, a lane two columns
    const int warp = tid / 32, lane = tid % 32;
    for (int rr = 0; rr < BQ / NWARP; ++rr) {
      const int r = warp * (BQ / NWARP) + rr;
      const float x0 = sP[r * LP + lane];
      const float x1 = sP[r * LP + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      // masked entries are -inf; a finite entry implies a finite m_new
      const float p0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[r * LP + lane] = p0;
      sP[r * LP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float a = sA[ty + TPR * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + TPR * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[kk * D + tx + TPR * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + TPR * i, s = q0 + r;
    if (s >= S) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[s * q_stride + tx + TPR * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int causal, int window,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const float scale = float(1.0 / sqrt(double(D)));
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, int D, int causal,
                       int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, window, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, D), k/v: (B, S, KV, D), o: (B, S, H, D), all contiguous, one
// dtype (0 = float32, 1 = bfloat16). Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int S, int H,
                                   int KV, int D, int causal, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(dispatch_d<float>(q, k, v, o, B, S, H, KV, D, causal, window, softcap, st));
    case 1: return int(dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, window, softcap, st));
    default: return int(cudaErrorInvalidValue);
  }
}
