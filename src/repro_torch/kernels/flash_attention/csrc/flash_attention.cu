// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface for ctypes. The forward optionally writes each row's
// log-sum-exp, which the backward (namespace bwd, below) reads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _flash_kernel): causal attention with an
// online softmax over KV tiles, the running (m, l, acc) state in f32, scale
// 1/sqrt(D), optional tanh logit softcap, optional sliding window, and a
// kpos < S mask on the ragged tail.
//
// What bounds it on this card: at the serving prefill shape (bf16, B=4,
// S=1024, H=32, KV=4, D=128, causal) the work is ~34 GFLOP against ~76 MB of
// q/k/v/o traffic, so the tensor cores bound it (~35 us at 989 TFLOP/s).
// Both dtypes share what keeps work and traffic down:
//   * score/probability tiles never reach device memory;
//   * KV tiles wholly above the causal diagonal or wholly outside the window
//     are skipped, not visited and masked as the TPU grid does;
//   * GQA maps q head h to kv head h / (H / KV): K and V are never repeated;
//   * q, k, v are read in place in the model's (B, S, H, D) / (B, S, KV, D)
//     layout (no transpose, no padding copy); the kernel masks the tail;
//   * q tiles are issued last-first so the long causal rows start early.
//
// bf16 (the serving path): both products on the tensor cores as warpgroup
// products (wgmma.m64nNk16, bf16 operands, f32 accumulation). A block of
// one warpgroup owns 64 q rows of one (b, h). K and V tiles arrive with
// cp.async in a ring of shared-memory stages, in 128-byte-swizzled rows,
// so the next tile's copy overlaps this tile's products. S = Q.K^T runs
// from shared memory (Q and K K-major) into registers; the online softmax
// runs on that fragment (a row lives in the 4 threads of a quad, so its
// max and sum are two __shfl_xor); P, rounded to bf16, is the A operand of
// P.V straight from registers (the TPU kernel keeps P in f32: a relative
// error of at most 2^-9 a probability), with V the MN-major B operand. The
// block issues Q.K^T of tile j and P.V of tile j - 1 together and runs the
// softmax of tile j while P.V is on the tensor cores. m and l stay f32.
// What holds it back: every thread copies K and V (cp.async, not TMA),
// each block reads K and V for only 64 q rows, and Q.K^T still waits for
// the softmax before it; TMA loads from one producer thread and 128-row q
// tiles shared by two warpgroups scheduled apart (as FlashAttention-3
// does) are the next step.
//
// f32 (the parity runs, where TF32 would change tokens): f32 FMAs on the
// CUDA cores from padded shared-memory tiles, far above the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
namespace f32 {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int TPR = 16;         // threads per tile row/column (16 x 16 = 256)
constexpr int NT = TPR * TPR;   // threads per block
constexpr int RI = BQ / TPR;    // query rows per thread
constexpr int CJ = BK / TPR;    // score columns per thread
constexpr int NWARP = NT / 32;
static_assert(BK == 64, "the softmax pass gives each lane two columns");
static_assert(BQ % NWARP == 0, "the softmax pass splits rows over warps");

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
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int KV,
                     float scale, int causal, int window, float softcap) {
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
  const float* qb = q + (long(b) * S * H + h) * D;
  const float* kb = k + (long(b) * S * KV + kvh) * D;
  const float* vb = v + (long(b) * S * KV + kvh) * D;
  float* ob = o + (long(b) * S * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[r * LD + c] = s < S ? qb[s * q_stride + c] : 0.f;
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
      sK[r * LD + c] = ok ? kb[s * kv_stride + c] : 0.f;
      sV[r * D + c] = ok ? vb[s * kv_stride + c] : 0.f;
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
    // the row's log-sum-exp for the backward (+inf on a row with no key:
    // its probabilities are then 0)
    if (lse != nullptr && tx == 0)
      lse[long(bh) * S + s] = sM[r] == -INFINITY ? INFINITY
                                                 : sM[r] + logf(sL[r]);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[s * q_stride + tx + TPR * j] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_f32_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  if (B * H > 65535) return cudaErrorInvalidValue;
  const float scale = float(1.0 / sqrt(double(D)));
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: warpgroup tensor-core products (wgmma), cp.async 2-stage K/V ring
namespace bf16wg {

using namespace mma_bf16;

// One warpgroup a block: two blocks share an SM and, not meeting at a
// barrier, run their softmaxes and products out of step (two warpgroups
// in one block, meeting every tile, were slower).
constexpr int NT = 128;
constexpr int BQ = 64;          // q rows a block
constexpr int ST = 3;           // stages of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;

// head dim as stored in shared memory: whole 64-column swizzle blocks,
// columns past D zero-filled (they add nothing to Q.K^T, and the output
// columns they make are not stored)
template <int D>
__host__ __device__ constexpr int padded() { return D < 64 ? 64 : D; }
// kv rows a tile: 64, or 32 at D = 256, where the output fragment alone
// is 128 registers a thread
template <int D>
__host__ __device__ constexpr int kv_tile() { return D >= 256 ? 32 : 64; }

template <int D>
constexpr size_t smem_bytes() {
  // Q, then ST stages of K and V, each row padded<D>() bf16; 1024 bytes
  // of slack to align the swizzle blocks
  return sizeof(bf16) * size_t(BQ + 2 * ST * kv_tile<D>()) * padded<D>() +
         1024;
}

// ROWS x D tile of rows s0.. of a (S, *, D) tensor whose rows are `stride`
// elements apart, into 128-byte-swizzled column blocks of 64; rows at or
// past S and columns at or past D are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int s0, int S,
                                          int tid) {
  constexpr int CH = padded<D>() / 8;   // 16-byte chunks a row
  static_assert(ROWS * CH % NT == 0, "every thread copies as many chunks");
#pragma unroll
  for (int j = 0; j < ROWS * CH / NT; ++j) {
    const int i = tid + j * NT, r = i / CH, c = i % CH, s = s0 + r;
    const bool ok = s < S && c * 8 < D;
    cp_async16(dst + (c / 8) * ROWS * 64 + sw128(r, c % 8),
               src + (ok ? long(s) * stride + c * 8 : 0), ok);
  }
}

// Q.K^T for one k16 step: the score tile is BK wide
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t desc_q,
                                         uint64_t desc_k, int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64<0>(d, desc_q, desc_k, scale_d);
  else wgmma_ss_n32<0>(d, desc_q, desc_k, scale_d);
}

// P.V for one k16 step: the output fragment is padded<D>() wide
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_v);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, desc_v);
  else wgmma_rs_n256(d, a, desc_v);
}

// The scores of one BK-wide tile (sc, in the wgmma accumulator layout, only
// read) to probabilities: scale (log2 units), softcap, mask, the online max
// and sum over each row's quad; P, rounded to bf16, into p (the A operands
// of P.V) and the rescale of the earlier state into alpha. The softcap is a
// template argument: its tanh, present but not taken, slowed the kernel
// without one.
template <int BK, bool SOFTCAP>
struct Softmax {
  float scale, scale_log2, softcap;
  int S, causal, window, q0, q_last, row_g, t;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g, g + 8; log2 units
  float l_run[2] = {0.f, 0.f};               // this thread's part of the sum

  __device__ __forceinline__ void tile(const float (&sc)[BK / 2], int k0,
                                       uint32_t (&p)[BK / 16][4],
                                       float (&alpha)[2]) {
    // a tile wholly inside every row's range skips the mask
    const bool inside = k0 + BK <= S && (!causal || k0 + BK - 1 <= q0) &&
                        (window <= 0 || q_last - k0 < window);
    float s[BK / 2];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[4 * nb + i];
        if constexpr (SOFTCAP)
          x = tanhf(x * scale / softcap) * (softcap * LOG2E);
        else
          x *= scale_log2;
        if (!inside) {
          const int qpos = row_g + (i >> 1) * 8;
          const int kpos = k0 + nb * 8 + 2 * t + (i & 1);
          bool ok = kpos < S;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x = -INFINITY;
        }
        s[4 * nb + i] = x;
      }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * nb], s[4 * nb + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with nothing unmasked yet keeps p = 0 and alpha = 0
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2_ftz(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = exp2_ftz(s[4 * nb + i] - base[i >> 1]);
        rsum[i >> 1] += e[i];
      }
      // two n8 score blocks make one k16 step of P.V
      p[nb / 2][(nb % 2) * 2] = pack_bf16(e[0], e[1]);
      p[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(e[2], e[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
  }
};

// One block (one warpgroup) per (b * H + h, q tile of 64 rows); warp w
// owns q rows q0 + 16 w .. q0 + 16 w + 15, lane (g, t) rows g and g + 8 of
// those. The block issues Q.K^T of tile j and P.V of tile j - 1 together,
// and runs the softmax of tile j while P.V is on the tensor cores; so the
// ring holds tiles j - 1, j and, in flight, j + 1.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int H, int KV,
                      float scale, int causal, int window, float softcap) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = padded<D>();
  constexpr int BK = kv_tile<D>();
  extern __shared__ unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sK = sQ + BQ * DP;        // [ST][DP / 64][BK][64]
  bf16* sV = sK + ST * BK * DP;   // [ST][DP / 64][BK][64]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const long q_stride = long(H) * D;
  const long kv_stride = long(KV) * D;
  const bf16* kb = k + (long(b) * S * KV + kvh) * D;
  const bf16* vb = v + (long(b) * S * KV + kvh) * D;

  // KV tiles that can be unmasked for some row of this q tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;                 // exclusive
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile0 = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK - tile0;

  load_tile<BQ, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S, tid);
  load_tile<BK, D>(sK, kb, kv_stride, tile0 * BK, S, tid);
  load_tile<BK, D>(sV, vb, kv_stride, tile0 * BK, S, tid);
  cp_async_commit();

  Softmax<BK, SOFTCAP> sm{scale, scale * LOG2E, softcap, S, causal, window,
                          q0, q_last, q0 + warp * 16 + g, lane % 4};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t p[BK / 16][4], pn[BK / 16][4];
  float alpha[2];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (tile0 + it) * BK;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // tile it has landed; P.V of it - 2 is done
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % ST;
      load_tile<BK, D>(sK + nx * BK * DP, kb, kv_stride, k0 + BK, S, tid);
      load_tile<BK, D>(sV + nx * BK * DP, vb, kv_stride, k0 + BK, S, tid);
      cp_async_commit();
    }

    // S = Q K^T: Q (64 x DP) and K (BK x DP) both K-major in shared
    // memory; a k16 step is 32 bytes into a 128-byte swizzle row
    const bf16* cK = sK + (it % ST) * BK * DP;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_qk<BK>(s,
                   gmma_desc(sQ + (kk / 4) * BQ * 64 + (kk % 4) * 16, 16,
                             1024),
                   gmma_desc(cK + (kk / 4) * BK * 64 + (kk % 4) * 16, 16,
                             1024),
                   kk > 0);
    wgmma_commit();
    // O += P V of the last tile: P from registers, V (BK x DP) MN-major in
    // shared memory (its rows run along the reduced kv dimension), a k16
    // step 16 rows
    if (it > 0) {
      const bf16* cV = sV + ((it - 1) % ST) * BK * DP;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DP>(acc, p[kk],
                     gmma_desc(cV + kk * 16 * 64, BK * 64 * sizeof(bf16),
                               1024));
      wgmma_commit();
      wgmma_wait<1>();        // Q.K^T; P.V runs on during the softmax
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    sm.tile(s, k0, pn, alpha);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);            // P's registers were read until here
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pn[kk][i];
  }
  {
    const bf16* cV = sV + ((n_tiles - 1) % ST) * BK * DP;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DP>(acc, p[kk],
                   gmma_desc(cV + kk * 16 * 64, BK * 64 * sizeof(bf16),
                             1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // epilogue: the row sum over the quad, divide (floor 1e-30), round, store
  bf16* ob = o + (long(b) * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = sm.l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qpos = sm.row_g + 8 * r;
    if (qpos >= S) continue;
    // the row's log-sum-exp for the backward, from log2 units (+inf on a
    // row with no key: its probabilities are then 0)
    if (lse != nullptr && sm.t == 0)
      lse[long(bh) * S + qpos] =
          sm.m_run[r] == -INFINITY
              ? INFINITY
              : (sm.m_run[r] + log2f(l)) * 0.6931471805599453f;
    bf16* orow = ob + long(qpos) * q_stride + 2 * sm.t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = softcap > 0.f ? flash_fwd_bf16_kernel<D, true>
                              : flash_fwd_bf16_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int n_q = (S + BQ - 1) / BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  const float scale = float(1.0 / sqrt(double(D)));
  dim3 grid(B * H, n_q);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, KV,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace bf16wg

// ---------------------------------------------------------------------------
// Backward, f32 (and bf16 at head dim 256): f32 FMAs on the CUDA cores,
// three grids; bf16 at head dims 64 and 128 runs the same schedule on the
// tensor cores (namespace bwd_tc, below).
//
// The TPU kernel has no backward (JAX differentiates the jnp attention
// under jax.checkpoint, recomputing the scores), so this one follows the
// FlashAttention-2 schedule. The forward saved each row's log-sum-exp
// (f32, (B, H, S)); P is recomputed from q, k and it, tile by tile, and no
// S x S tensor ever reaches device memory:
//   1. delta_kernel: D = rowsum(dO * O) per (b, h, row), one warp a row;
//   2. dkdv_kernel: one block per (kv tile, b * KV + kv head) walks every q
//      tile of every q head of its group that can see its keys, and sums
//      dV += P^T dO and dK += dS^T Q in registers: the group's sum is taken
//      inside the block, so dK and dV need no atomics;
//   3. dq_kernel: one block per (q tile, b * H + h) walks the key tiles its
//      rows can see and sums dQ += dS K: a second pass, deterministic, in
//      place of f32 atomics into dQ.
// With x = scale * q.k (softcapped: x = cap * tanh(scale * q.k / cap)),
// P = exp(x - lse), dP = dO.V, dS = P * (dP - D) * dx/d(q.k) / scale, and
// the scale is applied once to dQ and dK. Masks as the forward: causal,
// the window (qpos - kpos < window), kpos < S; GQA by index.
//
// What bounds it on this card: 7 products of the attention's (q, k) pairs
// (S and dP twice, dV, dK, dQ), ~3.5x the forward's operations, against
// q, k, v, o, dO read and dq, dk, dv written: bound by operations. Here
// they run as f32 FMAs on the CUDA cores (bf16 loads widened to f32 in
// shared memory), far above the tensor-core bound.
namespace bwd {

constexpr int TPR = 16;         // threads per tile row/column (16 x 16)
constexpr int NT = TPR * TPR;

// q and kv rows a tile: 64, or 32 at D = 256 (shared memory)
template <int D>
__host__ __device__ constexpr int tile() { return D >= 256 ? 32 : 64; }

template <int D>
constexpr size_t smem_bytes() {
  // four T x (D + 1) tiles (odd stride: conflict-free column reads), two
  // T x (T + 1) score tiles, the rows' lse and D
  constexpr size_t T = tile<D>();
  return sizeof(float) * (4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ROWS x D rows s0.. of a tensor whose rows are `stride` elements apart,
// widened to f32, into dst with a row pitch of D + 1; rows past S are 0
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long stride, int s0, int S,
                                          int tid) {
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D, s = s0 + r;
    dst[r * (D + 1) + c] = s < S ? to_f32(src[long(s) * stride + c]) : 0.f;
  }
}

// D = rowsum(dO * O): row (b, s, h) of the (B, S, H, D) tensors into
// delta[(b * H + h) * S + s]; one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int S, int H, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + long(row) * D;
  const T* drow = dout + long(row) * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum += to_f32(orow[c]) * to_f32(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[(long(b) * H + h) * S + s] = sum;
  }
}

// The shared part of both passes: for the q tile in sQ/sO (rows q0..) and
// the kv tile in sK/sV (rows k0..), P into sP (when given) and dS (without
// the scale) into sS; thread (ty, tx) computes rows ty + 16 i, columns
// tx + 16 j.
template <int D, bool SOFTCAP>
__device__ __forceinline__ void scores(const float* sQ, const float* sO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sDl,
                                       float* sP, float* sS, int q0, int k0,
                                       int S, float scale, int causal,
                                       int window, float softcap, int tx,
                                       int ty) {
  constexpr int BT = tile<D>();
  constexpr int LD = D + 1, LP = BT + 1, RI = BT / TPR;
  float sc[RI][RI], dp[RI][RI];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], ov[RI], kv[RI], vv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = sQ[(ty + TPR * i) * LD + d];
      ov[i] = sO[(ty + TPR * i) * LD + d];
      kv[i] = sK[(tx + TPR * i) * LD + d];
      vv[i] = sV[(tx + TPR * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + TPR * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int c = tx + TPR * j, kpos = k0 + c;
      bool ok = qpos < S && kpos < S;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      float x = sc[i][j] * scale, t = 0.f;
      if constexpr (SOFTCAP) {
        t = tanhf(x / softcap);
        x = t * softcap;
      }
      const float p = ok ? expf(x - sL[r]) : 0.f;
      float ds = p * (dp[i][j] - sDl[r]);
      if constexpr (SOFTCAP) ds *= 1.f - t * t;
      if (sP != nullptr) sP[r * LP + c] = p;
      sS[r * LP + c] = ds;
    }
  }
}

// One block per (kv tile, b * KV + kv head): dK and dV of its rows, summed
// over the group's q heads and every q tile that sees them.
template <typename T, int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
            float scale, int causal, int window, float softcap) {
  constexpr int BT = tile<D>();
  constexpr int LD = D + 1, LP = BT + 1, RI = BT / TPR, DJ = D / TPR;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;         // dO
  float* sP = sO + BT * LD;
  float* sS = sP + BT * LP;
  float* sL = sS + BT * LP;
  float* sDl = sL + BT;

  const int tid = threadIdx.x, tx = tid % TPR, ty = tid / TPR;
  const int k0 = blockIdx.x * BT;   // the longest causal blocks first
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, G = H / KV;
  const long q_stride = long(H) * D, kv_stride = long(KV) * D;
  load_rows<T, BT, D>(sK, k + (long(b) * S * KV + kvh) * D, kv_stride, k0, S,
                      tid);
  load_rows<T, BT, D>(sV, v + (long(b) * S * KV + kvh) * D, kv_stride, k0, S,
                      tid);

  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // q rows that can see a key of this tile
  const int k_last = min(k0 + BT, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;   // exclusive
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long bh = long(b) * H + h;
    for (int q0 = (q_begin / BT) * BT; q0 < q_end; q0 += BT) {
      __syncthreads();   // the last tile's sQ/sO/sP/sS reads are done
      load_rows<T, BT, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S,
                          tid);
      load_rows<T, BT, D>(sO, dout + (long(b) * S * H + h) * D, q_stride, q0,
                          S, tid);
      if (tid < BT) {
        const int s = q0 + tid;
        sL[tid] = s < S ? lse[bh * S + s] : 0.f;
        sDl[tid] = s < S ? delta[bh * S + s] : 0.f;
      }
      __syncthreads();
      scores<D, SOFTCAP>(sQ, sO, sK, sV, sL, sDl, sP, sS, q0, k0, S, scale,
                         causal, window, softcap, tx, ty);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: key rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pv[RI], sv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = sP[r * LP + ty + TPR * i];
          sv[i] = sS[r * LP + ty + TPR * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float o = sO[r * LD + tx + TPR * j];
          const float qq = sQ[r * LD + tx + TPR * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc_v[i][j] = fmaf(pv[i], o, acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qq, acc_k[i][j]);
          }
        }
      }
    }
  }
  T* dkb = dk + (long(b) * S * KV + kvh) * D;
  T* dvb = dv + (long(b) * S * KV + kvh) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = k0 + ty + TPR * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + TPR * j;
      dkb[long(s) * kv_stride + c] = from_f32<T>(acc_k[i][j] * scale);
      dvb[long(s) * kv_stride + c] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// One block per (q tile, b * H + h): dQ of its rows over every key tile
// they see.
template <typename T, int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int KV, float scale, int causal,
          int window, float softcap) {
  constexpr int BT = tile<D>();
  constexpr int LD = D + 1, LP = BT + 1, RI = BT / TPR, DJ = D / TPR;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;         // dO
  float* sS = sO + BT * LD + BT * LP;
  float* sL = sS + BT * LP;
  float* sDl = sL + BT;

  const int tid = threadIdx.x, tx = tid % TPR, ty = tid / TPR;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // longest rows first
  const long bh = blockIdx.y;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const long q_stride = long(H) * D, kv_stride = long(KV) * D;
  const T* kb = k + (long(b) * S * KV + kvh) * D;
  const T* vb = v + (long(b) * S * KV + kvh) * D;
  load_rows<T, BT, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S,
                      tid);
  load_rows<T, BT, D>(sO, dout + (long(b) * S * H + h) * D, q_stride, q0, S,
                      tid);
  if (tid < BT) {
    const int s = q0 + tid;
    sL[tid] = s < S ? lse[bh * S + s] : 0.f;
    sDl[tid] = s < S ? delta[bh * S + s] : 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // key tiles that can be unmasked for some row of this q tile
  const int q_last = min(q0 + BT, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;                 // exclusive
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kv_begin / BT) * BT; k0 < kv_end; k0 += BT) {
    __syncthreads();   // the last tile's sK/sS reads are done
    load_rows<T, BT, D>(sK, kb, kv_stride, k0, S, tid);
    load_rows<T, BT, D>(sV, vb, kv_stride, k0, S, tid);
    __syncthreads();
    scores<D, SOFTCAP>(sQ, sO, sK, sV, sL, sDl, nullptr, sS, q0, k0, S,
                       scale, causal, window, softcap, tx, ty);
    __syncthreads();
    // dQ += dS K: q rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < BT; ++c) {
      float sv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = sS[(ty + TPR * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sK[c * LD + tx + TPR * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(sv[i], kk, acc[i][j]);
      }
    }
  }
  T* dqb = dq + (long(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = q0 + ty + TPR * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[long(s) * q_stride + tx + TPR * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D, bool SOFTCAP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  constexpr int BT = tile<D>();
  auto k_dkdv = dkdv_kernel<T, D, SOFTCAP>;
  auto k_dq = dq_kernel<T, D, SOFTCAP>;
  cudaError_t e = cudaFuncSetAttribute(
      k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return e;
  if (B * H > 65535) return cudaErrorInvalidValue;
  const float scale = float(1.0 / sqrt(double(D)));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int rows = B * S * H;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, rows, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_t = (S + BT - 1) / BT;
  k_dkdv<<<dim3(n_t, B * KV), NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KV, scale, causal, window, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_dq<<<dim3(n_t, B * H), NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, KV, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward, bf16 at head dims 64 and 128: the products on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulation), the same three
// grids and the same arithmetic as namespace bwd, whose D = rowsum(dO * O)
// kernel it shares. Tiles are copied with cp.async into row-padded shared
// memory (conflict-free ldmatrix, no swizzle) and read as fragments with
// ldmatrix; P and dS are rounded to bf16 as the A operands of the next
// products straight from the accumulators' registers (a relative error of
// at most 2^-9 each, as the forward's P). Each block is four warps, each
// warp 16 rows of the block's tile:
//   * dkdv: 64 keys a block; S^T = K.Q^T and dP^T = V.dO^T for 32 queries
//     at a time, then dV += P^T.dO and dK += dS^T.Q into registers;
//   * dq: 64 queries a block; S = Q.K^T and dP = dO.V^T for 32 keys at a
//     time, then dQ += dS.K.
// What holds it back: one stage of shared memory (each tile's copy waits),
// mma.sync rather than wgmma, and the scores computed twice (once a pass);
// a wgmma/TMA design with dQ by atomics is the next step.
namespace bwd_tc {

using namespace mma_bf16;

constexpr int NT = 128;         // four warps
constexpr int BR = 64;          // the block's own rows (keys or queries)
constexpr int BC = 32;          // the rows walked a step (queries or keys)

template <int D>
constexpr size_t smem_bytes() {
  // two BR x D tiles (the block's own), two BC x D tiles (walked), each row
  // padded by PAD; lse and D of the query rows (dkdv: BC, dq: BR)
  return sizeof(bf16) * size_t(2 * BR + 2 * BC) * (D + PAD) +
         2 * BR * sizeof(float);
}

// ROWS x D rows s0.. of a tensor whose rows are `stride` elements apart,
// into dst (row pitch D + PAD) with 16-byte cp.async; rows past S are 0
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long stride, int s0, int S,
                                          int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH, s = s0 + r;
    const bool ok = s < S;
    cp_async16(dst + r * (D + PAD) + c * 8,
               src + (ok ? long(s) * stride + c * 8 : 0), ok);
  }
}

// acc (16 x BC, 4 n8 blocks) = A (this warp's 16 rows of sA) . B^T, B the
// BC rows of sB, both (rows, D) in shared memory (D contiguous)
template <int D>
__device__ __forceinline__ void rows_dot(float (&acc)[BC / 8][4],
                                         const bf16* sA, const bf16* sB,
                                         int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int j = 0; j < BC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(sA + (lane % 16) * LD + kk * 16 + (lane / 16) * 8, a[0], a[1],
            a[2], a[3]);
#pragma unroll
    for (int p = 0; p < BC / 16; ++p) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(sB + (p * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                  ((lane / 8) % 2) * 8,
              b0, b1, b2, b3);
      mma(acc[2 * p], a, b0, b1);
      mma(acc[2 * p + 1], a, b2, b3);
    }
  }
}

// acc (16 x D) += A (16 x BC, bf16 fragments from registers) . sB, sB the
// (BC, D) rows in shared memory (D contiguous)
template <int D>
__device__ __forceinline__ void frag_times_rows(float (&acc)[D / 8][4],
                                                const uint32_t (&a)[BC / 16][4],
                                                const bf16* sB, int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(sB + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                    p * 16 + (lane / 16) * 8,
                b0, b1, b2, b3);
      mma(acc[2 * p], a[kk], b0, b1);
      mma(acc[2 * p + 1], a[kk], b2, b3);
    }
}

// P and dS (without the scale) of one 16 x BC tile, packed to bf16 A
// fragments: s and dp are the accumulators of the scores and of dO.V^T
// (rows along the warp's 16, columns along BC); qpos/kpos give each
// element's query and key; lse and delta are read per query.
template <bool SOFTCAP, bool ROWS_ARE_KEYS>
__device__ __forceinline__ void probs(const float (&s)[BC / 8][4],
                                      const float (&dp)[BC / 8][4],
                                      uint32_t (&p)[BC / 16][4],
                                      uint32_t (&ds)[BC / 16][4],
                                      const float* sL, const float* sDl,
                                      int row0, int col0, int lane, int S,
                                      float scale, int causal, int window,
                                      float softcap) {
  const int g = lane / 4, t = lane % 4;
  float pv[BC / 8][4], dv[BC / 8][4];
#pragma unroll
  for (int j = 0; j < BC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i >> 1), c = j * 8 + 2 * t + (i & 1);
      const int qpos = ROWS_ARE_KEYS ? col0 + c : row0 + r;
      const int kpos = ROWS_ARE_KEYS ? row0 + r : col0 + c;
      // lse and D are kept per walked row (keys' pass: the queries)
      const int li = ROWS_ARE_KEYS ? c : r;
      bool ok = qpos < S && kpos < S;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      float x = s[j][i] * scale, th = 0.f;
      if constexpr (SOFTCAP) {
        th = tanhf(x / softcap);
        x = th * softcap;
      }
      const float pr = ok ? expf(x - sL[li]) : 0.f;
      float d = pr * (dp[j][i] - sDl[li]);
      if constexpr (SOFTCAP) d *= 1.f - th * th;
      pv[j][i] = pr;
      dv[j][i] = d;
    }
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    p[kk][0] = pack_bf16(pv[2 * kk][0], pv[2 * kk][1]);
    p[kk][1] = pack_bf16(pv[2 * kk][2], pv[2 * kk][3]);
    p[kk][2] = pack_bf16(pv[2 * kk + 1][0], pv[2 * kk + 1][1]);
    p[kk][3] = pack_bf16(pv[2 * kk + 1][2], pv[2 * kk + 1][3]);
    ds[kk][0] = pack_bf16(dv[2 * kk][0], dv[2 * kk][1]);
    ds[kk][1] = pack_bf16(dv[2 * kk][2], dv[2 * kk][3]);
    ds[kk][2] = pack_bf16(dv[2 * kk + 1][0], dv[2 * kk + 1][1]);
    ds[kk][3] = pack_bf16(dv[2 * kk + 1][2], dv[2 * kk + 1][3]);
  }
}

// a warp's 16 x D accumulator (times `mul`) to rows row0.. of a (rows, D)
// tensor whose rows are `stride` elements apart; rows past S are skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           long stride, int row0, int S,
                                           float mul, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = row0 + g + 8 * h;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + long(s) * stride + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
            int KV, float scale, int causal, int window, float softcap) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = sK + BR * LD;
  bf16* sQ = sV + BR * LD;
  bf16* sO = sQ + BC * LD;          // dO
  float* sL = reinterpret_cast<float*>(sO + BC * LD);
  float* sDl = sL + BC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BR;   // the longest causal blocks first
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, G = H / KV;
  const long q_stride = long(H) * D, kv_stride = long(KV) * D;
  load_rows<BR, D>(sK, k + (long(b) * S * KV + kvh) * D, kv_stride, k0, S,
                   tid);
  load_rows<BR, D>(sV, v + (long(b) * S * KV + kvh) * D, kv_stride, k0, S,
                   tid);
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

  const int krow0 = k0 + warp * 16;
  const int k_last = min(k0 + BR, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;   // exclusive
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long bh = long(b) * H + h;
    for (int q0 = (q_begin / BC) * BC; q0 < q_end; q0 += BC) {
      __syncthreads();   // the last tile's reads are done
      load_rows<BC, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S,
                       tid);
      load_rows<BC, D>(sO, dout + (long(b) * S * H + h) * D, q_stride, q0,
                       S, tid);
      cp_async_commit();
      if (tid < BC) {
        const int s = q0 + tid;
        sL[tid] = s < S ? lse[bh * S + s] : 0.f;
        sDl[tid] = s < S ? delta[bh * S + s] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      uint32_t p[BC / 16][4], ds[BC / 16][4];
      {
        float st[BC / 8][4], dpt[BC / 8][4];
        rows_dot<D>(st, sK + warp * 16 * LD, sQ, lane);    // S^T = K.Q^T
        rows_dot<D>(dpt, sV + warp * 16 * LD, sO, lane);   // dP^T = V.dO^T
        probs<SOFTCAP, true>(st, dpt, p, ds, sL, sDl, krow0, q0, lane, S,
                             scale, causal, window, softcap);
      }
      frag_times_rows<D>(acc_v, p, sO, lane);     // dV += P^T.dO
      frag_times_rows<D>(acc_k, ds, sQ, lane);    // dK += dS^T.Q
    }
  }
  cp_async_wait<0>();   // a block with no q tile still drains its copies
  store_rows<D>(dk + (long(b) * S * KV + kvh) * D, acc_k, kv_stride, krow0,
                S, scale, lane);
  store_rows<D>(dv + (long(b) * S * KV + kvh) * D, acc_v, kv_stride, krow0,
                S, 1.f, lane);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int S, int H, int KV, float scale,
          int causal, int window, float softcap) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sO = sQ + BR * LD;          // dO
  bf16* sK = sO + BR * LD;
  bf16* sV = sK + BC * LD;
  float* sL = reinterpret_cast<float*>(sV + BC * LD);   // the block's rows
  float* sDl = sL + BR;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;   // longest rows first
  const long bh = blockIdx.y;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const long q_stride = long(H) * D, kv_stride = long(KV) * D;
  const bf16* kb = k + (long(b) * S * KV + kvh) * D;
  const bf16* vb = v + (long(b) * S * KV + kvh) * D;
  load_rows<BR, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S, tid);
  load_rows<BR, D>(sO, dout + (long(b) * S * H + h) * D, q_stride, q0, S,
                   tid);
  cp_async_commit();
  if (tid < BR) {
    const int s = q0 + tid;
    sL[tid] = s < S ? lse[bh * S + s] : 0.f;
    sDl[tid] = s < S ? delta[bh * S + s] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int qrow0 = q0 + warp * 16;
  const int q_last = min(q0 + BR, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;                 // exclusive
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kv_begin / BC) * BC; k0 < kv_end; k0 += BC) {
    __syncthreads();   // the last tile's reads are done
    load_rows<BC, D>(sK, kb, kv_stride, k0, S, tid);
    load_rows<BC, D>(sV, vb, kv_stride, k0, S, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t p[BC / 16][4], ds[BC / 16][4];
    {
      float s[BC / 8][4], dp[BC / 8][4];
      rows_dot<D>(s, sQ + warp * 16 * LD, sK, lane);     // S = Q.K^T
      rows_dot<D>(dp, sO + warp * 16 * LD, sV, lane);    // dP = dO.V^T
      probs<SOFTCAP, false>(s, dp, p, ds, sL + warp * 16, sDl + warp * 16,
                            qrow0, k0, lane, S, scale, causal, window,
                            softcap);
    }
    frag_times_rows<D>(acc, ds, sK, lane);       // dQ += dS.K
  }
  store_rows<D>(dq + (long(b) * S * H + h) * D, acc, q_stride, qrow0, S,
                scale, lane);
}

template <int D, bool SOFTCAP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto k_dkdv = dkdv_kernel<D, SOFTCAP>;
  auto k_dq = dq_kernel<D, SOFTCAP>;
  cudaError_t e = cudaFuncSetAttribute(
      k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return e;
  if (B * H > 65535) return cudaErrorInvalidValue;
  const float scale = float(1.0 / sqrt(double(D)));
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const int rows = B * S * H;
  bwd::delta_kernel<bf16><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(o), tdo, delta, rows, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_t = (S + BR - 1) / BR;
  k_dkdv<<<dim3(n_t, B * KV), NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KV, scale, causal, window, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_dq<<<dim3(n_t, B * H), NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), S, H, KV, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace bwd_tc

// The backward for one head dim: bf16 at D 64 and 128 on the tensor cores
// (bwd_tc), f32, and bf16 at D 256, on the CUDA cores (bwd)
template <int D, bool SOFTCAP>
cudaError_t launch_bwd_cap(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, void* dk, void* dv,
                           int dtype, int B, int S, int H, int KV, int causal,
                           int window, float softcap, cudaStream_t st) {
  if (dtype == 0)
    return bwd::launch<float, D, SOFTCAP>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, B, S, H, KV, causal,
                                          window, softcap, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D <= 128)
    return bwd_tc::launch<D, SOFTCAP>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, S, H, KV, causal, window,
                                      softcap, st);
  else
    return bwd::launch<__nv_bfloat16, D, SOFTCAP>(
        q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal,
        window, softcap, st);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int dtype,
                       int B, int S, int H, int KV, int causal, int window,
                       float softcap, cudaStream_t st) {
  return softcap > 0.f
             ? launch_bwd_cap<D, true>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, dtype, B, S, H, KV, causal, window,
                                       softcap, st)
             : launch_bwd_cap<D, false>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, dtype, B, S, H, KV, causal,
                                        window, softcap, st);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int dtype, int B, int S, int H, int KV,
                     int causal, int window, float softcap, cudaStream_t st) {
  if (dtype == 0)
    return f32::launch<D>(q, k, v, o, lse, B, S, H, KV, causal, window,
                          softcap, st);
  if (dtype == 1)
    return bf16wg::launch<D>(q, k, v, o, lse, B, S, H, KV, causal, window,
                             softcap, st);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int dtype, int B, int S, int H, int KV,
                     int D, int causal, int window, float softcap,
                     cudaStream_t st) {
  switch (D) {
    case 16: return launch_d<16>(q, k, v, o, lse, dtype, B, S, H, KV, causal, window, softcap, st);
    case 32: return launch_d<32>(q, k, v, o, lse, dtype, B, S, H, KV, causal, window, softcap, st);
    case 64: return launch_d<64>(q, k, v, o, lse, dtype, B, S, H, KV, causal, window, softcap, st);
    case 128: return launch_d<128>(q, k, v, o, lse, dtype, B, S, H, KV, causal, window, softcap, st);
    case 256: return launch_d<256>(q, k, v, o, lse, dtype, B, S, H, KV, causal, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, D), k/v: (B, S, KV, D), o: (B, S, H, D), all contiguous, one
// dtype (0 = float32, 1 = bfloat16); lse: null (serving) or (B, H, S) f32,
// each row's log-sum-exp for the backward. Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int dtype, int B,
                                   int S, int H, int KV, int D, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  return int(dispatch(q, k, v, o, lse, dtype, B, S, H, KV, D, causal, window,
                      softcap, static_cast<cudaStream_t>(stream)));
}

// The backward: q, k, v, o and dout (the gradient of o) as the forward's
// tensors, lse the forward's (B, H, S) f32 output, delta a (B, H, S) f32
// scratch buffer; writes dq (B, S, H, D), dk and dv (B, S, KV, D) in the
// inputs' dtype. Head dims 64, 128 and 256. Returns the first cudaError_t
// of its three launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B,
                                   int S, int H, int KV, int D, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return int(launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, B, S, H, KV, causal, window, softcap, st));
    case 128: return int(launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, B, S, H, KV, causal, window, softcap, st));
    case 256: return int(launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, B, S, H, KV, causal, window, softcap, st));
    default: return int(cudaErrorInvalidValue);
  }
}
