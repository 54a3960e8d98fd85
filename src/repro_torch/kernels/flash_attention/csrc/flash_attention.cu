// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface for ctypes. The forward optionally writes each row's
// log-sum-exp, which the backward (namespaces bwd and bwd_wg, below)
// reads.
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
// elements apart, into 128-byte-swizzled column blocks of 64, by THREADS
// threads; rows at or past S and columns at or past D are zero-filled.
template <int ROWS, int D, int THREADS = NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int s0, int S,
                                          int tid) {
  constexpr int CH = padded<D>() / 8;   // 16-byte chunks a row
  static_assert(ROWS * CH % THREADS == 0, "every thread copies as many");
#pragma unroll
  for (int j = 0; j < ROWS * CH / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i / CH, c = i % CH, s = s0 + r;
    const bool ok = s < S && c * 8 < D;
    cp_async16(dst + (c / 8) * ROWS * 64 + sw128(r, c % 8),
               src + (ok ? long(s) * stride + c * 8 : 0), ok);
  }
}

// Q.K^T for one k16 step: the score tile is BK wide
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t desc_q,
                                         uint64_t desc_k, int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64<0, 0>(d, desc_q, desc_k, scale_d);
  else wgmma_ss_n32<0, 0>(d, desc_q, desc_k, scale_d);
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
// Backward, f32 (the parity runs, where TF32 products would change the
// results): f32 FMAs on the CUDA cores, three grids; bf16 runs one pass on
// the tensor cores (namespace bwd_wg, below), and shares only delta_kernel.
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
// they run as f32 FMAs on the CUDA cores, far above the tensor-core bound.
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
// ROWS x D rows s0.. of a tensor whose rows are `stride` elements apart
// into dst with a row pitch of D + 1; rows past S are 0
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long stride, int s0, int S,
                                          int tid) {
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D, s = s0 + r;
    dst[r * (D + 1) + c] = s < S ? src[long(s) * stride + c] : 0.f;
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
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int H,
            int KV, float scale, int causal, int window, float softcap) {
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
  load_rows<BT, D>(sK, k + (long(b) * S * KV + kvh) * D, kv_stride, k0, S,
                   tid);
  load_rows<BT, D>(sV, v + (long(b) * S * KV + kvh) * D, kv_stride, k0, S,
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
      load_rows<BT, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S,
                       tid);
      load_rows<BT, D>(sO, dout + (long(b) * S * H + h) * D, q_stride, q0,
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
  float* dkb = dk + (long(b) * S * KV + kvh) * D;
  float* dvb = dv + (long(b) * S * KV + kvh) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = k0 + ty + TPR * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + TPR * j;
      dkb[long(s) * kv_stride + c] = acc_k[i][j] * scale;
      dvb[long(s) * kv_stride + c] = acc_v[i][j];
    }
  }
}

// One block per (q tile, b * H + h): dQ of its rows over every key tile
// they see.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int KV, float scale,
          int causal, int window, float softcap) {
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
  const float* kb = k + (long(b) * S * KV + kvh) * D;
  const float* vb = v + (long(b) * S * KV + kvh) * D;
  load_rows<BT, D>(sQ, q + (long(b) * S * H + h) * D, q_stride, q0, S, tid);
  load_rows<BT, D>(sO, dout + (long(b) * S * H + h) * D, q_stride, q0, S,
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
    load_rows<BT, D>(sK, kb, kv_stride, k0, S, tid);
    load_rows<BT, D>(sV, vb, kv_stride, k0, S, tid);
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
  float* dqb = dq + (long(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = q0 + ty + TPR * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[long(s) * q_stride + tx + TPR * j] = acc[i][j] * scale;
  }
}

template <int D, bool SOFTCAP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  constexpr int BT = tile<D>();
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
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const int rows = B * S * H;
  delta_kernel<float><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(o), tdo, delta, rows, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_t = (S + BT - 1) / BT;
  k_dkdv<<<dim3(n_t, B * KV), NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, KV, scale, causal, window, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_dq<<<dim3(n_t, B * H), NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), S, H, KV, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward, bf16 (head dims 64, 128 and, in bwd_d256_kernel below, 256):
// FlashAttention-3's schedule on the warpgroup tensor cores, with
// namespace bwd's D = rowsum(dO * O) kernel and arithmetic (the masks,
// the softcap's derivative, the scale applied once to dQ and dK), the
// probabilities exp(x - lse) taken as 2^((x - lse) log2 e) on the
// special-function unit (ex2.approx, as the forward's: about 5% faster than
// expf at yi-9b's shape on an H100; P is rounded to bf16 after).
//
// What bounds it: the five products the gradient needs on the unmasked
// (q, k) pairs, S = Q.K^T, dP = dO.V^T, dV, dK and dQ: at train_yi9b's
// (4, 2048, 32, 4, 128) ~344 GFLOP against ~170 MB, operations (0.348 ms
// at the bf16 peak). The earlier kernel ran them on mma.sync from one
// shared-memory stage (every walked tile's copy waited) in two passes, a
// dK/dV grid and a dQ grid, each computing S and dP: seven products' work
// for five. Here:
//   * one pass: a block owns a tile of keys of one (b, kv head), one
//     warpgroup for each 64 columns of the head dim (64 keys at head dim
//     64, 128 keys on two warpgroups at 128), and walks the q tiles of 64
//     that the causal mask and the window leave it, for every q head of
//     the GQA group. Per q tile each warpgroup runs, for its 64 keys, four
//     products on wgmma: S^T = K.Q^T and dP^T = V.dO^T (both operands in
//     shared memory, K-major), then, with P^T and dS^T built in registers
//     from the rows' lse and D, dV += P^T.dO and dK += dS^T.Q with P^T and
//     dS^T as register A operands (as the forward's P.V). dK and dV sum
//     over the group in registers, with no atomics;
//   * dQ: dS^T also goes to shared memory (bf16, as the A operand the
//     forward rounds P to), and each warpgroup computes 64 columns of
//     dQ_tile = dS.K over all the block's keys (dS^T read MN-major, the
//     instruction's transpose) and adds them into an f32 (B, S, H, D)
//     buffer with 16-byte vector reds (red.global.add.v4.f32); a small
//     kernel scales it and casts to bf16. The scores are computed once. The
//     atomics make dQ's summation order vary from run to run;
//   * what the adds cost: at yi-9b's shape, 64 keys a block, they are
//     ~2.2 GB of f32 sums into a 134 MB buffer, and with one red a float
//     they took two thirds of the kernel's time on an H100. 16-byte reds,
//     128 keys a block (half the sums) and the walk order below (the sums
//     stay in the L2) cut that;
//   * the walked Q, dO, lse and D tiles come through a ring of two
//     shared-memory stages, copied with cp.async by every thread, so the
//     next tile's copy overlaps this tile's products (146 KB of shared
//     memory a block at head dim 128, 57 KB at 64). Q and dO by TMA
//     instead (one thread issuing the 128-byte-swizzled boxes, an mbarrier
//     a stage) measured 1% faster at train_yi9b's shape and no faster at
//     train_granite's on an H100 (tools/bwd_ab.py): the ring already hides
//     the loads, so the copies stay cp.async, which needs no tensor maps.
// The longest causal walks (the first key tiles) are launched first, and
// every block walks its q tiles from the last down, the group's heads
// innermost, so the blocks running together add into the same few dQ
// tiles at about the same time and the f32 sums stay in the L2. (Walking
// each head's q tiles upwards from the diagonal, the sums went back and
// forth to device memory.)
namespace bwd_wg {

using namespace mma_bf16;
using bf16wg::load_tile;

constexpr int BQ = 64;          // queries a walked tile

// one warpgroup for each 64 columns of the head dim: it owns 64 keys in
// S^T, dP^T, dK and dV, and those 64 columns of dQ
template <int D>
__host__ __device__ constexpr int warpgroups() { return D / 64; }
template <int D>
__host__ __device__ constexpr int threads() { return 128 * warpgroups<D>(); }
template <int D>
__host__ __device__ constexpr int key_tile() { return 64 * warpgroups<D>(); }

template <int D>
constexpr size_t smem_bytes() {
  // K and V (key_tile x D), two stages of Q and dO (BQ x D), dS^T
  // (key_tile x BQ), two stages of the rows' lse and D (f32); 1024 bytes of
  // slack to align the swizzle blocks
  return sizeof(bf16) * (size_t(2 * key_tile<D>() + 4 * BQ) * D +
                         key_tile<D>() * BQ) +
         4 * BQ * sizeof(float) + 1024;
}

// dV += P^T.dO or dK += dS^T.Q for one k16 step (16 queries): A from
// registers, B (the dO or Q tile, BQ x D) MN-major, its rows the queries
template <int D>
__device__ __forceinline__ void wgmma_rows(float (&d)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

// dQ's sums of one warp's 16 query rows (row0 .. row0 + 15, the rows of
// a wgmma accumulator fragment `dq` of N floats a thread: N / 4 n8 blocks
// of columns) added into the f32 buffer whose row s starts at base + s *
// stride, rows past S skipped. 16-byte vector reds (sm_90): lanes t and
// t ^ 1 trade halves, so the even lane adds columns 4 (t / 2) .. + 3 of an
// n8 block in row row0 + g and the odd lane the same columns of row row0 +
// g + 8.
template <int N>
__device__ __forceinline__ void add_dq(const float (&dq)[N], float* base,
                                       int row0, int S, long stride, int g,
                                       int t) {
  const bool odd = t & 1;
  const int qpos = row0 + g + (odd ? 8 : 0);
  float* row = base + long(qpos) * stride + 4 * (t / 2);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float c0 = dq[4 * j], c1 = dq[4 * j + 1];
    const float c2 = dq[4 * j + 2], c3 = dq[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c0 : c2, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c1 : c3, 1);
    if (qpos < S)
      atomicAdd(reinterpret_cast<float4*>(row + 8 * j),
                odd ? make_float4(r0, r1, c2, c3)
                    : make_float4(c0, c1, r0, r1));
  }
}

// One block per (b * KV + kv head, key tile); warpgroup w owns keys
// kw0 = k0 + 64 w .. kw0 + 63, its warp u keys kw0 + 16 u .. kw0 + 16 u +
// 15 (lane (g, t) keys g and g + 8 of those) in S^T, dP^T, dK and dV, and
// queries q0 + 16 u .. in dQ's columns 64 w .. 64 w + 63.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(threads<D>())
bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq_acc, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int S, int H, int KV, float scale,
           int causal, int window, float softcap) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  constexpr int NT = threads<D>(), BKV = key_tile<D>();
  constexpr int KTILE = BKV * D, QTILE = BQ * D;
  extern __shared__ unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sV = sK + KTILE;          // [D / 64][BKV][64], as K
  bf16* sQ = sV + KTILE;          // [2][D / 64][BQ][64]
  bf16* sO = sQ + 2 * QTILE;      // dO, as Q
  bf16* sDS = sO + 2 * QTILE;     // dS^T, [BKV][BQ]
  float* sL = reinterpret_cast<float*>(sDS + BKV * BQ);   // [2][BQ]
  float* sDl = sL + 2 * BQ;                               // [2][BQ]

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * BKV, kw0 = k0 + 64 * wg;
  const long q_stride = long(H) * D, kv_stride = long(KV) * D;
  load_tile<BKV, D, NT>(sK, k + (long(b) * S * KV + kvh) * D, kv_stride, k0,
                        S, tid);
  load_tile<BKV, D, NT>(sV, v + (long(b) * S * KV + kvh) * D, kv_stride, k0,
                        S, tid);

  // the q tiles whose rows can see a key of this tile, for each q head,
  // walked from the last q tile down with the group's heads innermost:
  // walk step `it` is q tile qt_last - it / G, and the heads are taken in
  // an order rotated by the key tile. So the blocks of one (b, kv head),
  // which start together, add into the same few dQ tiles at about the same
  // time, spread over the group's heads: the f32 sums being added stay in
  // the L2 (yi-9b's (4, 2048, 32, 128) buffer is 134 MB), and few blocks
  // add into one tile at once.
  const int k_last = min(k0 + BKV, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;  // exclusive
  const int qt_last = (q_end - 1) / BQ;
  const int n_it = G * (qt_last - q_begin / BQ + 1);
  // Q, dO, lse and D of walk step `it` into stage st
  auto load_q = [&](int it, int st) {
    const int h = kvh * G + (it + blockIdx.y) % G;
    const int q0 = (qt_last - it / G) * BQ;
    const long row0 = long(b) * S * H + h;
    load_tile<BQ, D, NT>(sQ + st * QTILE, q + row0 * D, q_stride, q0, S,
                         tid);
    load_tile<BQ, D, NT>(sO + st * QTILE, dout + row0 * D, q_stride, q0, S,
                         tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ, qpos = q0 + r;
      const bool ok = qpos < S;
      const long i = ok ? (long(b) * H + h) * S + qpos : 0;
      if (tid < BQ) cp_async4(sL + st * BQ + r, lse + i, ok);
      else cp_async4(sDl + st * BQ + r, delta + i, ok);
    }
  };
  load_q(0, 0);
  cp_async_commit();

  float acc_k[D / 2], acc_v[D / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  const int krow = kw0 + warp * 16 + g;
  const bf16* wK = sK + 64 * wg * 64;   // this warpgroup's keys in block 0
  const bf16* wV = sV + 64 * wg * 64;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int h = kvh * G + (it + blockIdx.y) % G;
    const int q0 = (qt_last - it / G) * BQ;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // tile it has landed; every thread is done with it - 1
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* cQ = sQ + st * QTILE;
    const bf16* cO = sO + st * QTILE;
    const float* cL = sL + st * BQ;
    const float* cDl = sDl + st * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T (this warpgroup's keys x queries): both
    // operands K-major in shared memory, a k16 step 32 bytes into a
    // swizzle row
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          s, gmma_desc(wK + (kk / 4) * BKV * 64 + (kk % 4) * 16, 16, 1024),
          gmma_desc(cQ + (kk / 4) * BQ * 64 + (kk % 4) * 16, 16, 1024),
          kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          dp, gmma_desc(wV + (kk / 4) * BKV * 64 + (kk % 4) * 16, 16, 1024),
          gmma_desc(cO + (kk / 4) * BQ * 64 + (kk % 4) * 16, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T (without the scale) of this thread's pairs: keys krow
    // and krow + 8, queries q0 + 8 nb + 2 t (+ 1); packed to bf16 as the A
    // operands of dV and dK, and dS^T stored for dQ. A tile wholly inside
    // every row's range skips the mask.
    const bool inside = q0 + BQ <= S && kw0 + 64 <= S &&
                        (!causal || q0 >= kw0 + 63) &&
                        (window <= 0 || q0 + BQ - 1 - kw0 < window);
    uint32_t p[BQ / 16][4], ds[BQ / 16][4];
#pragma unroll
    for (int nb = 0; nb < BQ / 8; ++nb) {
      float pr[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nb * 8 + 2 * t + (i & 1);
        const int qpos = q0 + c, kpos = krow + (i >> 1) * 8;
        bool ok = true;
        if (!inside) {
          ok = qpos < S && kpos < S;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
        }
        float x = s[4 * nb + i] * scale, th = 0.f;
        if constexpr (SOFTCAP) {
          th = tanhf(x / softcap);
          x = th * softcap;
        }
        pr[i] = ok ? exp2_ftz((x - cL[c]) * bf16wg::LOG2E) : 0.f;
        dd[i] = pr[i] * (dp[4 * nb + i] - cDl[c]);
        if constexpr (SOFTCAP) dd[i] *= 1.f - th * th;
      }
      // two n8 blocks of queries make one k16 step of dV and dK
      p[nb / 2][(nb % 2) * 2] = pack_bf16(pr[0], pr[1]);
      p[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(pr[2], pr[3]);
      ds[nb / 2][(nb % 2) * 2] = pack_bf16(dd[0], dd[1]);
      ds[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(dd[2], dd[3]);
      // dS^T: [key][query], 128-byte swizzled (conflict-free: the 8 rows
      // of a store sit on 8 different 16-byte chunks)
      const int r = krow - k0;
      *reinterpret_cast<uint32_t*>(sDS + sw128(r, nb) + 2 * t) =
          ds[nb / 2][(nb % 2) * 2];
      *reinterpret_cast<uint32_t*>(sDS + sw128(r + 8, nb) + 2 * t) =
          ds[nb / 2][(nb % 2) * 2 + 1];
    }
    fence_proxy_async();   // the dS^T stores, for wgmma's reads

    // dV += P^T.dO, dK += dS^T.Q: B the dO and Q tiles MN-major (their
    // rows run along the reduced queries), a k16 step 16 rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rows<D>(acc_v, p[kk],
                    gmma_desc(cO + kk * 16 * 64, BQ * 64 * sizeof(bf16),
                              1024));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rows<D>(acc_k, ds[kk],
                    gmma_desc(cQ + kk * 16 * 64, BQ * 64 * sizeof(bf16),
                              1024));
    wgmma_commit();
    __syncthreads();   // every warp's dS^T is in shared memory

    // dQ's columns 64 wg .. 64 wg + 63 (queries x 64) += dS.K over all the
    // block's keys: A = dS^T MN-major (its rows are the reduced keys), B =
    // the K tile's column block wg, MN-major; the sum added into the f32
    // buffer
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_ss_n64<1, 1>(
          dq, gmma_desc(sDS + kk * 16 * 64, BKV * 64 * sizeof(bf16), 1024),
          gmma_desc(sK + wg * BKV * 64 + kk * 16 * 64,
                    BKV * 64 * sizeof(bf16), 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();   // and dV, dK above
    fence_regs(dq);
    fence_regs(p);     // P^T's and dS^T's registers were read until here
    fence_regs(ds);
    add_dq(dq, dq_acc + (long(b) * S * H + h) * D + wg * 64, q0 + warp * 16,
           S, long(H) * D, g, t);
  }
  fence_regs(acc_k);
  fence_regs(acc_v);

  // dK (times the scale) and dV of this warpgroup's keys; rows past S
  // skipped
  bf16* dkb = dk + (long(b) * S * KV + kvh) * D;
  bf16* dvb = dv + (long(b) * S * KV + kvh) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = krow + 8 * r;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long off = long(kpos) * kv_stride + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          pack_bf16(acc_k[4 * j + 2 * r] * scale,
                    acc_k[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + off) =
          pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

// Head dim 256. bwd_kernel's shape does not stretch to it: a warpgroup's
// 64 keys x the whole head dim of dK and dV are 256 f32 registers a
// thread, and K and V for its 256 keys 256 KB of shared memory (a block
// has 227 KB). So here one block of two warpgroups owns 64 keys of one
// (b, kv head), and the warpgroups split the head dim: warpgroup w owns
// columns 128 w .. 128 w + 127 of dK, dV and dQ (128 f32 registers a
// thread for dK and dV). Per walked q tile of 64:
//   * S^T = K.Q^T (warpgroup 0) and dP^T = V.dO^T (warpgroup 1), each a
//     64 x 64 product reduced over all 256 columns (both operands K-major
//     in shared memory). The two accumulators have one layout, so thread i
//     of one warpgroup holds the (key, query) pairs that thread i of the
//     other holds: each hands the other the half of its fragment on the
//     other's 32 queries (f32, through shared memory), and each warpgroup
//     then forms P^T and dS^T for its own 32 queries (the same arithmetic
//     as bwd_kernel) and stores them to shared memory in bf16;
//   * dV[:, half] += P^T.dO[:, half] and dK[:, half] += dS^T.Q[:, half]
//     (A from shared memory, B MN-major, N = 128 across two swizzle
//     blocks), and dQ_tile[:, half] = dS.K[:, half] (dS^T read MN-major),
//     in two products of 64 columns, each added into the f32 buffer by
//     16-byte reds as it completes (one product of 128 columns needs 64
//     more registers a thread and spilled).
// dK and dV sum over the GQA group in registers; the walk, the order of
// the blocks and the ring of two Q/dO stages are bwd_kernel's. Shared
// memory: K and V 64 KB, two stages of Q and dO 128 KB, P^T and dS^T 16 KB,
// the exchanged halves 16 KB, lse and D 1 KB: 226 KB with the alignment.
// On an H100 the exchange measured faster than computing S^T and dP^T in
// both warpgroups (seven products' work for five, no exchange), and the
// dQ reds are the largest cost after the products: the adds (the group's
// q heads x 64 queries x 256 columns a block and q tile, ~0.55 GB at
// gemma3-12b's (1, 2048, 16, 8, 256)) sum in the L2 and overlap little
// with the products.
namespace wide {

constexpr int D = 256, NT = 256, BKV = 64;
constexpr int KTILE = BKV * D, QTILE = BQ * D;
constexpr int HALF = BQ / 4;    // accumulator floats of 32 queries a thread

constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t(2 * BKV + 4 * BQ) * D + 2 * BKV * BQ) +
         sizeof(float) * (2 * HALF * 128 + 4 * BQ) + 1024;
}
static_assert(smem_bytes() <= 232448, "a block's shared memory on sm_90");

}  // namespace wide

// One block per (b * KV + kv head, key tile of 64); warp u of warpgroup w
// holds keys k0 + 16 u + g and + 8 (lane (g, t)) in S^T / dP^T, dK and dV
// (columns 128 w ..), and queries q0 + 16 u + g and + 8 in dQ.
template <bool SOFTCAP>
__global__ void __launch_bounds__(wide::NT, 1)
bwd_d256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq_acc, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int H, int KV, float scale,
                int causal, int window, float softcap) {
  using namespace wide;
  extern __shared__ unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sV = sK + KTILE;          // [4][BKV][64], as K
  bf16* sQ = sV + KTILE;          // [2][4][BQ][64]
  bf16* sO = sQ + 2 * QTILE;      // dO, as Q
  bf16* sP = sO + 2 * QTILE;      // P^T, [BKV][BQ]
  bf16* sDS = sP + BKV * BQ;      // dS^T, [BKV][BQ]
  float* sX = reinterpret_cast<float*>(sDS + BKV * BQ);   // [2][HALF][128]
  float* sL = sX + 2 * HALF * 128;                        // [2][BQ]
  float* sDl = sL + 2 * BQ;                               // [2][BQ]

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * BKV;
  const long q_stride = long(H) * D, kv_stride = long(KV) * D;
  load_tile<BKV, D, NT>(sK, k + (long(b) * S * KV + kvh) * D, kv_stride, k0,
                        S, tid);
  load_tile<BKV, D, NT>(sV, v + (long(b) * S * KV + kvh) * D, kv_stride, k0,
                        S, tid);

  // the walk of bwd_kernel
  const int k_last = min(k0 + BKV, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;  // exclusive
  const int qt_last = (q_end - 1) / BQ;
  const int n_it = G * (qt_last - q_begin / BQ + 1);
  auto load_q = [&](int it, int st) {
    const int h = kvh * G + (it + blockIdx.y) % G;
    const int q0 = (qt_last - it / G) * BQ;
    const long row0 = long(b) * S * H + h;
    load_tile<BQ, D, NT>(sQ + st * QTILE, q + row0 * D, q_stride, q0, S,
                         tid);
    load_tile<BQ, D, NT>(sO + st * QTILE, dout + row0 * D, q_stride, q0, S,
                         tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ, qpos = q0 + r;
      const bool ok = qpos < S;
      const long i = ok ? (long(b) * H + h) * S + qpos : 0;
      if (tid < BQ) cp_async4(sL + st * BQ + r, lse + i, ok);
      else cp_async4(sDl + st * BQ + r, delta + i, ok);
    }
  };
  load_q(0, 0);
  cp_async_commit();

  float acc_k[64], acc_v[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
  const int krow = warp * 16 + g;            // and krow + 8, in the tile
  const bf16* sA = wg == 0 ? sK : sV;        // S^T's or dP^T's A operand
  float* x_out = sX + wg * HALF * 128 + wt;  // the half handed over
  const float* x_in = sX + (1 - wg) * HALF * 128 + wt;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int h = kvh * G + (it + blockIdx.y) % G;
    const int q0 = (qt_last - it / G) * BQ;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // tile it has landed; every thread is done with it - 1
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* cQ = sQ + st * QTILE;
    const bf16* cO = sO + st * QTILE;
    const float* cL = sL + st * BQ;
    const float* cDl = sDl + st * BQ;

    // S^T = K.Q^T (warpgroup 0) or dP^T = V.dO^T (warpgroup 1); x is
    // zeroed here so that its registers are free between its last read
    // and the next tile (dQ's fragment takes them)
    const bf16* cB = wg == 0 ? cQ : cO;
    float x[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) x[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          x, gmma_desc(sA + (kk / 4) * BKV * 64 + (kk % 4) * 16, 16, 1024),
          gmma_desc(cB + (kk / 4) * BQ * 64 + (kk % 4) * 16, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // warpgroup 0 keeps queries 0 .. 31 (n8 blocks 0-3, x[0 .. 15]) and
    // hands over 32 .. 63; warpgroup 1 the other way round
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      x_out[j * 128] = wg == 0 ? x[HALF + j] : x[j];
    __syncthreads();

    // P^T and dS^T (without the scale) of this warpgroup's queries: keys
    // krow and krow + 8, queries q0 + 8 nb + 2 t (+ 1), into shared memory
    // (bf16, 128-byte swizzled [key][query]: the 8 rows of a store sit on
    // 8 different 16-byte chunks)
    const bool inside = q0 + BQ <= S && k0 + BKV <= S &&
                        (!causal || q0 >= k0 + BKV - 1) &&
                        (window <= 0 || q0 + BQ - 1 - k0 < window);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int nb = 4 * wg + n;
      float pr[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * n + i;
        const float kept = wg == 0 ? x[j] : x[HALF + j];
        const float got = x_in[j * 128];
        const float sc = wg == 0 ? kept : got, dpv = wg == 0 ? got : kept;
        const int c = nb * 8 + 2 * t + (i & 1);
        const int qpos = q0 + c, kpos = k0 + krow + (i >> 1) * 8;
        bool ok = true;
        if (!inside) {
          ok = qpos < S && kpos < S;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
        }
        float xs = sc * scale, th = 0.f;
        if constexpr (SOFTCAP) {
          th = tanhf(xs / softcap);
          xs = th * softcap;
        }
        pr[i] = ok ? exp2_ftz((xs - cL[c]) * bf16wg::LOG2E) : 0.f;
        dd[i] = pr[i] * (dpv - cDl[c]);
        if constexpr (SOFTCAP) dd[i] *= 1.f - th * th;
      }
      *reinterpret_cast<uint32_t*>(sP + sw128(krow, nb) + 2 * t) =
          pack_bf16(pr[0], pr[1]);
      *reinterpret_cast<uint32_t*>(sP + sw128(krow + 8, nb) + 2 * t) =
          pack_bf16(pr[2], pr[3]);
      *reinterpret_cast<uint32_t*>(sDS + sw128(krow, nb) + 2 * t) =
          pack_bf16(dd[0], dd[1]);
      *reinterpret_cast<uint32_t*>(sDS + sw128(krow + 8, nb) + 2 * t) =
          pack_bf16(dd[2], dd[3]);
    }
    fence_proxy_async();   // the P^T and dS^T stores, for wgmma's reads
    __syncthreads();

    // dV[:, half] += P^T.dO[:, half], dK[:, half] += dS^T.Q[:, half]: A
    // (keys x queries) K-major, B the dO or Q tile's column blocks 2 wg and
    // 2 wg + 1, MN-major (its rows run along the reduced queries)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_ss_n128<0, 1>(acc_v, gmma_desc(sP + kk * 16, 16, 1024),
                          gmma_desc(cO + 2 * wg * BQ * 64 + kk * 16 * 64,
                                    BQ * 64 * sizeof(bf16), 1024),
                          1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_ss_n128<0, 1>(acc_k, gmma_desc(sDS + kk * 16, 16, 1024),
                          gmma_desc(cQ + 2 * wg * BQ * 64 + kk * 16 * 64,
                                    BQ * 64 * sizeof(bf16), 1024),
                          1);
    wgmma_commit();

    // dQ's columns 128 wg + 64 part .. + 63 (queries x 64) = dS.K: A =
    // dS^T MN-major (its rows are the reduced keys), B = K's column block
    // 2 wg + part, MN-major
    float* dq_rows = dq_acc + (long(b) * S * H + h) * D;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int col0 = 128 * wg + 64 * part;
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_ss_n64<1, 1>(
            dq, gmma_desc(sDS + kk * 16 * 64, BKV * 64 * sizeof(bf16), 1024),
            gmma_desc(sK + (col0 / 64) * BKV * 64 + kk * 16 * 64,
                      BKV * 64 * sizeof(bf16), 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();   // and dV, dK above
      fence_regs(dq);
      add_dq(dq, dq_rows + col0, q0 + warp * 16, S, q_stride, g, t);
    }
  }
  fence_regs(acc_k);
  fence_regs(acc_v);

  // dK (times the scale) and dV of this warpgroup's columns; rows past S
  // skipped
  bf16* dkb = dk + (long(b) * S * KV + kvh) * D + 128 * wg;
  bf16* dvb = dv + (long(b) * S * KV + kvh) * D + 128 * wg;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + krow + 8 * r;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long off = long(kpos) * kv_stride + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          pack_bf16(acc_k[4 * j + 2 * r] * scale,
                    acc_k[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + off) =
          pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

// dq = scale * the f32 sums, to bf16: eight elements a thread
__global__ void __launch_bounds__(256)
dq_cast_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
               long n8, float scale) {
  const long i = long(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  uint4 out;
  out.x = pack_bf16(a.x * scale, a.y * scale);
  out.y = pack_bf16(a.z * scale, a.w * scale);
  out.z = pack_bf16(c.x * scale, c.y * scale);
  out.w = pack_bf16(c.z * scale, c.w * scale);
  reinterpret_cast<uint4*>(dq)[i] = out;
}

// D = rowsum(dO * O), the main kernel, the cast: dq_acc is the zeroed f32
// (B, S, H, D) buffer the wrapper allocates
template <int D, bool SOFTCAP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, float* dq_acc, void* dq, void* dk, void* dv,
                   int B, int S, int H, int KV, int causal, int window,
                   float softcap, cudaStream_t stream) {
  if (dq_acc == nullptr) return cudaErrorInvalidValue;
  constexpr bool WIDE = D == 256;
  constexpr size_t smem = WIDE ? wide::smem_bytes() : smem_bytes<D>();
  constexpr int nt = WIDE ? wide::NT : threads<D>();
  constexpr int bkv = WIDE ? wide::BKV : key_tile<D>();
  auto kernel = [] {
    if constexpr (D == 256) return bwd_d256_kernel<SOFTCAP>;
    else return bwd_kernel<D, SOFTCAP>;
  }();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int n_kv = (S + bkv - 1) / bkv;
  if (n_kv > 65535) return cudaErrorInvalidValue;
  const float scale = float(1.0 / sqrt(double(D)));
  const bf16* tdo = static_cast<const bf16*>(dout);
  const int rows = B * S * H;
  bwd::delta_kernel<bf16><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(o), tdo, delta, rows, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kernel<<<dim3(B * KV, n_kv), nt, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tdo, lse, delta, dq_acc,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KV, scale,
      causal, window, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n8 = long(rows) * D / 8;
  dq_cast_kernel<<<unsigned((n8 + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<bf16*>(dq), n8, scale);
  return cudaGetLastError();
}

}  // namespace bwd_wg

// Whether the backward of (dtype, D) runs on the tensor cores (bwd_wg: bf16
// at every head dim the backward takes) and so sums dQ into the caller's
// f32 buffer dq_acc; f32 runs on the CUDA cores (bwd), dq_acc unused. The
// wrapper asks flash_attention_bwd_sums_dq, below, so the rule lives here
__host__ __device__ constexpr bool on_bwd_wg(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 128 || D == 256);
}

// The backward for one head dim: bf16 on bwd_wg, f32 on bwd
template <int D, bool SOFTCAP>
cudaError_t launch_bwd_cap(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, float* dq_acc, void* dq, void* dk,
                           void* dv, int dtype, int B, int S, int H, int KV,
                           int causal, int window, float softcap,
                           cudaStream_t st) {
  if (dtype == 0)
    return bwd::launch<D, SOFTCAP>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, S, H, KV, causal, window, softcap, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  static_assert(on_bwd_wg(1, D), "bf16 runs on the tensor cores");
  return bwd_wg::launch<D, SOFTCAP>(q, k, v, o, dout, lse, delta, dq_acc, dq,
                                    dk, dv, B, S, H, KV, causal, window,
                                    softcap, st);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, float* dq_acc, void* dq, void* dk,
                       void* dv, int dtype, int B, int S, int H, int KV,
                       int causal, int window, float softcap,
                       cudaStream_t st) {
  return softcap > 0.f
             ? launch_bwd_cap<D, true>(q, k, v, o, dout, lse, delta, dq_acc,
                                       dq, dk, dv, dtype, B, S, H, KV,
                                       causal, window, softcap, st)
             : launch_bwd_cap<D, false>(q, k, v, o, dout, lse, delta, dq_acc,
                                        dq, dk, dv, dtype, B, S, H, KV,
                                        causal, window, softcap, st);
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

// 1 where the backward of dtype (0 f32, 1 bf16) at head dim D sums dQ into
// a zeroed f32 buffer (its dq_acc argument), else 0
extern "C" int flash_attention_bwd_sums_dq(int dtype, int D) {
  return int(on_bwd_wg(dtype, D));
}

// The backward: q, k, v, o and dout (the gradient of o) as the forward's
// tensors, lse the forward's (B, H, S) f32 output, delta a (B, H, S) f32
// scratch buffer, dq_acc (where flash_attention_bwd_sums_dq says so, else
// unused and may be null) a zeroed (B, S, H, D) f32 buffer that dQ is
// summed into;
// writes dq (B, S, H, D), dk and dv (B, S, KV, D) in the inputs' dtype.
// Head dims 64, 128 and 256. Returns the first cudaError_t of its three
// launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta,
                                   float* dq_acc, void* dq, void* dk,
                                   void* dv, int dtype, int B, int S, int H,
                                   int KV, int D, int causal, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return int(launch_bwd<64>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, dtype, B, S, H, KV, causal, window, softcap, st));
    case 128: return int(launch_bwd<128>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, dtype, B, S, H, KV, causal, window, softcap, st));
    case 256: return int(launch_bwd<256>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, dtype, B, S, H, KV, causal, window, softcap, st));
    default: return int(cudaErrorInvalidValue);
  }
}
